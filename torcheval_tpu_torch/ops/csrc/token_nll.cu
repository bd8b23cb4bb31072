// Token negative log-likelihood from next-token logits: one pass a row.
//
// Replaces no TPU kernel.  The JAX package computes Perplexity's update
// (torcheval_tpu/metrics/functional/text/perplexity.py) in plain XLA, which
// fuses the cast, the gather and the logsumexp over the vocabulary into one
// read of the logits.  PyTorch does not: the port's plain version
// (ops/token_nll.py::_token_nll_plain) casts the logits to float32, gathers,
// then runs logsumexp as amax, x - max, exp and sum: about 15x the bytes of
// the logits, and two float32 copies of them in transients.  At a language
// model's vocabulary that is the heaviest update an evaluation library is
// handed: DeepSeek-V3's 129 280 logits a token, 2 x 4096 tokens a micro-batch,
// are 2.12 GB of bf16.  This kernel reads each row once and writes one float32
// a token.
//
// For each token r with row x = logits[r, :] (V values) and target t:
//
//     nll[r] = logsumexp(x) - x[clamp(t, 0, V - 1)],   NaN where t >= V
//
// in float32, with logsumexp's propagation of non-finite logits: NaN in a row
// gives NaN, else +inf gives +inf, else a row of -inf gives -inf.  A negative
// id gathers x[0] (the caller masks ignored tokens), as the plain version and
// the JAX gather do.
//
// Bound on the H100: bytes.  The logits are read once, the int32 / int64
// targets once and one float32 a token is written; a (2, 4096, 129 280) bf16
// update is 2.12 GB, 0.63 ms at 3.35 TB/s.  The arithmetic, an exp2 and four
// float32 operations an element, takes under half of that on 132 SMs.
//
// Design.  A block of 256 threads a row.  Each thread reads its share of the
// row in 16-byte loads (8 bf16 / f16, or 4 f32), four in flight, and folds
// every 32 (or 16) values into an online maximum m and a sum s of exp(x - m),
// rescaling s once a group when the maximum rises; exponentials are exp2 of
// x log2(e) - m log2(e), one FMA and one MUFU op an element.  A row whose
// start is not 16-byte aligned (an odd V such as 50 257) reads a scalar head
// up to the first aligned address and a scalar tail past the last whole
// vector.  The target's logit is one scalar load of thread 0, made before
// the row's loads.  Threads combine their (m, s) pairs by warp shuffles, then
// the block's warps through shared memory; thread 0 writes the row's NLL.
// Non-finite values take a slow branch only in a group whose maximum is not
// finite; elsewhere a NaN reaches s through exp2 and propagates.
//
// Deterministic: a fixed schedule a row for a given alignment of the row, no
// atomics.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte loads in flight a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kSawNaN = 1u;
constexpr unsigned kSawPosInf = 2u;

// Each element type: how many a 16-byte word holds, the word's values as
// float32, and one value as float32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPer = 4;
  __device__ static void unpack(const uint4& w, float* x) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  }
  __device__ static float one(const float* p) { return *p; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void unpack(const uint4& w, float* x) {
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(words[i] << 16);
      x[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
  __device__ static float one(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};

template <>
struct Elem<__half> {
  static constexpr int kPer = 8;
  __device__ static void unpack(const uint4& w, float* x) {
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = *reinterpret_cast<const __half2*>(&words[i]);
      const float2 f = __half22float2(h);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static float one(const __half* p) { return __half2float(*p); }
};

// The running logsumexp of one thread's values: the largest finite value m
// (-inf before any), s = sum of exp(x - m) over the values folded, and the
// flags of non-finite values met in a group whose maximum was not finite.
struct Acc {
  float m;
  float s;
  unsigned flags;
};

// Fold K values into a: their maximum and sum in L independent chains (a
// chain of K dependent adds would bound a warp by the FADD latency).
template <int K>
__device__ __forceinline__ void fold(Acc& a, const float* x) {
  constexpr int L = K < 4 ? K : 4;
  float cm[L];
#pragma unroll
  for (int j = 0; j < L; ++j) cm[j] = x[j];
#pragma unroll
  for (int i = L; i < K; ++i) cm[i % L] = fmaxf(cm[i % L], x[i]);  // fmaxf skips NaN
  float mn = a.m;
#pragma unroll
  for (int j = 0; j < L; ++j) mn = fmaxf(mn, cm[j]);
  if (fabsf(mn) < CUDART_INF_F) {
    const float ml = mn * kLog2e;
    float acc[L];
#pragma unroll
    for (int j = 0; j < L; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) acc[i % L] += exp2f(fmaf(x[i], kLog2e, -ml));  // NaN stays NaN
    float sum = acc[0];
#pragma unroll
    for (int j = 1; j < L; ++j) sum += acc[j];
    a.s = fmaf(a.s, exp2f((a.m - mn) * kLog2e), sum);  // a.m = -inf: 0
    a.m = mn;
  } else {
    // +inf in the group, or nothing but -inf and NaN so far: only the
    // flags can change the row's result.
#pragma unroll
    for (int i = 0; i < K; ++i) {
      a.flags |= (x[i] != x[i]) ? kSawNaN : 0u;
      a.flags |= (x[i] == CUDART_INF_F) ? kSawPosInf : 0u;
    }
  }
}

__device__ __forceinline__ void combine(Acc& a, float m2, float s2, unsigned f2) {
  a.flags |= f2;
  const float mx = fmaxf(a.m, m2);
  if (mx == -CUDART_INF_F) return;  // neither side holds a finite value: s is 0
  a.s = a.s * exp2f((a.m - mx) * kLog2e) + s2 * exp2f((m2 - mx) * kLog2e);
  a.m = mx;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    token_nll_kernel(const T* __restrict__ logits, long long s0, long long s1, int seq,
                     int vocab, const I* __restrict__ target, float* __restrict__ out) {
  using E = Elem<T>;
  constexpr int kPer = E::kPer;
  const int row = blockIdx.x;
  const long long i = row / seq;
  const T* p = logits + i * s0 + (row - i * seq) * s1;

  float tl = 0.f;
  if (threadIdx.x == 0) {
    const long long t = static_cast<long long>(target[row]);
    tl = t >= vocab ? CUDART_NAN_F : E::one(p + (t < 0 ? 0 : t));
  }

  Acc a{-CUDART_INF_F, 0.f, 0u};
  const int misalign = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const int head = min(vocab, ((16 - misalign) & 15) / static_cast<int>(sizeof(T)));
  const int nvec = (vocab - head) / kPer;
  const int tail = head + nvec * kPer;
  if (static_cast<int>(threadIdx.x) < head) {
    const float x = E::one(p + threadIdx.x);
    fold<1>(a, &x);
  }
  if (static_cast<int>(threadIdx.x) < vocab - tail) {
    const float x = E::one(p + tail + threadIdx.x);
    fold<1>(a, &x);
  }

  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (int base = 0; base < nvec; base += kThreads * kUnroll) {
    if (base + kThreads * kUnroll <= nvec) {
      uint4 w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = __ldcs(v + base + u * kThreads + threadIdx.x);
      float x[kUnroll * kPer];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) E::unpack(w[u], x + u * kPer);
      fold<kUnroll * kPer>(a, x);
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = base + u * kThreads + threadIdx.x;
        if (k < nvec) {
          float x[kPer];
          E::unpack(__ldcs(v + k), x);
          fold<kPer>(a, x);
        }
      }
    }
  }

  constexpr unsigned kFull = 0xffffffffu;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, a.m, o);
    const float s2 = __shfl_xor_sync(kFull, a.s, o);
    const unsigned f2 = __shfl_xor_sync(kFull, a.flags, o);
    combine(a, m2, s2, f2);
  }
  constexpr int kWarps = kThreads / 32;
  __shared__ float sh_m[kWarps];
  __shared__ float sh_s[kWarps];
  __shared__ unsigned sh_f[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh_m[warp] = a.m;
    sh_s[warp] = a.s;
    sh_f[warp] = a.flags;
  }
  __syncthreads();
  if (warp == 0) {
    a.m = lane < kWarps ? sh_m[lane] : -CUDART_INF_F;
    a.s = lane < kWarps ? sh_s[lane] : 0.f;
    a.flags = lane < kWarps ? sh_f[lane] : 0u;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(kFull, a.m, o);
      const float s2 = __shfl_xor_sync(kFull, a.s, o);
      const unsigned f2 = __shfl_xor_sync(kFull, a.flags, o);
      combine(a, m2, s2, f2);
    }
    if (lane == 0) {
      float lse;
      if ((a.flags & kSawNaN) || a.s != a.s) {
        lse = CUDART_NAN_F;
      } else if (a.flags & kSawPosInf) {
        lse = CUDART_INF_F;
      } else if (a.m == -CUDART_INF_F) {
        lse = -CUDART_INF_F;
      } else {
        lse = a.m + logf(a.s);
      }
      out[row] = lse - tl;
    }
  }
}

template <typename T>
cudaError_t launch(const void* logits, long long s0, long long s1, int seq, int rows, int vocab,
                   const void* target, int target_wide, float* out, cudaStream_t st) {
  const T* x = static_cast<const T*>(logits);
  if (target_wide) {
    token_nll_kernel<T, long long><<<rows, kThreads, 0, st>>>(
        x, s0, s1, seq, vocab, static_cast<const long long*>(target), out);
  } else {
    token_nll_kernel<T, int><<<rows, kThreads, 0, st>>>(
        x, s0, s1, seq, vocab, static_cast<const int*>(target), out);
  }
  return cudaGetLastError();
}

}  // namespace

// logits: (n, seq, vocab) with strides (s0, s1, 1) in elements; dtype 0 =
// float32, 1 = float16, 2 = bfloat16.  target: (n * seq,) contiguous, int32
// (target_wide 0) or int64 (1).  out: (n * seq,) float32.
extern "C" int token_nll_launch(const void* logits, long long s0, long long s1, int seq,
                                int rows, int vocab, int dtype, const void* target,
                                int target_wide, void* out, void* stream) {
  if (rows < 1 || seq < 1 || vocab < 1 || dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(logits, s0, s1, seq, rows, vocab, target, target_wide, o, st);
  } else if (dtype == 1) {
    err = launch<__half>(logits, s0, s1, seq, rows, vocab, target, target_wide, o, st);
  } else {
    err = launch<__nv_bfloat16>(logits, s0, s1, seq, rows, vocab, target, target_wide, o, st);
  }
  return (int)err;
}
