// Exact tie-aware AUC over rows already sorted by descending score.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_auc.py::_auc_scan_kernel
// (entry auc_from_sorted).  Per row, in Mann-Whitney form:
//
//     acc  = sum over tie groups g of  P_g * (end_fp_g + prevend_fp_g)
//     area = P * N_neg - acc / 2,      AUC = area / (P * N_neg)
//
// with P_g the group's positives, end_fp_g / prevend_fp_g the cumulative
// negatives at the end of the group and of the group before it, and 0.5
// for a row with no positives or no negatives.  A group is settled at the
// first element of the NEXT group (t[i] != t[i-1], a boundary), whose
// exclusive cumulative counts are the group's end values.
//
// Design: a row split over every SM.  Any stretch of a row reduces to a
// summary (struct Sum): its positives and negatives, the stretch-local
// counts before its first and before its last boundary, and the int64 sum
// `a` of the groups that open and close inside it.  Two adjacent summaries
// combine exactly (combine() below), and the combine is associative, so a
// row can be cut anywhere and reduced in any tree that keeps the order:
//
//   * lane: 16 consecutive elements in registers (four 16-byte score loads
//     and one 16-byte load of 16 hits; a warp reads one contiguous span of
//     512), its left neighbour from __shfl_up_sync, at the warp's edge from
//     the span before, at the start of the warp's stretch from t[e - 1] in
//     global memory;
//   * warp: an ordered shuffle tree over its 32 lanes, then carried across
//     its spans;
//   * block (one chunk of a row): the 8 warps' summaries, one barrier;
//   * row: a second small launch combines the row's chunks in order (one
//     block a row); a row of one chunk is finished by its own block.
//
// The grid is rows x chunks on gridDim.x; the wrapper's plan
// (ops/auc.py::auc_plan) sizes the chunks so that one long row fills the
// card (2^22 samples: 1024 chunks of 4096) and many rows take a few chunks
// each.  Where both arrays are 16-byte aligned, each row's spans are laid
// on the 16-element grid of the flat (rows, n) array (the row's `shift`),
// so every full lane group loads with 16-byte loads; elements outside [0,
// n) are masked.  The chunk summaries live in a scratch the wrapper takes
// from PyTorch's caching allocator.
//
// Every count is an integer and `a` an exact int64 (acc < 2^61 for N <
// 2^31), so any split gives the same bits as the plain PyTorch version;
// the JAX kernel's Kahan f32 sum agrees bitwise while its partial sums stay
// below 2^24.  The final f32 arithmetic is spelled with _rn intrinsics so
// nvcc cannot contract it into an FMA.
//
// Bound on the H100: bytes (each sorted score, 4 B, and hit, 1 B, read
// once).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                 // consecutive elements a lane
constexpr int kSpan = 32 * kPer;         // a warp's step: 512 elements
constexpr int kChunkUnit = kWarps * kSpan;  // chunks are multiples of 4096
constexpr unsigned kFull = 0xffffffffu;

// A stretch of a row.  Counts are local to the stretch; ftp < 0: no
// boundary in it.  32 bytes, the layout of ops/auc.py's scratch.
struct Sum {
  int tp, fp;    // positives and negatives
  int ftp, ffp;  // counts before its first boundary
  int ltp, lfp;  // counts before its last boundary
  long long a;   // sum over consecutive boundaries (i-1, i) inside it of
                 // (tp_i - tp_{i-1}) * (fp_i + fp_{i-1})
};
static_assert(sizeof(Sum) == 32, "ops/auc.py's scratch holds 32 B a chunk");

__device__ __forceinline__ Sum empty_sum() { return Sum{0, 0, -1, 0, 0, 0, 0}; }

// x followed by y.  Counts of y shift by x's totals; y's first boundary
// settles the group that opened at x's last boundary.
__device__ __forceinline__ Sum combine(const Sum& x, const Sum& y) {
  Sum r = x;
  r.tp = x.tp + y.tp;
  r.fp = x.fp + y.fp;
  if (y.ftp < 0) return r;
  const long long inner = y.a + 2LL * x.fp * (long long)(y.ltp - y.ftp);
  if (x.ftp < 0) {
    r.ftp = x.tp + y.ftp;
    r.ffp = x.fp + y.ffp;
    r.a = inner;
  } else {
    r.a = x.a + inner +
          (long long)(x.tp + y.ftp - x.ltp) * ((long long)x.fp + y.ffp + x.lfp);
  }
  r.ltp = x.tp + y.ltp;
  r.lfp = x.fp + y.lfp;
  return r;
}

__device__ __forceinline__ Sum shfl_down(const Sum& s, int d) {
  Sum r;
  r.tp = __shfl_down_sync(kFull, s.tp, d);
  r.fp = __shfl_down_sync(kFull, s.fp, d);
  r.ftp = __shfl_down_sync(kFull, s.ftp, d);
  r.ffp = __shfl_down_sync(kFull, s.ffp, d);
  r.ltp = __shfl_down_sync(kFull, s.ltp, d);
  r.lfp = __shfl_down_sync(kFull, s.lfp, d);
  r.a = __shfl_down_sync(kFull, s.a, d);
  return r;
}

// Lane 0 gets lanes 0..31 combined in lane order.
__device__ __forceinline__ Sum warp_reduce(Sum s) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) s = combine(s, shfl_down(s, d));
  return s;
}

// The block's warps' summaries, in warp order, on thread 0.
__device__ __forceinline__ Sum block_reduce(const Sum& warp_sum, Sum* s_warp) {
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = warp_sum;
  __syncthreads();
  Sum c = s_warp[0];
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) c = combine(c, s_warp[w]);
  }
  return c;
}

// A row's AUC from its summary: a boundary at counts (0, 0) before the row
// and one at the row's totals after it settle the first and last groups.
__device__ __forceinline__ float finish(const Sum& s) {
  const Sum edge{0, 0, 0, 0, 0, 0, 0};
  const Sum all = combine(combine(edge, s), edge);
  const float factor = __fmul_rn(__int2float_rn(s.tp), __int2float_rn(s.fp));
  const float area = __fsub_rn(factor, __fmul_rn(0.5f, __ll2float_rn(all.a)));
  return factor == 0.0f ? 0.5f : __fdiv_rn(area, factor);
}

// One chunk of one row: block b = row * chunks + k covers q in [k * chunk,
// (k + 1) * chunk) of the row's positions q = e + shift; warp w takes
// chunk / kWarps consecutive positions of it, kSpan at a time.
__global__ void __launch_bounds__(kThreads)
auc_chunk_kernel(const float* __restrict__ thresholds,
                 const uint8_t* __restrict__ hits, long long n, int chunk,
                 int chunks, int vec, Sum* __restrict__ sums,
                 float* __restrict__ out) {
  __shared__ Sum s_warp[kWarps];
  const long long row = blockIdx.x / chunks;
  const int k = (int)(blockIdx.x - row * chunks);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float* t_row = thresholds + row * n;
  const uint8_t* h_row = hits + row * n;
  const int shift = vec ? (int)((row * n) & 15) : 0;
  const int warp_len = chunk / kWarps;
  const long long e_begin = (long long)k * chunk + (long long)w * warp_len - shift;
  const long long e_end = e_begin + warp_len < n ? e_begin + warp_len : n;

  Sum acc = empty_sum();
  // The element left of the warp's first: read once, a broadcast load.
  float prev = (e_begin > 0 && e_begin <= n) ? t_row[e_begin - 1] : 0.0f;
  for (long long base = e_begin; base < e_end; base += kSpan) {
    const long long e0 = base + lane * kPer;
    float v[kPer];
    uint32_t hw[kPer / 4];
    if (vec && e0 >= 0 && e0 + kPer <= n) {
      const float4* t4 = reinterpret_cast<const float4*>(t_row + e0);
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j) {
        const float4 q = t4[j];
        v[4 * j] = q.x;
        v[4 * j + 1] = q.y;
        v[4 * j + 2] = q.z;
        v[4 * j + 3] = q.w;
      }
      const uint4 hq = *reinterpret_cast<const uint4*>(h_row + e0);
      hw[0] = hq.x;
      hw[1] = hq.y;
      hw[2] = hq.z;
      hw[3] = hq.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPer / 4; ++j) hw[j] = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long long e = e0 + j;
        const bool in = e >= 0 && e < n;
        v[j] = in ? t_row[e] : 0.0f;
        hw[j >> 2] |= (in && h_row[e] != 0 ? 1u : 0u) << (8 * (j & 3));
      }
    }
    const float up = __shfl_up_sync(kFull, v[kPer - 1], 1);
    const float left0 = lane == 0 ? prev : up;
    prev = __shfl_sync(kFull, v[kPer - 1], 31);

    Sum s = empty_sum();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long e = e0 + j;
      const bool valid = e >= 0 && e < n;
      const float left = j == 0 ? left0 : v[j - 1];
      if (valid && e > 0 && v[j] != left) {
        if (s.ftp < 0) {
          s.ftp = s.tp;
          s.ffp = s.fp;
        } else {
          s.a += (long long)(s.tp - s.ltp) * (long long)(s.fp + s.lfp);
        }
        s.ltp = s.tp;
        s.lfp = s.fp;
      }
      const int hit = ((hw[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0;
      s.tp += valid & hit;
      s.fp += valid & !hit;
    }
    acc = combine(acc, warp_reduce(s));  // lane 0's is the warp's
  }

  const Sum c = block_reduce(acc, s_warp);
  if (threadIdx.x == 0) {
    if (chunks == 1) {
      out[row] = finish(c);
    } else {
      sums[blockIdx.x] = c;
    }
  }
}

// The chunks of row blockIdx.x, combined in order: thread i takes a
// contiguous run of them, then the warp tree and the block's warps.
__global__ void __launch_bounds__(kThreads)
auc_combine_kernel(const Sum* __restrict__ sums, int chunks,
                   float* __restrict__ out) {
  __shared__ Sum s_warp[kWarps];
  const Sum* row_sums = sums + (long long)blockIdx.x * chunks;
  const int per = (chunks + kThreads - 1) / kThreads;
  const int j0 = threadIdx.x * per;
  const int j1 = min(j0 + per, chunks);
  Sum s = empty_sum();
  for (int j = j0; j < j1; ++j) s = combine(s, row_sums[j]);
  const Sum c = block_reduce(warp_reduce(s), s_warp);
  if (threadIdx.x == 0) out[blockIdx.x] = finish(c);
}

}  // namespace

// thresholds (rows, n) f32 and hits (rows, n) 1-byte 0/1, both contiguous,
// rows sorted by descending threshold; out (rows,) f32.  The plan
// (ops/auc.py::auc_plan): `chunks` chunks of `chunk` positions a row (a
// multiple of 4096, covering n plus the row's shift), `vec` when both
// arrays are 16-byte aligned; `scratch` holds rows x chunks summaries of 32
// bytes when chunks > 1.  Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a plan that does not cover the rows.
extern "C" int auc_scan_launch(const void* thresholds, const void* hits,
                               int rows, long long n, int chunk, int chunks,
                               int vec, void* scratch, void* out,
                               void* stream) {
  const long long reach = n + (vec && n % 16 ? 15 : 0);
  if (rows < 1 || n < 1 || chunk < kChunkUnit || chunk % kChunkUnit != 0 ||
      chunks < 1 || (long long)chunk * chunks < reach ||
      (long long)chunk * (chunks - 1) >= reach ||
      (long long)rows * chunks > INT_MAX || (chunks > 1 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Sum* sums = static_cast<Sum*>(scratch);
  float* o = static_cast<float*>(out);
  auc_chunk_kernel<<<rows * chunks, kThreads, 0, s>>>(
      static_cast<const float*>(thresholds), static_cast<const uint8_t*>(hits),
      n, chunk, chunks, vec, sums, o);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  auc_combine_kernel<<<rows, kThreads, 0, s>>>(sums, chunks, o);
  return (int)cudaGetLastError();
}
