// One pass over a batch into the int32 counters of every supported member
// of a metric collection.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_mega.py::_mega_kernel
// (entry mega_counts).  The TPU kernel put samples on lanes, multiplied
// every payload by an (A, tile) accumulation-mask matrix and reduced with
// one-hot MXU dots into f32 accumulators in VMEM.  None of that layout is
// carried over; what is kept is the function: for each sample, its
// prediction (the first-max argmax of a 2-D score row, or the integer
// input), its label, its weight (the validity mask) and its slice id, and
// for each member the counts the JAX kernel computes (the payloads of
// pallas_mega.py:161-196 and its wrap rules).
//
// Design.  A warp takes 32 consecutive samples.  With 2-D scores it walks
// the 32 rows four at a time: the lanes read the rows coalesced (256
// columns a pass) and reduce each to torch.argmax's answer (the first NaN,
// else the first maximum), and lane r keeps row r's.  Then each lane holds one
// sample, and every counter add goes through add_grouped: lanes that add
// the same value at the same address are merged (__match_any_sync on the
// 64-bit (address, value) key) and the group's lowest lane adds
// value x group size.  A sample adds into two accumulation rows, not A:
// the global row 0, and row 1 + slice_id when 0 <= slice_id < K.
//
// Counters are int32.  The wrapper orders the member regions so that the
// ones that fit in shared memory come first: a block zeroes a private
// image of that prefix, adds into it, and at the end adds its nonzero
// entries into global memory.  Regions past the image (large confusion
// slabs) take global atomics, which land in the 50 MB L2.  Integer adds
// in any order give the same counts, so the result is bit-equal to the
// plain PyTorch version (ops/mega.py::_mega_counts_plain).
//
// Binned members count, per sample, slot = #{t_j <= s} (count_le.cuh; NaN
// goes to slot T, counted at every threshold as the per-member route
// counts it) into a (total, hit) histogram; the wrapper's suffix sum
// turns slots into per-threshold counts, as binned_count.cu does.
//
// Bound on the H100: bytes.  The batch is read once: N x F x 4 B of
// scores (or N x 4 B of 1-D input), N x 4 B of labels, and the mask and
// slice ids when given.  At the main path's update (65536 x 100 f32) that
// is 26.5 MB, about 7.9 us at 3.35 TB/s.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstring>

#include "count_le.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kRowsInFlight = 4;  // rows whose loads a warp has in flight at once
constexpr int kColsPerLane = 8;   // 256 columns a pass, one load a lane each
constexpr int kMaxMembers = 64;
constexpr int kMaxSlots = 3 * kMaxMembers;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, a block's opt-in maximum
constexpr unsigned kFull = 0xffffffffu;

// Kinds and specs; the numbers are ops/mega.py's _KINDS and _SPECS.
enum Kind { kMoment = 0, kScatter = 1, kCm = 2, kBinned = 3 };
enum Spec { kPlain = 0, kAccMacro = 1, kBinaryCm = 2 };
// Moment payloads; the numbers are ops/mega.py's _PAYLOADS.
enum Payload {
  kOnes = 0, kEq, kNeq, kBeq, kPb, kT1, kPbT1, kPbT0, kTraw, kPbTraw, kHit1
};

struct MemberDesc {
  int kind;
  int spec;
  int width;          // C, or T for a binned member
  int region;         // offset of the member's counters, in ints
  int moment_region;  // offset of its (A, num_slots) moment block
  int slot_begin;     // its payloads in Plan::slots
  int num_slots;
  int thr_bits;       // the decision threshold, as float bits
  int thr_off;        // a binned member's thresholds in `thresholds`
  int pad;
};

// Laid out by ops/mega.py::_desc as int32 words; every field is 4 bytes,
// so the struct has no padding.
struct Plan {
  int num_members;
  int slices;
  int features;   // F, or 0 for 1-D input
  int smem_ints;  // counters [0, smem_ints) live in the shared image
  MemberDesc members[kMaxMembers];
  int slots[kMaxSlots];
};

// True when (va, ia) comes before (vb, ib) in torch.argmax's order: a NaN
// first (the lowest index among NaNs), then the larger value, then the
// lower index.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

// The argmaxes of rows [base, base + 32) of the (n, f) scores, rows past n
// skipped: lane r returns row base + r's.  The warp starts the loads of
// kRowsInFlight rows (kColsPerLane a lane and row) before it reduces any of
// them, so their latencies overlap; each lane visits its columns in
// increasing order, and the shuffle reduction breaks ties by index.
__device__ __forceinline__ int warp_argmax_rows(const float* __restrict__ scores,
                                                int f, long long base,
                                                long long n, int lane) {
  int mine = 0;
  for (int r0 = 0; r0 < 32 && base + r0 < n; r0 += kRowsInFlight) {
    float bv[kRowsInFlight];
    int bi[kRowsInFlight];
#pragma unroll
    for (int q = 0; q < kRowsInFlight; ++q) {
      bv[q] = -INFINITY;
      bi[q] = INT_MAX;
    }
    for (int c0 = 0; c0 < f; c0 += 32 * kColsPerLane) {
      float v[kRowsInFlight][kColsPerLane];
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const long long row = base + r0 + q;
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = c0 + lane + 32 * k;
          v[q][k] = (row < n && c < f) ? scores[row * f + c] : 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = c0 + lane + 32 * k;
          if (base + r0 + q < n && c < f && before(v[q][k], c, bv[q], bi[q])) {
            bv[q] = v[q][k];
            bi[q] = c;
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const float ov = __shfl_xor_sync(kFull, bv[q], off);
        const int oi = __shfl_xor_sync(kFull, bi[q], off);
        if (before(ov, oi, bv[q], bi[q])) {
          bv[q] = ov;
          bi[q] = oi;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRowsInFlight; ++q) {
      if (lane == r0 + q) mine = bi[q];
    }
  }
  return mine;
}

// All 32 lanes call this together.  A lane with idx < 0 or val == 0 adds
// nothing; lanes with equal (idx, val) are merged into one atomic.
__device__ __forceinline__ void add_grouped(int* base, int idx, int val,
                                            int lane) {
  const bool live = idx >= 0 && val != 0;
  const unsigned long long key =
      live ? ((unsigned long long)(unsigned)idx << 32) | (unsigned)val
           : ~0ull;
  const unsigned peers = __match_any_sync(kFull, key);
  if (live && lane == __ffs(peers) - 1) {
    atomicAdd(base + idx, __popc(peers) * val);
  }
}

// One counter family of `row_len` entries per accumulation row: entry idx
// of row 0, and of row `row1` when the sample has a slice.
__device__ __forceinline__ void add_rows(int* base, int row_len, int row1,
                                         int idx, int val, int lane) {
  add_grouped(base, idx, val, lane);
  add_grouped(base, (row1 < 0 || idx < 0) ? -1 : row1 * row_len + idx, val,
              lane);
}

// numpy's negative wrap, once; what stays outside [0, c) is dropped (-1).
__device__ __forceinline__ int wrap_drop(int v, int c) {
  if (v < 0) v += c;
  return (v < 0 || v >= c) ? -1 : v;
}

// _wrap_labels: wrap once, a value still negative parks on the sentinel c;
// values >= c are never counted.
__device__ __forceinline__ int wrap_sentinel(int v, int c) {
  if (v < 0) v += c;
  return v < 0 ? c : v;
}

__device__ __forceinline__ int payload(int pid, int pred, int t, int pb) {
  switch (pid) {
    case kOnes: return 1;
    case kEq: return pred == t;
    case kNeq: return pred != t;
    case kBeq: return pb == t;
    case kPb: return pb;
    case kT1: return t != 0;
    case kPbT1: return pb & (t != 0);
    case kPbT0: return pb & (t == 0);
    case kTraw: return t;
    case kPbTraw: return pb * t;
    case kHit1: return t == 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
mega_kernel(const float* __restrict__ scores, const int* __restrict__ pred_in,
            const int* __restrict__ target, const int* __restrict__ weight,
            const int* __restrict__ sids, long long n,
            const float* __restrict__ thresholds, int* __restrict__ out,
            const __grid_constant__ Plan plan) {
  extern __shared__ int image[];
  for (int j = threadIdx.x; j < plan.smem_ints; j += kThreads) image[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int a = 1 + plan.slices;
  const long long step = (long long)gridDim.x * kThreads;
  // The loop bound is the warp's, so all 32 lanes reach every warp-wide
  // intrinsic together; lanes past n carry weight 0.
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
       base < n; base += step) {
    const long long i = base + lane;
    const bool valid = i < n;
    int pred = 0;
    float s = 0.0f;
    if (plan.features > 0) {
      pred = warp_argmax_rows(scores, plan.features, base, n, lane);
    } else if (valid) {
      if (scores != nullptr) s = scores[i];
      if (pred_in != nullptr) pred = pred_in[i];
    }
    const int t = valid ? target[i] : 0;
    const int w = valid ? (weight != nullptr ? weight[i] : 1) : 0;
    int row1 = -1;
    if (valid && sids != nullptr) {
      const int k = sids[i];
      if (k >= 0 && k < plan.slices) row1 = 1 + k;
    }

    for (int q = 0; q < plan.num_members; ++q) {
      const MemberDesc& m = plan.members[q];
      const int pb = !(s < __int_as_float(m.thr_bits));  // NaN -> 1
      if (m.num_slots > 0) {
        int* mom = m.moment_region < plan.smem_ints ? image + m.moment_region
                                                    : out + m.moment_region;
        for (int j = 0; j < m.num_slots; ++j) {
          const int v = payload(plan.slots[m.slot_begin + j], pred, t, pb) * w;
          add_rows(mom, m.num_slots, row1, j, v, lane);
        }
      }
      if (m.kind == kMoment) continue;
      int* reg = m.region < plan.smem_ints ? image + m.region : out + m.region;
      const int c = m.width;
      if (m.kind == kScatter) {
        const int ac = a * c;
        if (m.spec == kAccMacro) {
          // .at[target].add: wrap once, drop the rest; correct is raw
          // equality.
          const int ti = wrap_drop(t, c);
          add_rows(reg, c, row1, ti, pred == t ? w : 0, lane);
          add_rows(reg + ac, c, row1, ti, w, lane);
        } else {
          const int tw = wrap_sentinel(t, c), pw = wrap_sentinel(pred, c);
          const int ti = tw < c ? tw : -1, pi = pw < c ? pw : -1;
          add_rows(reg, c, row1, ti, (ti >= 0 && tw == pw) ? w : 0, lane);
          add_rows(reg + ac, c, row1, ti, w, lane);
          add_rows(reg + 2 * ac, c, row1, pi, w, lane);
        }
      } else if (m.kind == kCm) {
        const int tw = wrap_sentinel(t, c);
        const int pw = wrap_sentinel(m.spec == kBinaryCm ? pb : pred, c);
        const int cell = (tw < c && pw < c) ? tw * c + pw : -1;
        add_rows(reg, c * c, row1, cell, w, lane);
      } else {  // kBinned
        const int nt = c;
        const int slot =
            s != s ? nt
                   : count_le<1>(thresholds + m.thr_off, nt,
                                 1 << (31 - __clz(nt)), s);
        const int row_len = nt + 1;
        add_rows(reg, row_len, row1, slot, w, lane);
        add_rows(reg + a * row_len, row_len, row1, slot, t == 1 ? w : 0, lane);
      }
    }
  }

  __syncthreads();
  for (int j = threadIdx.x; j < plan.smem_ints; j += kThreads) {
    const int v = image[j];
    if (v != 0) atomicAdd(out + j, v);
  }
}

}  // namespace

// scores: (n, F) f32 row-major when plan.features > 0, else (n,) f32 or
// null; pred: (n,) int32 or null; target: (n,) int32; weight, sids: (n,)
// int32 or null; thresholds: the binned members' grids, f32; plan: the
// host bytes of a Plan (plan_bytes == sizeof(Plan)); out: the counters,
// int32, zeroed by the caller.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a malformed plan.
extern "C" int mega_counts_launch(const void* scores, const void* pred,
                                  const void* target, const void* weight,
                                  const void* sids, long long n,
                                  const void* thresholds, const void* plan,
                                  int plan_bytes, void* out, void* stream) {
  if (plan_bytes != (int)sizeof(Plan)) return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.num_members < 1 || p.num_members > kMaxMembers || p.smem_ints < 0 ||
      (long long)p.smem_ints * 4 > kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  // The opt-in maximum on every launch, whatever the plan: the attribute
  // is per device, and a smaller value set by one thread could otherwise
  // refuse another thread's launch.
  cudaError_t err = cudaFuncSetAttribute(
      mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSharedBytes);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)p.smem_ints * 4;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_kernel,
                                                kThreads, (int)smem);
  if (per_sm < 1) per_sm = 1;
  // At least one sample per thread, so a block's private image is added
  // into global memory once per kThreads samples at the most.
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  if (blocks < 1) blocks = 1;
  mega_kernel<<<(int)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(pred),
      static_cast<const int*>(target), static_cast<const int*>(weight),
      static_cast<const int*>(sids), n, static_cast<const float*>(thresholds),
      static_cast<int*>(out), p);
  return (int)cudaGetLastError();
}
