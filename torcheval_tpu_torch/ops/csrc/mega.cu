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
// Design: a launch plan (ops/mega.py::_launch_plan) picks one of two
// shapes of the same kernel from n and the counter layout.
//
//   * global (small batches, n <= 4096, as a sliced stream's): the counters
//     are split, not the samples.  Each block takes one member (a "group")
//     and all of the batch's samples, and adds straight into the counters
//     in global memory (atomics that land in the 50 MB L2): no image to
//     zero or flush, and the members run on as many SMs at once.
//   * image (large batches, as the collection update's 65536 x 100): one
//     persistent block an SM takes every member over its share of the
//     batch, in a private image of the counters in shared memory (the
//     layout's prefix that fits), zeroed once and added into global memory
//     once a block.  Regions past the image take global atomics.
//
// Either way a warp walks tiles of 32 consecutive samples.  With 2-D
// scores, the warp stages its tile's contiguous (32, F) rows in its own
// buffer in shared memory with 16-byte cp.async copies (4-byte where the
// scores are not 16-byte aligned), lane r reduces row r to torch.argmax's
// answer (the first NaN, else the first maximum), and the warp starts the
// copy of its next tile before the current tile's adds, so those bytes are
// in flight while it counts.  Then each lane holds one sample and adds its
// counts with one atomic each (a moment's, which every lane adds at one
// address, is summed over the warp first).  A sample adds into row 0 and,
// with slices, into row 1 + slice_id when 0 <= slice_id < K.
//
// Counters are int32.  Integer adds in any order give the same counts, so
// the result is bit-equal to the plain PyTorch version
// (ops/mega.py::_mega_counts_plain) whatever the plan.
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

#include <atomic>
#include <climits>
#include <cstring>

#include "count_le.cuh"
#include "query_ring.cuh"

namespace {

using query_ring::cp_async16;
using query_ring::cp_async4;
using query_ring::cp_async_commit;
using query_ring::cp_async_wait;

constexpr int kMaxWarps = 16;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxFeatures = 256;  // ops/_mega_plan.py's _MAX_FEATURES
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
  int features;       // F, or 0 for 1-D input
  int smem_ints;      // counters [0, smem_ints) live in the shared image
  int warps;          // warps a block
  int group_members;  // members a block counts: 1, or all with an image
  int sample_blocks;  // blocks that share one group's samples
  int vec16;          // 16-byte copies of the score tiles, else 4-byte
  int smem_bytes;     // dynamic shared memory: the image, then the tiles
  MemberDesc members[kMaxMembers];
  int slots[kMaxSlots];
};

// Where the warps' score tiles start in the dynamic shared memory, in
// ints: past the image, 16-byte aligned.
__host__ __device__ __forceinline__ int stage_offset(int smem_ints) {
  return (smem_ints + 3) & ~3;
}

// True when (va, ia) comes before (vb, ib) in torch.argmax's order: a NaN
// first (the lowest index among NaNs), then the larger value, then the
// lower index.
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na != nb) return na;
  if (!na && va != vb) return va > vb;
  return ia < ib;
}

// One step of a scan in increasing column order: keep the first NaN, else
// the first maximum.
__device__ __forceinline__ void take(float v, int c, float& best, int& bi) {
  if (best == best && (v != v || v > best)) {
    best = v;
    bi = c;
  }
}

// torch.argmax of one row of f scores in shared memory.  Where f % 4 == 0
// the row is 16-byte aligned: 16-byte loads (a quarter warp's eight rows
// then fall on distinct banks) feed four scans, of the columns equal to 0,
// 1, 2 and 3 mod 4, merged in torch.argmax's order.
__device__ __forceinline__ int row_argmax(const float* row, int f) {
  if ((f & 3) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float4 q = r4[0];
    float b0 = q.x, b1 = q.y, b2 = q.z, b3 = q.w;
    int i0 = 0, i1 = 1, i2 = 2, i3 = 3;
#pragma unroll 4
    for (int k = 1; k < f / 4; ++k) {
      q = r4[k];
      take(q.x, 4 * k, b0, i0);
      take(q.y, 4 * k + 1, b1, i1);
      take(q.z, 4 * k + 2, b2, i2);
      take(q.w, 4 * k + 3, b3, i3);
    }
    if (before(b1, i1, b0, i0)) b0 = b1, i0 = i1;
    if (before(b3, i3, b2, i2)) b2 = b3, i2 = i3;
    return before(b2, i2, b0, i0) ? i2 : i0;
  }
  float best = row[0];
  int bi = 0;
  for (int c = 1; c < f; ++c) take(row[c], c, best, bi);
  return bi;
}

// Start the copies of tile `tile` (rows 32 tile .. 32 tile + 31, those
// below n) of the (n, f) scores into the warp's buffer: the rows are
// contiguous, so lane k copies pieces k, k + 32, ...  A 16-byte copy of a
// partial last piece reads only the live bytes; rows past n are not
// copied, and their lanes never read them.
__device__ __forceinline__ void issue_tile(float* dst, const float* scores,
                                           long long tile, long long n, int f,
                                           bool vec16, int lane) {
  const long long row0 = tile * 32;
  const int count = (int)(n - row0 < 32 ? n - row0 : 32) * f;
  const float* src = scores + row0 * f;
  if (vec16) {
    for (int p = lane * 4; p < count; p += 128) {
      cp_async16(dst + p, src + p, 4 * min(4, count - p));
    }
  } else {
    for (int p = lane; p < count; p += 32) cp_async4(dst + p, src + p);
  }
}

// One counter family of `row_len` entries per accumulation row: entry idx
// of row 0 and, when the plan has slices (`sliced`, the same in every
// lane), of row `row1` when the sample has one.  A lane with idx < 0 or
// val == 0 adds nothing.  Each add is one atomic of its own: lanes that hit
// one address are serialised by the atomic unit, which costs less than
// grouping them first (__match_any_sync) where the addresses spread.
__device__ __forceinline__ void add_rows(int* base, int row_len, int row1,
                                         int idx, int val, bool sliced) {
  if (idx >= 0 && val != 0) {
    atomicAdd(base + idx, val);
    if (sliced && row1 >= 0) atomicAdd(base + row1 * row_len + idx, val);
  }
}

// A moment payload: every lane adds at entry j of row 0, so the warp sums
// first and one lane adds; the slice rows take an atomic a lane.  All 32
// lanes call this together.
__device__ __forceinline__ void add_moment(int* base, int slots, int row1,
                                           int j, int val, int lane,
                                           bool sliced) {
  const int total = __reduce_add_sync(kFull, val);
  if (lane == 0 && total != 0) atomicAdd(base + j, total);
  if (sliced && row1 >= 0 && val != 0) atomicAdd(base + row1 * slots + j, val);
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

__global__ void __launch_bounds__(kMaxThreads)
mega_kernel(const float* __restrict__ scores, const int* __restrict__ pred_in,
            const int* __restrict__ target, const int* __restrict__ weight,
            const int* __restrict__ sids, long long n,
            const float* __restrict__ thresholds, int* __restrict__ out,
            const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) int image[];
  for (int j = threadIdx.x; j < plan.smem_ints; j += blockDim.x) image[j] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int group = blockIdx.x / plan.sample_blocks;
  const int q_begin = group * plan.group_members;
  const int q_end = min(q_begin + plan.group_members, plan.num_members);
  const int a = 1 + plan.slices;
  const bool sliced = plan.slices > 0;
  const int f = plan.features;
  float* stage = reinterpret_cast<float*>(image + stage_offset(plan.smem_ints)) +
                 (long long)w * 32 * f;
  const long long tiles = (n + 31) / 32;
  const long long step = (long long)plan.sample_blocks * plan.warps;
  long long tile =
      (long long)(blockIdx.x - group * plan.sample_blocks) * plan.warps + w;
  if (f > 0 && tile < tiles) issue_tile(stage, scores, tile, n, f, plan.vec16, lane);
  cp_async_commit();
  // The loop bound is the warp's, so all 32 lanes reach every warp-wide
  // intrinsic together; lanes past n carry weight 0.
  for (; tile < tiles; tile += step) {
    const long long i = tile * 32 + lane;
    const bool valid = i < n;
    const int t = valid ? target[i] : 0;
    const int w8 = valid ? (weight != nullptr ? weight[i] : 1) : 0;
    int row1 = -1;
    if (valid && sids != nullptr) {
      const int k = sids[i];
      if (k >= 0 && k < plan.slices) row1 = 1 + k;
    }
    int pred = 0;
    float s = 0.0f;
    if (f > 0) {
      cp_async_wait<0>();
      __syncwarp();  // every lane's copies of this tile are visible
      if (valid) pred = row_argmax(stage + lane * f, f);
      __syncwarp();  // the buffer is free for the next tile's copies
      if (tile + step < tiles) {
        issue_tile(stage, scores, tile + step, n, f, plan.vec16, lane);
      }
      cp_async_commit();
    } else if (valid) {
      if (scores != nullptr) s = scores[i];
      if (pred_in != nullptr) pred = pred_in[i];
    }

    for (int q = q_begin; q < q_end; ++q) {
      const MemberDesc& m = plan.members[q];
      const int pb = !(s < __int_as_float(m.thr_bits));  // NaN -> 1
      if (m.num_slots > 0) {
        int* mom = m.moment_region < plan.smem_ints ? image + m.moment_region
                                                    : out + m.moment_region;
        for (int j = 0; j < m.num_slots; ++j) {
          const int v = payload(plan.slots[m.slot_begin + j], pred, t, pb) * w8;
          add_moment(mom, m.num_slots, row1, j, v, lane, sliced);
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
          add_rows(reg, c, row1, ti, pred == t ? w8 : 0, sliced);
          add_rows(reg + ac, c, row1, ti, w8, sliced);
        } else {
          const int tw = wrap_sentinel(t, c), pw = wrap_sentinel(pred, c);
          const int ti = tw < c ? tw : -1, pi = pw < c ? pw : -1;
          add_rows(reg, c, row1, ti, (ti >= 0 && tw == pw) ? w8 : 0, sliced);
          add_rows(reg + ac, c, row1, ti, w8, sliced);
          add_rows(reg + 2 * ac, c, row1, pi, w8, sliced);
        }
      } else if (m.kind == kCm) {
        const int tw = wrap_sentinel(t, c);
        const int pw = wrap_sentinel(m.spec == kBinaryCm ? pb : pred, c);
        const int cell = (tw < c && pw < c) ? tw * c + pw : -1;
        add_rows(reg, c * c, row1, cell, w8, sliced);
      } else {  // kBinned
        const int nt = c;
        const int slot =
            s != s ? nt
                   : count_le<1>(thresholds + m.thr_off, nt,
                                 1 << (31 - __clz(nt)), s);
        const int row_len = nt + 1;
        add_rows(reg, row_len, row1, slot, w8, sliced);
        add_rows(reg + a * row_len, row_len, row1, slot, t == 1 ? w8 : 0, sliced);
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();
  for (int j = threadIdx.x; j < plan.smem_ints; j += blockDim.x) {
    const int v = image[j];
    if (v != 0) atomicAdd(out + j, v);
  }
}

// The opt-in maximum of dynamic shared memory, set once a device.  The
// attribute is per device, and every launch asks for at most this value,
// so threads that race here all set the same value and none can refuse
// another thread's launch.
std::atomic<unsigned long long> g_smem_attribute_set{0};

cudaError_t ensure_smem_attribute() {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (g_smem_attribute_set.load(std::memory_order_acquire) & bit)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(mega_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSharedBytes);
  if (err == cudaSuccess) g_smem_attribute_set.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace

// scores: (n, F) f32 row-major when plan.features > 0, else (n,) f32 or
// null; pred: (n,) int32 or null; target: (n,) int32; weight, sids: (n,)
// int32 or null; thresholds: the binned members' grids, f32; plan: the
// host bytes of a Plan (plan_bytes == sizeof(Plan)), its launch geometry
// included; out: the counters, int32, zeroed by the caller.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// malformed plan.
extern "C" int mega_counts_launch(const void* scores, const void* pred,
                                  const void* target, const void* weight,
                                  const void* sids, long long n,
                                  const void* thresholds, const void* plan,
                                  int plan_bytes, void* out, void* stream) {
  if (plan_bytes != (int)sizeof(Plan)) return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  const long long smem =
      p.features > 0
          ? (long long)stage_offset(p.smem_ints) * 4 +
                (long long)p.warps * 32 * p.features * 4
          : (long long)p.smem_ints * 4;
  if (p.num_members < 1 || p.num_members > kMaxMembers || p.smem_ints < 0 ||
      p.features < 0 || p.features > kMaxFeatures || p.warps < 1 ||
      p.warps > kMaxWarps || p.group_members < 1 || p.sample_blocks < 1 ||
      (p.smem_ints > 0 && p.group_members < p.num_members) ||
      p.smem_bytes != smem || smem > kMaxSharedBytes) {
    return (int)cudaErrorInvalidValue;
  }
  const long long groups = (p.num_members + p.group_members - 1) / p.group_members;
  const long long blocks = groups * p.sample_blocks;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = ensure_smem_attribute();
  if (err != cudaSuccess) return (int)err;
  mega_kernel<<<(int)blocks, p.warps * 32, (size_t)smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(pred),
      static_cast<const int*>(target), static_cast<const int*>(weight),
      static_cast<const int*>(sids), n, static_cast<const float*>(thresholds),
      static_cast<int*>(out), p);
  return (int)cudaGetLastError();
}
