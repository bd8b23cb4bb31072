// The (target, prediction) pair-count slab under the confusion matrix and
// the per-class count trio of F1 / precision / recall.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_cm.py::_cm_kernel (entry
// confusion_slab).  For labels already mapped into [0, C], where C is the
// out-of-range sentinel, it counts
//
//     slab[t, p] = #{i : target_i = t, pred_i = p}      (W = C + 1, int32)
//
// The TPU kernel compacted each tile's samples into 64-class buckets
// through bf16 MXU gathers, ran a triangular-prefix matmul for the ranks
// and fell back to a dense one-hot matmul on overflowing tiles, all to
// avoid scatters, which serialize on a TPU.  None of that is carried over:
// Hopper has atomics in L2.
//
// Design.  The labels are read in place as the caller holds them, int32 or
// int64 (a template for each of the two vectors), so no cast runs before
// the kernel.  The wrapper's plan (ops/cm.py::slab_plan) sizes the grid
// from the SM count: blocks of 4 warps, each warp walking tiles of 256
// pairs (grid-stride), lane l taking pairs 8l .. 8l + 7 of the tile.  VEC:
// both vectors are 16-byte aligned, so a lane's 8 labels of each arrive as
// 16-byte loads (two for int32, four for int64), all issued before any
// atomic; otherwise, and for a tile's last partial lane, label by label.
// Each pair adds 1 at cell t * W + p with one atomicAdd (a RED) into the
// int32 slab in global memory, resident in L2 (4 MiB at C = 1000).  The
// 32 pairs of a round go together: when every lane's cell is the same
// (__reduce_min_sync == __reduce_max_sync), the warp's count joins a
// pending add that one lane makes when the cell changes or the tile ends,
// so every sample in one cell costs one atomic a warp tile; when two
// neighbouring lanes share a cell (a skew), the round merges its lanes by
// cell (__match_any_sync) first; otherwise, as at C = 1000 where the 32
// cells of a round almost never meet, each lane adds its own pair with no
// match.  (Without the match, pairs in two cells took 8x as long and
// spread pairs the same: PERF.md.)  A label outside [0, C] is skipped: the wrapper raises on such
// labels, and the kernel never writes outside the slab even when that
// check is off.  Counts are integers, so the order of the atomics
// cannot change the result: the slab is bit-equal to the plain version.
//
// Bound on the H100: bytes.  8 B (int32) or 16 B (int64) read per pair
// plus the slab written once ((C+1)^2 x 4 B, zeroed by the wrapper).  At the
// lifecycle's shape (2^17 int32 pairs, C = 1000) that is 1 MiB + 4 MiB,
// about 1.6 us at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPer = 8;           // pairs a lane
constexpr int kTile = 32 * kPer;  // pairs a warp tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

// A lane's kPer labels from q on (-1 past n).
template <bool VEC, typename L>
__device__ __forceinline__ void load_labels(const L* __restrict__ src, long long q,
                                            long long n, L (&v)[kPer]) {
  if (VEC && q + kPer <= n) {
    constexpr int kVec = 16 / (int)sizeof(L);
#pragma unroll
    for (int i = 0; i < kPer; i += kVec) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(src + q + i));
      memcpy(&v[i], &raw, 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[i] = q + i < n ? src[q + i] : L(-1);
  }
}

// One round: lane `lane` adds 1 at `cell` (-1: no pair).  A round whose
// pairs all fall in one cell joins the warp's pending add (`pend_cell`,
// `pend`: the same in every lane) while the cell repeats; the caller
// flushes it.
__device__ __forceinline__ void warp_add(int* slab, int lane, int cell, int& pend_cell,
                                         int& pend) {
  const unsigned live = __ballot_sync(kFull, cell >= 0);
  if (live == 0u) return;
  const int lo = __reduce_min_sync(kFull, cell >= 0 ? cell : kNone);
  const int hi = __reduce_max_sync(kFull, cell);
  if (lo == hi) {  // every pair of the round in one cell
    if (lo != pend_cell) {
      if (pend_cell >= 0 && lane == 0) atomicAdd(slab + pend_cell, pend);
      pend_cell = lo;
      pend = 0;
    }
    pend += __popc(live);
    return;
  }
  const int next = __shfl_down_sync(kFull, cell, 1);
  if (__any_sync(kFull, cell >= 0 && lane < 31 && next == cell)) {
    const unsigned peers = __match_any_sync(kFull, cell);
    if (cell >= 0 && lane == __ffs(peers) - 1) atomicAdd(slab + cell, __popc(peers));
  } else if (cell >= 0) {
    atomicAdd(slab + cell, 1);
  }
}

template <typename LT, typename LP, bool VEC>
__global__ void __launch_bounds__(kThreads)
cm_slab_kernel(const LT* __restrict__ target, const LP* __restrict__ pred, long long n,
               int w, int* __restrict__ slab) {
  const int lane = threadIdx.x & 31;
  const long long tiles = (n + kTile - 1) / kTile;
  // The loop bound is the warp's, so all 32 lanes reach the votes together.
  for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); tile < tiles;
       tile += (long long)gridDim.x * kWarps) {
    const long long q = tile * kTile + lane * kPer;
    LT tv[kPer];
    LP pv[kPer];
    load_labels<VEC>(target, q, n, tv);
    load_labels<VEC>(pred, q, n, pv);
    int pend_cell = -1, pend = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool ok = (unsigned long long)(long long)tv[i] < (unsigned long long)w &&
                      (unsigned long long)(long long)pv[i] < (unsigned long long)w;
      warp_add(slab, lane, ok ? (int)tv[i] * w + (int)pv[i] : -1, pend_cell, pend);
    }
    if (pend_cell >= 0 && lane == 0) atomicAdd(slab + pend_cell, pend);
  }
}

template <typename LT, typename LP>
cudaError_t launch(bool vec, int blocks, const void* target, const void* pred, long long n,
                   int w, int* slab, cudaStream_t stream) {
  const LT* t = static_cast<const LT*>(target);
  const LP* p = static_cast<const LP*>(pred);
  if (vec) {
    cm_slab_kernel<LT, LP, true><<<blocks, kThreads, 0, stream>>>(t, p, n, w, slab);
  } else {
    cm_slab_kernel<LT, LP, false><<<blocks, kThreads, 0, stream>>>(t, p, n, w, slab);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u; }

}  // namespace

// target, pred: (n,) contiguous labels, each int32 (wide 0) or int64
// (wide 1); slab: (w, w) int32, zeroed by the caller; w * w < 2^31.  The
// plan (ops/cm.py::slab_plan): vec (16-byte label loads: both vectors
// 16-byte aligned), blocks.  A plan the operands do not allow is refused
// with cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
extern "C" int cm_slab_launch(const void* target, int target_wide, const void* pred,
                              int pred_wide, long long n, int w, int vec, int blocks,
                              void* slab, void* stream) {
  if (blocks < 1 || (vec && !(aligned16(target) && aligned16(pred)))) {
    return (int)cudaErrorInvalidValue;
  }
  int* out = static_cast<int*>(slab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (target_wide) {
    err = pred_wide ? launch<long long, long long>(vec, blocks, target, pred, n, w, out, st)
                    : launch<long long, int>(vec, blocks, target, pred, n, w, out, st);
  } else {
    err = pred_wide ? launch<int, long long>(vec, blocks, target, pred, n, w, out, st)
                    : launch<int, int>(vec, blocks, target, pred, n, w, out, st);
  }
  return (int)err;
}
