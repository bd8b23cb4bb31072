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
// Design.  A grid-stride loop over samples: each warp reads 32 consecutive
// (t, p) pairs (two coalesced 128-byte loads) and adds them into the int32
// slab in global memory with atomicAdd.  Counts are integers, so the order
// of the atomics cannot change the result, and the slab is bit-equal to
// the plain PyTorch version.  At C = 1000 the slab is 4 MiB: past the
// 227 KB of shared memory a block can have, but resident in the 50 MB L2,
// where the atomics land.  Lanes of a warp that hold the same cell are
// merged first (__match_any_sync; the group's lowest lane adds the group's
// size), so skewed labels, worst of all every sample in one cell, send at
// most one atomic per warp and cell instead of 32 to one address.  A label
// outside [0, C] is skipped: the wrapper raises on such labels, and the
// kernel never writes outside the slab even when that check is off.
//
// Bound on the H100: bytes.  8 B read per sample plus the slab written
// once ((C+1)^2 x 4 B, zeroed by the wrapper).  At the lifecycle's shape
// (2^17 samples, C = 1000) that is 1 MiB + 4 MiB, about 1.6 us at
// 3.35 TB/s, so a launch costs more than the traffic there.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // 2^20 threads a pass; more loop instead
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
cm_slab_kernel(const int* __restrict__ target, const int* __restrict__ pred,
               long long n, int w, int* __restrict__ slab) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  // The loop bound is the warp's, not the lane's, so all 32 lanes reach
  // the warp-wide match together; lanes past n carry no cell.
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    int cell = -1;
    if (i < n) {
      const int t = target[i], p = pred[i];
      if ((unsigned)t < (unsigned)w && (unsigned)p < (unsigned)w) {
        cell = t * w + p;  // < w^2 < 2^31, checked by the wrapper
      }
    }
    const unsigned peers = __match_any_sync(kFull, cell);
    if (cell >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(slab + cell, __popc(peers));
    }
  }
}

}  // namespace

// target, pred: (n,) int32, contiguous; slab: (w, w) int32, zeroed by the
// caller; w * w < 2^31.  Returns cudaGetLastError() after the launch.
extern "C" int cm_slab_launch(const void* target, const void* pred,
                              long long n, int w, void* slab, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  cm_slab_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(target), static_cast<const int*>(pred), n, w,
      static_cast<int*>(slab));
  return (int)cudaGetLastError();
}
