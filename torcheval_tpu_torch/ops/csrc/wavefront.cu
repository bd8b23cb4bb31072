// Batched token-level Levenshtein distance by an anti-diagonal sweep.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_wavefront.py::
// _wavefront_kernel (entry _edit_distance_pallas).  For each pair r it
// computes the edit distance between a[r, :a_lens[r]] and b[r, :b_lens[r]]
// as an exact int32.
//
// Every cell of the DP matrix on the anti-diagonal d = i + j depends only on
// the diagonals d-1 and d-2, so a diagonal is data-parallel:
//
//     D[i, j] = min(D[i-1, j] + 1, D[i, j-1] + 1, D[i-1, j-1] + (a[i-1] != b[j-1]))
//     D[i, 0] = i,  D[0, j] = j
//
// The TPU kernel advanced the whole padded bucket one diagonal per grid
// step, to the bucket's La + Lb + 1, with pairs on sublanes padded to 8 and
// ids on lanes padded to 128, a pre-shifted copy of `a` with a -1 sentinel,
// a rolling reversed copy of `b`, out-of-matrix lanes poisoned with 2^30 and
// a one-hot capture accumulator that a lane sum read back.  All of that is
// TPU layout, and none of it is carried over.
//
// Design.  One thread block per pair.  The pair's real ids (never a pad)
// and three rolling diagonals, indexed by the DP row i, live in shared
// memory.  On diagonal d the block's threads take the rows lo..hi that the
// diagonal crosses inside THIS pair's (a_len + 1) x (b_len + 1) matrix (a
// strided loop where they are more than the block), one __syncthreads()
// ends the diagonal, and the sweep stops at the pair's own a_len + b_len: a
// ragged batch costs its own cells, not the bucket's.  Every read of a
// non-boundary cell lands inside the matrix, so nothing needs a poison
// value; a[i-1] is read only for i <= a_len and b[j-1] only for j <= b_len,
// so pad values cannot matter.  Thread 0 writes D[a_len, b_len].
//
// Widths whose buffers (3 (La + 1) + La + Lb ints) pass the 227 KB of shared
// memory a block can have take the same sweep with the diagonals in a
// global-memory scratch the wrapper allocates, a fixed number of blocks
// striding over the pairs, and the ids read from global memory in place.
//
// Bound on the H100: operations.  A cell needs five integer operations (a
// compare, two adds, two mins), and the card issues 132 SMs x 64 int32
// lanes x 1.98 GHz = 16.7e12 of them a second (half the 33.5 TOPS of the
// Hopper white paper, which counts a multiply-add as two).  The bytes, n x
// (La + Lb) x 4 read once, take less time than that from a few tokens a
// pair on.  This first version is far from the bound: a diagonal costs a
// block barrier whatever its length, and short pairs leave most of a block
// idle.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr size_t kMaxShared = 232448;  // 227 KB: the most a block can opt into
constexpr size_t kDefaultShared = 48 * 1024;

template <bool kShared>  // the diagonals and ids in shared memory, or not
__global__ void wavefront_kernel(const int* __restrict__ a, const int* __restrict__ b,
                                 const int* __restrict__ a_lens,
                                 const int* __restrict__ b_lens, int n, int wa, int wb,
                                 int* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int row = wa + 1;  // a diagonal has at most wa + 1 cells
  int* const diag = kShared ? smem : scratch + (size_t)blockIdx.x * 3 * row;
  int* const sa = smem + 3 * row;
  int* const sb = sa + wa;
  const int tid = threadIdx.x;

  for (int r = blockIdx.x; r < n; r += gridDim.x) {
    const int la = min(max(a_lens[r], 0), wa);
    const int lb = min(max(b_lens[r], 0), wb);
    const int* ar = a + (size_t)r * wa;
    const int* br = b + (size_t)r * wb;
    if (kShared) {
      for (int i = tid; i < la; i += blockDim.x) sa[i] = ar[i];
      for (int j = tid; j < lb; j += blockDim.x) sb[j] = br[j];
      ar = sa;
      br = sb;
      __syncthreads();
    }
    int* cur = diag;
    int* p1 = diag + row;      // diagonal d - 1: p1[i] = D[i, d - 1 - i]
    int* p2 = diag + 2 * row;  // diagonal d - 2: p2[i] = D[i, d - 2 - i]
    for (int d = 0; d <= la + lb; ++d) {
      const int lo = max(0, d - lb), hi = min(d, la);
      for (int i = lo + tid; i <= hi; i += blockDim.x) {
        int v = d;  // the first row (i = 0) and the first column (i = d)
        if (i != 0 && i != d) {
          const int sub = ar[i - 1] != br[d - i - 1];
          v = min(min(p1[i - 1], p1[i]) + 1, p2[i - 1] + sub);
        }
        cur[i] = v;
      }
      // Ends the diagonal: its cells are visible to the block, and the
      // reads of p2 are done before the next diagonal overwrites it.
      __syncthreads();
      int* const oldest = p2;
      p2 = p1;
      p1 = cur;
      cur = oldest;
    }
    if (tid == 0) out[r] = p1[la];  // D[la, lb], on the last diagonal
    __syncthreads();  // before the next pair reuses the buffers
  }
}

}  // namespace

// a: (n, wa) int32, b: (n, wb) int32, contiguous; a_lens, b_lens, out: (n,)
// int32; n >= 1.  scratch is null when the buffers fit a block's shared
// memory (one block per pair), else scratch_blocks x 3 x (wa + 1) int32 for
// scratch_blocks blocks.  Returns the first CUDA error, or
// cudaGetLastError() after the launch.
extern "C" int wavefront_launch(const void* a, const void* b, const void* a_lens,
                                const void* b_lens, int n, int wa, int wb,
                                void* scratch, int scratch_blocks, void* out,
                                void* stream) {
  const int span = (wa < wb ? wa : wb) + 1;  // the longest diagonal
  int threads = (span + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  size_t shared = 0;
  int blocks = scratch_blocks;
  if (scratch == nullptr) {
    shared = (3 * ((size_t)wa + 1) + (size_t)wa + (size_t)wb) * sizeof(int);
    if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
    if (shared > kDefaultShared) {
      cudaError_t err = cudaFuncSetAttribute(
          wavefront_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
      if (err != cudaSuccess) return (int)err;
    }
    blocks = n;
  }
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  auto kernel = scratch == nullptr ? wavefront_kernel<true> : wavefront_kernel<false>;
  kernel<<<blocks, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<const int*>(a_lens), static_cast<const int*>(b_lens), n, wa, wb,
      static_cast<int*>(scratch), static_cast<int*>(out));
  return (int)cudaGetLastError();
}
