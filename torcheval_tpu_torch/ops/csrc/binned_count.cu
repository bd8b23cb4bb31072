// Per-threshold prediction counts of the binned AUROC / AUPRC / PR-curve
// family: the per-bin (total, hit) histogram under their update.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_binned.py::_binned_count_kernel
// (entry binned_counts).  For rows of scores s[r][i] with hit flags h[r][i]
// and an ascending threshold grid t[0..T), it counts, as exact integers,
//
//     k(x)         = #{ j : t[j] <= x }   in [0, T]   (NaN: T)
//     hist[r][k]   = (#{ i : k(s[r][i]) = k } << 32) | #{ ... and h[r][i] }
//
// one 64-bit word a (row, slot): the total in the high half, the hits in
// the low half (each < 2^31, so the halves never carry into each other,
// here or in the wrapper's suffix sum over the slots).
// Slot 0 holds the scores below t[0] (and masked -inf ones); slot j + 1 is
// bin j, the scores with t[j] <= x < t[j+1].  A NaN score counts at every
// threshold, as the sort formulation orders it, so it goes to slot T, as
// does +inf.  The wrapper's suffix sum over the packed slots gives
// num_tp[r][j] = #{ i : s >= t[j], hit } and num_fp, and at slot 0 the
// row's hits, num_pos.
//
// The TPU kernel one-hot encoded each sample's coarse block and fine
// threshold through bf16 MXU gathers, with a finite pad sentinel and an
// f32 accumulator exact below 2^24 samples a row, to avoid scatters, which
// serialize on a TPU.  None of that is carried over: here each sample is
// one upper_bound over the thresholds and one atomic.
//
// Design.  A block owns G rows and a chunk of 4096 samples, 256 threads,
// as rank_sum.cu: G = 32 when the score rows are adjacent in memory
// (stride_row == 1, the multiclass (N, C) buffer read as (C, N) in place;
// a warp's lanes are 32 classes of one sample), G = 1 otherwise (a warp's
// lanes are 32 consecutive samples of one row).  Scores and hits take any
// strides.  The thresholds are staged in shared memory (10 000 f32 =
// 40 KB; up to 58 112 fit), or read from global memory past that.  Each
// sample adds (1 << 32) | hit to its slot with one 64-bit atomicAdd into
// the global histogram ((T + 1) x 8 B a row, 80 KB at T = 10 000, resident
// in L2).  With G = 1 the lanes of a warp that fall in the same slot merge
// first (__match_any_sync; the group's lowest lane adds the group's count
// and its hits), so scores that all sit in one bin cost one atomic a warp,
// not 32 to one address.  Integer adds commute: the counts are bit-exact
// in any block order.
//
// Bound on the H100: bytes.  At the binned lifecycle's (1, 2^19) update the
// kernel reads 2 MiB of scores and 0.5 MiB of hits, ~0.8 us at 3.35 TB/s,
// so the launch costs more than the traffic; past that, the 2^19 atomics.

#include <cuda_runtime.h>

#include "count_le.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // samples per block and row
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // H100 per-block opt-in limit
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

template <int G, bool SMEM>
__global__ void __launch_bounds__(kThreads)
binned_count_kernel(const float* __restrict__ scores, long long s_row,
                    long long s_col, const unsigned char* __restrict__ hits,
                    long long h_row, long long h_col, int rows, int n,
                    const float* __restrict__ thresholds, int t, int top,
                    unsigned long long* __restrict__ hist) {
  extern __shared__ float sth[];
  if (SMEM) {
    for (int i = threadIdx.x; i < t; i += kThreads) sth[i] = thresholds[i];
    __syncthreads();
  }
  const float* th = SMEM ? sth : thresholds;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid % G;     // row within the block's group
  const int slot = tid / G;  // sample slot
  constexpr int kSlots = kThreads / G;
  const int row = (int)blockIdx.x * G + g;
  const bool live = row < rows;
  const float* srow = scores + (long long)row * s_row;
  const unsigned char* hrow = hits + (long long)row * h_row;
  unsigned long long* out = hist + (long long)row * (t + 1);

  // Chunks past the grid's 65535 y-blocks loop (N < 2^31).
  for (long long c0 = (long long)blockIdx.y * kChunk; c0 < n;
       c0 += (long long)gridDim.y * kChunk) {
    const int q_end = (int)min((long long)n, c0 + kChunk);
    if (G == 1) {
      // The loop bound is the warp's, so all 32 lanes reach the match
      // together; lanes past the chunk carry no slot.
      for (int q0 = (int)c0 + (tid & ~31); q0 < q_end; q0 += kThreads) {
        const int q = q0 + lane;
        int k = -1;
        bool hit = false;
        if (live && q < q_end) {
          const float x = srow[(long long)q * s_col];
          k = x != x ? t : count_le<1>(th, t, top, x);
          hit = hrow[(long long)q * h_col] != 0;
        }
        const unsigned peers = __match_any_sync(kFull, k);
        const unsigned hit_lanes = __ballot_sync(kFull, hit);
        if (k >= 0 && lane == __ffs(peers) - 1) {
          atomicAdd(out + k, ((unsigned long long)__popc(peers) << 32) |
                                 (unsigned)__popc(peers & hit_lanes));
        }
      }
    } else if (live) {
      for (int q = (int)c0 + slot; q < q_end; q += kSlots) {
        const float x = srow[(long long)q * s_col];
        const int k = x != x ? t : count_le<1>(th, t, top, x);
        const unsigned hit = hrow[(long long)q * h_col] != 0;
        atomicAdd(out + k, (1ULL << 32) | hit);
      }
    }
  }
}

template <int G>
cudaError_t launch(const float* scores, long long s_row, long long s_col,
                   const unsigned char* hits, long long h_row, long long h_col,
                   int rows, int n, const float* thresholds, int t,
                   unsigned long long* hist, cudaStream_t stream) {
  const int top = top_step(t);
  const int chunks = (int)(((long long)n + kChunk - 1) / kChunk);
  dim3 grid((rows + G - 1) / G, chunks < kMaxGridY ? chunks : kMaxGridY);
  const long long smem = (long long)t * (long long)sizeof(float);
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          binned_count_kernel<G, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    binned_count_kernel<G, true><<<grid, kThreads, (size_t)smem, stream>>>(
        scores, s_row, s_col, hits, h_row, h_col, rows, n, thresholds, t, top,
        hist);
  } else {
    binned_count_kernel<G, false><<<grid, kThreads, 0, stream>>>(
        scores, s_row, s_col, hits, h_row, h_col, rows, n, thresholds, t, top,
        hist);
  }
  return cudaGetLastError();
}

}  // namespace

// scores: (rows, n) f32 and hits: (rows, n) bytes (0 = miss), each at any
// strides; thresholds: (t,) f32, contiguous, ascending, t >= 1; hist:
// (rows, t + 1) uint64, zeroed by the caller (the blocks add into it).
// Returns cudaGetLastError() after the launch.
extern "C" int binned_count_launch(const void* scores, long long s_row,
                                   long long s_col, const void* hits,
                                   long long h_row, long long h_col, int rows,
                                   int n, const void* thresholds, int t,
                                   void* hist, void* stream) {
  const float* s = static_cast<const float*>(scores);
  const unsigned char* h = static_cast<const unsigned char*>(hits);
  const float* th = static_cast<const float*>(thresholds);
  unsigned long long* out = static_cast<unsigned long long*>(hist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = s_row == 1 && rows > 1
      ? launch<32>(s, s_row, s_col, h, h_row, h_col, rows, n, th, t, out, st)
      : launch<1>(s, s_row, s_col, h, h_row, h_col, rows, n, th, t, out, st);
  return (int)err;
}
