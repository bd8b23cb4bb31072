// Rank histograms for the sort-free exact average precision (AUPRC) route.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_ustat.py::_rank_hist_kernel
// (entry rank_hist_counts).  Computes, as exact int32,
//
//     hist[r][v] = #{ q : count_le(tables[r], queries[r][q]) - 1 == v }
//
// the histogram of each query's bin, the largest table index v with
// tables[r][v] <= q.  A query below every entry (and a NaN query) falls in
// no bin.  The tables are ascending, `cap` entries a row, +BIG pads last.
//
// The TPU kernel one-hot encoded a coarse and a fine bin per query and
// accumulated their cross product on the MXU in f32, exact below 2^24
// queries a row.  None of that is carried over: here each query is one
// upper_bound and one integer increment, exact to N < 2^31.
//
// Design.  rank_sum.cu's layout: a block owns G rows and a chunk of 4096
// queries, 256 threads.
//   * G = 32 when the rows are adjacent in memory (stride_row == 1, the
//     (N, C) score buffer read as (C, N) in place): a warp's lanes are 32
//     rows of one sample, one 128-byte line a load;
//   * G = 1 otherwise: the lanes walk consecutive queries of one row.
// The G tables and a private G x cap int32 histogram live in shared memory
// (at cap 256 and G = 32: 32 KB each), both entry-major ([v * G + g]), so
// the lanes of a warp, one row each, hit distinct banks.  A query's bin is
// one shared-memory atomicAdd; at the end each block adds its nonzero
// (row, bin) counts into the global histogram with one integer atomicAdd
// each.  Integer addition commutes, so the result is bit-exact in any
// block order.  Past the shared-memory budget (pinned caps are bounded
// only by cap * N < 2^29) the same kernel reads the tables from global
// memory and adds straight into the global histogram (SMEM = false).
//
// Bound on the H100: bytes.  The queries are read once: the headline
// (2^17, 1000) f32 buffer is 512 MiB, ~0.16 ms at 3.35 TB/s; tables and
// histogram are ~1 MiB each.  The searches cost ceil(log2(cap)) compares a
// query, 8 at cap 256, far under the f32 rate; the flush costs at most
// G * cap atomics a block, ~8192 for 4096 * 32 queries.

#include <cuda_runtime.h>

#include "count_le.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // queries per block
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // H100 per-block opt-in limit
constexpr int kMaxGridY = 65535;

template <int G, bool SMEM>
__global__ void __launch_bounds__(kThreads)
rank_hist_kernel(const float* __restrict__ queries, long long stride_row,
                 long long stride_col, int rq, int n,
                 const float* __restrict__ tables, int cap, int top,
                 int* __restrict__ hist) {
  extern __shared__ float smem[];  // [G * cap] tables, then [G * cap] counts
  float* stab = smem;
  int* shist = reinterpret_cast<int*>(smem + G * cap);

  const int tid = threadIdx.x;
  const int g = tid % G;     // row within the block's group
  const int slot = tid / G;  // query slot
  constexpr int kSlots = kThreads / G;
  const int row0 = (int)blockIdx.x * G;
  const int row = row0 + g;
  const bool live = row < rq;
  const float* gtab = tables + (long long)row * cap;
  int* ghist = hist + (long long)row * cap;

  if (SMEM) {
    for (int i = tid; i < G * cap; i += kThreads) {
      const int gg = i / cap, k = i % cap;
      if (row0 + gg < rq) stab[k * G + gg] = tables[(long long)(row0 + gg) * cap + k];
      shist[i] = 0;
    }
    __syncthreads();
  }

  if (live) {
    const float* qrow = queries + (long long)row * stride_row;
    // Chunks past the grid's 65535 y-blocks loop (N < 2^31).
    for (long long c0 = (long long)blockIdx.y * kChunk; c0 < n;
         c0 += (long long)gridDim.y * kChunk) {
      const int q_end = (int)min((long long)n, c0 + kChunk);
      for (int q = (int)c0 + slot; q < q_end; q += kSlots) {
        const float x = qrow[(long long)q * stride_col];
        const int v = (SMEM ? count_le<G>(stab + g, cap, top, x)
                            : count_le<1>(gtab, cap, top, x)) - 1;
        if (v >= 0) {
          if (SMEM) {
            atomicAdd(shist + v * G + g, 1);
          } else {
            atomicAdd(ghist + v, 1);
          }
        }
      }
    }
  }

  if (SMEM) {
    __syncthreads();
    for (int i = tid; i < G * cap; i += kThreads) {
      const int v = i / G, gg = i % G;
      const int c = shist[i];
      if (c != 0 && row0 + gg < rq) {
        atomicAdd(hist + (long long)(row0 + gg) * cap + v, c);
      }
    }
  }
}

template <int G>
cudaError_t launch(const float* queries, long long stride_row,
                   long long stride_col, int rq, int n, const float* tables,
                   int cap, int* hist, cudaStream_t stream) {
  const int top = top_step(cap);
  const int chunks = (int)(((long long)n + kChunk - 1) / kChunk);
  dim3 grid((rq + G - 1) / G, chunks < kMaxGridY ? chunks : kMaxGridY);
  long long smem = 2LL * G * cap * (long long)sizeof(float);
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          rank_hist_kernel<G, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    rank_hist_kernel<G, true><<<grid, kThreads, (size_t)smem, stream>>>(
        queries, stride_row, stride_col, rq, n, tables, cap, top, hist);
  } else {
    rank_hist_kernel<G, false><<<grid, kThreads, 0, stream>>>(
        queries, stride_row, stride_col, rq, n, tables, cap, top, hist);
  }
  return cudaGetLastError();
}

}  // namespace

// queries: (rq, n) f32 at any strides; tables: (rq, cap) f32, contiguous,
// ascending; hist: (rq, cap) int32, zeroed by the caller (the blocks add
// into it).  Returns cudaGetLastError() after the launch.
extern "C" int rank_hist_counts_launch(const void* queries, long long stride_row,
                                       long long stride_col, int rq, int n,
                                       const void* tables, int cap, void* hist,
                                       void* stream) {
  const float* q = static_cast<const float*>(queries);
  const float* t = static_cast<const float*>(tables);
  int* h = static_cast<int*>(hist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = stride_row == 1 && rq > 1
      ? launch<32>(q, stride_row, stride_col, rq, n, t, cap, h, s)
      : launch<1>(q, stride_row, stride_col, rq, n, t, cap, h, s);
  return (int)err;
}
