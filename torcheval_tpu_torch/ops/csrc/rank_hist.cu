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
// Bounds on the H100, at the headline ((2^17, 1000) f32 scores read as the
// strided (1000, 2^17) view, cap 256): bytes, the 524 MB of scores read
// once, 0.157 ms at 3.35 TB/s; and issue, 1.31e8 searches of 9 dependent
// shared-memory steps of at least 3 instructions plus a shared-memory atomic
// a query, 0.11 ms.  What bounds a plain loop (one load, one search, the
// next load) is latency; the design is rank_sum.cu's, which hides it:
//   * query tiles in flight: a ring of four 8 KiB tiles in shared memory
//     filled by cp.async, 16 bytes a copy where the view allows it, 4 bytes
//     otherwise (query_ring.cuh), three tiles in flight while one is searched;
//   * searches in flight: each lane runs the searches of 8 queries of its
//     row interleaved (count_le_shared), three instructions a step at the
//     route's caps (guarded steps at others), the live slots a count so the
//     predicates stay free;
//   * tables staged once a block: a persistent grid, blocks_per_group
//     blocks a row group, each walking every blocks_per_group-th tile.
// Layouts: G = 32 rows a block when the rows are adjacent in memory
// (stride_row == 1), G = 1 otherwise.  The G tables and a private G x cap
// int32 histogram live in shared memory, both entry-major ([v * G + g]), so
// the lanes of a warp, one row each, hit distinct banks.  A query's bin is
// one shared-memory atomicAdd; at the end each block adds its nonzero (row,
// bin) counts into the global histogram with one integer atomicAdd each.
// Integer addition commutes, so the result is bit-exact in any block
// order.  Past the shared-memory budget (pinned caps are bounded only by
// cap * N < 2^29) the searches read the tables from global memory and add
// straight into the global histogram (SMEM = false, guarded steps).

#include <cuda_runtime.h>

#include "count_le.cuh"
#include "query_ring.cuh"

namespace {

using namespace query_ring;

// TOP: the search form (count_le.cuh::with_top); shared-memory tables only.
template <int G, bool SMEM, int TOP>
__global__ void __launch_bounds__(kThreads, 2)
rank_hist_kernel(View v, const float* __restrict__ tables, int cap, int top,
                 int blocks_per_group, int vec16, int* __restrict__ hist) {
  extern __shared__ __align__(16) float smem[];  // ring, tables, counts
  float* ring = smem;
  float* stab = smem + kStages * kTileFloats;
  int* shist = reinterpret_cast<int*>(stab + G * cap);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = (int)blockIdx.x / blocks_per_group;
  const int row0 = group * G;
  const int rows = min(G, v.rq - row0);
  const int col = G == 32 ? lane : 0;  // this lane's table column
  const int row = min(row0 + col, v.rq - 1);

  if (SMEM) {
    stage_tables<G>(stab, tables, row0, rows, cap);
    for (int i = tid; i < G * cap; i += kThreads) shist[i] = 0;
  }
  const float* ta = SMEM ? stab + col : tables + (long long)row * cap;
  int* counts = SMEM ? shist + col : hist + (long long)row * cap;
  constexpr int S = SMEM ? G : 1;  // table and count stride
  const unsigned sta = SMEM ? (unsigned)__cvta_generic_to_shared(stab + col) : 0;

  walk_tiles<G>(ring, v, row0, (int)blockIdx.x % blocks_per_group, blocks_per_group,
                tiles_of<G>(v.n), vec16 != 0, [&](const float* tile, int t) {
    float x[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) x[i] = tile[(warp * kInFlight + i) * 32 + lane];
    int lo[kInFlight], unused[kInFlight];
    if constexpr (SMEM && TOP > 0) {
      count_le_shared<kInFlight, S, false, TOP>(sta, sta, x, lo, unused);
    } else {
      count_le_many<kInFlight, S, false>(ta, ta, cap, top, x, lo, unused);
    }
    const int live = live_slots<G>(v, row0, t, warp, lane);
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      if (i < live && lo[i] > 0) atomicAdd(counts + (lo[i] - 1) * S, 1);
    }
  });

  if (SMEM) {
    __syncthreads();
    for (int i = tid; i < G * cap; i += kThreads) {
      const int bin = i / G, g = i % G;
      const int c = shist[i];
      if (c != 0 && g < rows) atomicAdd(hist + (long long)(row0 + g) * cap + bin, c);
    }
  }
}

template <int G, bool SMEM, int TOP>
cudaError_t launch_one(const View& v, const float* tables, int cap, int top,
                       int blocks_per_group, int vec16, int* hist, cudaStream_t stream) {
  const int groups = (v.rq + G - 1) / G;
  const long long smem =
      kRingBytes + (SMEM ? 2LL * G * cap * (long long)sizeof(float) : 0);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(rank_hist_kernel<G, SMEM, TOP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  rank_hist_kernel<G, SMEM, TOP>
      <<<groups * blocks_per_group, kThreads, (size_t)smem, stream>>>(
          v, tables, cap, top, blocks_per_group, vec16, hist);
  return cudaGetLastError();
}

// fixed_top: the plan's search form, cap for fixed steps over tables in
// shared memory (a capacity of with_top), 0 for guarded steps.  A form
// the kernel lacks is refused, not replaced.
template <int G>
cudaError_t launch(const View& v, const float* tables, int cap, int smem_tables,
                   int fixed_top, int blocks_per_group, int vec16, int* hist,
                   cudaStream_t stream) {
  const int top = top_step(cap);
  if (fixed_top == 0) {
    return smem_tables ? launch_one<G, true, -1>(v, tables, cap, top, blocks_per_group, vec16,
                                                 hist, stream)
                       : launch_one<G, false, -1>(v, tables, cap, top, blocks_per_group,
                                                  vec16, hist, stream);
  }
  if (fixed_top != cap || !smem_tables) return cudaErrorInvalidValue;
  return with_top(cap, [&](auto form) -> cudaError_t {
    constexpr int TOP = decltype(form)::value;
    if constexpr (TOP < 0) {
      return cudaErrorInvalidValue;
    } else {
      return launch_one<G, true, TOP>(v, tables, cap, top, blocks_per_group, vec16, hist,
                                      stream);
    }
  });
}

}  // namespace

// queries: (rq, n) f32 at any strides; tables: (rq, cap) f32, contiguous,
// ascending; hist: (rq, cap) int32, zeroed by the caller (the blocks add
// into it).  The launch plan comes from the wrapper
// (ops/ustat.py::_rank_plan), as for rank_sum_counts_launch.  Returns
// cudaGetLastError() after the launch.
extern "C" int rank_hist_counts_launch(const void* queries, long long stride_row,
                                       long long stride_col, int rq, int n,
                                       const void* tables, int cap, int group_rows,
                                       int vec16, int smem_tables, int fixed_top,
                                       int blocks_per_group, void* hist, void* stream) {
  const View v{static_cast<const float*>(queries), stride_row, stride_col, rq, n};
  const float* t = static_cast<const float*>(tables);
  int* h = static_cast<int*>(hist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = group_rows == 32
      ? launch<32>(v, t, cap, smem_tables, fixed_top, blocks_per_group, vec16, h, s)
      : launch<1>(v, t, cap, smem_tables, fixed_top, blocks_per_group, vec16, h, s);
  return (int)err;
}
