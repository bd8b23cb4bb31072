// Rank-sum counts for the exact rank-sum (Mann-Whitney U) AUROC route.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_ustat.py::_rank_sum_kernel
// (entry rank_sum_counts).  Computes, as exact int32,
//
//     out[r] = sum_q #{ tables[r][k] <= x(r, q) },   x(r, q) = queries[r][q]
//
// and, with `negate`, ALSO the second half of a stacked call in the same
// pass: rows rq..2rq-1 of `tables`/`out` count against the negated queries,
// x(rq + r, q) = -queries[r][q].  So the AUROC's two passes read the scores
// once, and neither the (C, N) transpose nor the [q, -q] stack is ever
// materialized: the wrapper passes the (N, C) score buffer as a strided
// (C, N) view (stride_row = 1, stride_col = C).
//
// Bounds on the H100, at the headline ((2^17, 1000) f32 scores, cap 256,
// negate): bytes, the 524 MB of scores read once, 0.157 ms at 3.35 TB/s;
// and issue, 2 x 1.31e8 searches of 9 dependent shared-memory steps of at
// least 3 instructions (load, compare, predicated add), 0.21 ms at 132 SMs
// x 4 schedulers x 1.98 GHz, with about as many shared-memory wavefronts.
// A search step waits ~30 cycles on its load, and a query's load ~700 ns
// on device memory, so what bounds a plain loop (one load, then its
// searches, then the next load) is latency.  The design hides it, then
// trims the searches' instructions:
//   * query tiles in flight: a block walks its tiles through a ring of four
//     8 KiB tiles in shared memory (query_ring.cuh) filled by cp.async (16
//     bytes a copy where the view's base and pitch are 16-byte aligned, 4
//     bytes otherwise), three tiles in flight while the warps search one:
//     48 KiB in flight an SM at two blocks an SM;
//   * searches in flight: each lane takes 8 queries of its row from a tile
//     and runs their 8 (with `negate` 16) searches interleaved step by step
//     (count_le_shared), so independent shared-memory loads hide each
//     other.  A search keeps a 32-bit shared address, and at the route's
//     caps (16 .. 512, a power of two) its steps are fixed at compile time:
//     a load at the address plus a constant, a compare, a predicated add,
//     and no `probe <= cap` guard.  Which of a lane's slots hold a query is
//     a count (live_slots), so the predicate registers stay free for them;
//   * tables staged once a block: the grid is persistent, blocks_per_group
//     blocks a row group (about two blocks an SM in all), each walking every
//     blocks_per_group-th tile of its group with its tables in shared memory.
// Layouts: G = 32 rows a block when the rows are adjacent in memory
// (stride_row == 1, the multiclass (N, C) layout): a tile slot is one
// sample's 32 rows, a 128-byte line; G = 1 otherwise (contiguous rows, the
// binary (R, N) layout): a tile is 2048 consecutive queries of one row.
// Table entry k of row g sits at [k * G + g], so the lanes of a warp, one
// row each (G = 32), hit distinct banks.  Other caps, and the one-table form
// (no `negate`, which no route launches), take guarded steps; past the
// shared-memory budget (pinned caps are bounded only by
// cap * N < 2^29) the searches read the tables from global memory (SMEM =
// false, guarded steps).  Partial counts reduce across warps through shared
// memory (G = 32) or by warp shuffles (G = 1), then one integer atomicAdd a
// row a block: integer addition commutes, so the result is bit-exact
// whatever order the blocks finish in.

#include <cuda_runtime.h>
#include <stdint.h>

#include "count_le.cuh"
#include "query_ring.cuh"

namespace {

using namespace query_ring;

// The block's static shared memory: the cross-warp reduction buffer.
constexpr int kRedBytes = 2 * kWarps * 32 * (int)sizeof(int);

// TOP: the search form (count_le.cuh::with_top); shared-memory tables only.
template <int G, bool SMEM, int TOP, bool NEG>
__global__ void __launch_bounds__(kThreads, 2)
rank_sum_kernel(View v, const float* __restrict__ tables, int cap, int top,
                int blocks_per_group, int vec16, int* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];  // ring, tables, negated tables
  __shared__ int red[2][kWarps][32];
  static_assert(sizeof(red) == kRedBytes, "kRedBytes");

  float* ring = smem;
  float* stab_a = smem + kStages * kTileFloats;
  float* stab_b = stab_a + G * cap;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = (int)blockIdx.x / blocks_per_group;
  const int row0 = group * G;
  const int rows = min(G, v.rq - row0);
  const int col = G == 32 ? lane : 0;  // this lane's table column
  const int row = min(row0 + col, v.rq - 1);

  if (SMEM) {
    stage_tables<G>(stab_a, tables, row0, rows, cap);
    if (NEG) stage_tables<G>(stab_b, tables, v.rq + row0, rows, cap);
  }
  const float* ta = SMEM ? stab_a + col : tables + (long long)row * cap;
  const float* tb = SMEM ? stab_b + col : tables + (long long)(v.rq + row) * cap;
  constexpr int S = SMEM ? G : 1;  // table stride
  const unsigned sta = SMEM ? (unsigned)__cvta_generic_to_shared(stab_a + col) : 0;
  const unsigned stb = SMEM ? (unsigned)__cvta_generic_to_shared(stab_b + col) : 0;

  int acc_a = 0, acc_b = 0;
  walk_tiles<G>(ring, v, row0, (int)blockIdx.x % blocks_per_group, blocks_per_group,
                tiles_of<G>(v.n), vec16 != 0, [&](const float* tile, int t) {
    float x[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) x[i] = tile[(warp * kInFlight + i) * 32 + lane];
    int la[kInFlight], lb[kInFlight];
    if constexpr (SMEM && TOP > 0) {
      count_le_shared<kInFlight, S, NEG, TOP>(sta, stb, x, la, lb);
    } else {
      count_le_many<kInFlight, S, NEG>(ta, tb, cap, top, x, la, lb);
    }
    const int live = live_slots<G>(v, row0, t, warp, lane);
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      acc_a += i < live ? la[i] : 0;
      if (NEG) acc_b += i < live ? lb[i] : 0;
    }
  });

  if (G == 1) {
    for (int d = 16; d > 0; d >>= 1) {
      acc_a += __shfl_down_sync(0xffffffffu, acc_a, d);
      acc_b += __shfl_down_sync(0xffffffffu, acc_b, d);
    }
  }
  red[0][warp][lane] = acc_a;
  red[1][warp][lane] = acc_b;
  __syncthreads();
  if (warp == 0 && lane < rows) {
    int sa = 0, sb = 0;
    for (int w = 0; w < kWarps; ++w) {
      sa += red[0][w][lane];
      sb += red[1][w][lane];
    }
    atomicAdd(out + row0 + lane, sa);
    if (NEG) atomicAdd(out + v.rq + row0 + lane, sb);
  }
}

template <int G, bool SMEM, int TOP, bool NEG>
cudaError_t launch_one(const View& v, const float* tables, int cap, int top,
                       int blocks_per_group, int vec16, int* out, cudaStream_t stream) {
  const int groups = (v.rq + G - 1) / G;
  const long long smem =
      kRingBytes + (SMEM ? (long long)G * cap * (NEG ? 2 : 1) * (long long)sizeof(float) : 0);
  // The default allows 48 KiB in all, the static buffer included.
  if (smem + kRedBytes > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(rank_sum_kernel<G, SMEM, TOP, NEG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  rank_sum_kernel<G, SMEM, TOP, NEG>
      <<<groups * blocks_per_group, kThreads, (size_t)smem, stream>>>(
          v, tables, cap, top, blocks_per_group, vec16, out);
  return cudaGetLastError();
}

// fixed_top: the plan's search form, cap for fixed steps over tables in
// shared memory (the stacked form at a capacity of with_top), 0 for
// guarded steps.  A form the kernels lack is refused, not replaced.
template <int G>
cudaError_t launch(const View& v, const float* tables, int cap, int negate, int smem_tables,
                   int fixed_top, int blocks_per_group, int vec16, int* out,
                   cudaStream_t stream) {
  const int top = top_step(cap);
  if (fixed_top == 0) {
    if (smem_tables) {
      return negate ? launch_one<G, true, -1, true>(v, tables, cap, top, blocks_per_group,
                                                    vec16, out, stream)
                    : launch_one<G, true, -1, false>(v, tables, cap, top, blocks_per_group,
                                                     vec16, out, stream);
    }
    return negate ? launch_one<G, false, -1, true>(v, tables, cap, top, blocks_per_group,
                                                   vec16, out, stream)
                  : launch_one<G, false, -1, false>(v, tables, cap, top, blocks_per_group,
                                                    vec16, out, stream);
  }
  if (fixed_top != cap || !smem_tables || !negate) return cudaErrorInvalidValue;
  return with_top(cap, [&](auto form) -> cudaError_t {
    constexpr int TOP = decltype(form)::value;
    if constexpr (TOP < 0) {
      return cudaErrorInvalidValue;
    } else {
      return launch_one<G, true, TOP, true>(v, tables, cap, top, blocks_per_group, vec16, out,
                                            stream);
    }
  });
}

}  // namespace

// The launch plan comes from the wrapper (ops/ustat.py::_rank_plan):
// group_rows G (32 or 1), vec16 (16-byte copies), smem_tables (tables in
// shared memory), fixed_top (the search form) and blocks_per_group.  `out` must hold zeros (rq ints, or
// 2 * rq with `negate`): the blocks add into it.  Returns
// cudaGetLastError() after the launch.
extern "C" int rank_sum_counts_launch(const void* queries, long long stride_row,
                                      long long stride_col, int rq, int n,
                                      const void* tables, int cap, int negate,
                                      int group_rows, int vec16, int smem_tables,
                                      int fixed_top, int blocks_per_group, void* out,
                                      void* stream) {
  const View v{static_cast<const float*>(queries), stride_row, stride_col, rq, n};
  const float* t = static_cast<const float*>(tables);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      group_rows == 32
          ? launch<32>(v, t, cap, negate, smem_tables, fixed_top, blocks_per_group, vec16, o, s)
          : launch<1>(v, t, cap, negate, smem_tables, fixed_top, blocks_per_group, vec16, o, s);
  return (int)err;
}
