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
// Design.  A block owns G rows and a chunk of queries, with 256 threads:
//   * G = 32 when the rows are adjacent in memory (stride_row == 1, the
//     multiclass (N, C) layout): a warp's lanes are 32 rows of one sample,
//     so each warp load is one 128-byte line;
//   * G = 1 otherwise (contiguous rows, the binary (R, N) layout): the
//     lanes walk consecutive queries of one row.
// The G tables (and G negated tables) are staged in shared memory, entry
// k of row g at [k * G + g], so lanes at the same k hit distinct banks.
// Each query is an upper_bound binary search: ceil(log2(cap)) compares.
// Past the shared-memory budget (pinned caps can be huge: only
// cap * N < 2^29 binds them) the same kernel reads the tables from global
// memory instead (template SMEM = false).  Partial counts reduce by warp
// shuffles (G = 1) or across warps through shared memory (G = 32), then
// one integer atomicAdd per row per block: integer addition commutes, so
// the result is bit-exact whatever order the blocks finish in.
//
// Bound on the H100: bytes.  The queries are read once (the headline
// (2^17, 1000) f32 buffer: 512 MiB, ~0.16 ms at 3.35 TB/s); the tables
// and the output are tiny.  The searches cost 2 * 8 compares per query at
// cap 256, far under the f32 rate; shared-memory bank conflicts between
// lanes at different search depths are what this simple design leaves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // queries per block
constexpr int kDefaultSmem = 48 * 1024;
// H100 per-block opt-in limit, less the kernel's static reduction buffer.
constexpr int kMaxSmem = 232448 - 2 * kThreads * (int)sizeof(int);

template <int G, bool SMEM>
__device__ __forceinline__ float table_at(const float* smem, const float* gtab,
                                          int cap, int g, int k) {
  if (SMEM) return smem[k * G + g];
  return gtab[(long long)g * cap + k];
}

// #{table[k] <= x} for an ascending table of `cap` entries: a branchless
// upper_bound over power-of-two steps.
template <int G, bool SMEM>
__device__ __forceinline__ int count_le(const float* smem, const float* gtab,
                                        int cap, int top, int g, float x) {
  int lo = 0;
  for (int step = top; step > 0; step >>= 1) {
    int probe = lo + step;
    if (probe <= cap && table_at<G, SMEM>(smem, gtab, cap, g, probe - 1) <= x) {
      lo = probe;
    }
  }
  return lo;
}

template <int G, bool SMEM>
__global__ void __launch_bounds__(kThreads)
rank_sum_kernel(const float* __restrict__ queries, long long stride_row,
                long long stride_col, int rq, int n,
                const float* __restrict__ tables, int cap, int negate,
                int top, int* __restrict__ out) {
  extern __shared__ float smem[];  // [G * cap] tables, then [G * cap] negated
  __shared__ int red[2][kThreads];

  const int tid = threadIdx.x;
  const int g = tid % G;           // row within the block's group
  const int slot = tid / G;        // query slot
  constexpr int kSlots = kThreads / G;
  const int row0 = (int)blockIdx.x * G;
  const int row = row0 + g;
  const bool live = row < rq;

  const float* gtab_a = tables + (long long)row0 * cap;
  const float* gtab_b = tables + (long long)(row0 + rq) * cap;
  float* stab_a = smem;
  float* stab_b = smem + G * cap;
  if (SMEM) {
    for (int i = tid; i < G * cap; i += kThreads) {
      int gg = i / cap, k = i % cap;
      if (row0 + gg < rq) {
        stab_a[k * G + gg] = gtab_a[(long long)gg * cap + k];
        if (negate) stab_b[k * G + gg] = gtab_b[(long long)gg * cap + k];
      }
    }
    __syncthreads();
  }

  int acc_a = 0, acc_b = 0;
  if (live) {
    const float* qrow = queries + (long long)row * stride_row;
    const int q_end = min(n, ((int)blockIdx.y + 1) * kChunk);
    for (int q = (int)blockIdx.y * kChunk + slot; q < q_end; q += kSlots) {
      float x = qrow[(long long)q * stride_col];
      acc_a += count_le<G, SMEM>(stab_a, gtab_a, cap, top, g, x);
      if (negate) acc_b += count_le<G, SMEM>(stab_b, gtab_b, cap, top, g, -x);
    }
  }

  if (G == 1) {
    for (int d = 16; d > 0; d >>= 1) {
      acc_a += __shfl_down_sync(0xffffffffu, acc_a, d);
      acc_b += __shfl_down_sync(0xffffffffu, acc_b, d);
    }
    if ((tid & 31) == 0) {
      red[0][tid >> 5] = acc_a;
      red[1][tid >> 5] = acc_b;
    }
    __syncthreads();
    if (tid == 0 && live) {
      int sa = 0, sb = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        sa += red[0][w];
        sb += red[1][w];
      }
      atomicAdd(out + row, sa);
      if (negate) atomicAdd(out + rq + row, sb);
    }
  } else {
    red[0][tid] = acc_a;
    red[1][tid] = acc_b;
    __syncthreads();
    if (slot == 0 && live) {
      int sa = 0, sb = 0;
      for (int s = 0; s < kSlots; ++s) {
        sa += red[0][s * G + g];
        sb += red[1][s * G + g];
      }
      atomicAdd(out + row, sa);
      if (negate) atomicAdd(out + rq + row, sb);
    }
  }
}

template <int G>
cudaError_t launch(const float* queries, long long stride_row,
                   long long stride_col, int rq, int n, const float* tables,
                   int cap, int negate, int* out, cudaStream_t stream) {
  int top = 1;
  while (top * 2 <= cap) top *= 2;
  dim3 grid((rq + G - 1) / G, (n + kChunk - 1) / kChunk);
  long long smem = (long long)G * cap * (negate ? 2 : 1) * sizeof(float);
  if (smem <= kMaxSmem) {
    if (smem > kDefaultSmem) {
      cudaError_t err = cudaFuncSetAttribute(
          rank_sum_kernel<G, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    rank_sum_kernel<G, true><<<grid, kThreads, (size_t)smem, stream>>>(
        queries, stride_row, stride_col, rq, n, tables, cap, negate, top, out);
  } else {
    rank_sum_kernel<G, false><<<grid, kThreads, 0, stream>>>(
        queries, stride_row, stride_col, rq, n, tables, cap, negate, top, out);
  }
  return cudaGetLastError();
}

}  // namespace

// `out` must hold zeros (rq ints, or 2 * rq with `negate`): the blocks add
// into it.  Returns cudaGetLastError() after the launch.
extern "C" int rank_sum_counts_launch(const void* queries, long long stride_row,
                                      long long stride_col, int rq, int n,
                                      const void* tables, int cap, int negate,
                                      void* out, void* stream) {
  const float* q = static_cast<const float*>(queries);
  const float* t = static_cast<const float*>(tables);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = stride_row == 1 && rq > 1
      ? launch<32>(q, stride_row, stride_col, rq, n, t, cap, negate, o, s)
      : launch<1>(q, stride_row, stride_col, rq, n, t, cap, negate, o, s);
  return (int)err;
}
