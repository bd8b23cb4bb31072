// Weighted per-threshold sums of the sharded binned AUROC / AP histograms.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_binned.py::_binned_wcount_kernel
// (entry binned_weighted_counts).  For rows of scores s[r][i] with hit flags
// h[r][i], one weight vector w[i] shared by every row, and an ascending
// threshold grid t[0..T), it computes in f32
//
//     k(x)         = #{ j : t[j] <= x }   in [0, T]   (NaN: T)
//     tp[r][k]     = sum of w[i] over { i : k(s[r][i]) = k, h[r][i] }
//     fp[r][k]     = sum of w[i] over { i : k(s[r][i]) = k, !h[r][i] }
//     w_tp[r][j]   = sum over k > j of tp[r][k]   (= sum of w.hit over s >= t[j])
//     w_fp[r][j]   = the same over fp  (summed directly, not total - tp)
//     w_pos[r]     = sum over all k of tp[r][k]
//
// The slot rule is binned_count.cu's (count_le.cuh): NaN and +inf go to
// slot T, so a NaN counts at every threshold; -inf and scores below t[0]
// go to slot 0.  (The TPU kernel counts a NaN at no threshold; the port
// keeps its own rule so that this kernel and the unweighted one agree.)
//
// Contracts:
//   * unit weights: bitwise equal to binned_count.cu's counts cast to f32,
//     while every per-threshold count is below 2^24 (the sums are integers,
//     exact in f32 in any order; pallas_binned.py:245-251 states the same
//     bound for the TPU kernel);
//   * any other weights: |kernel - plain| <= 1e-6 * (sum of |w| over the
//     samples that reach the cell), for any N < 2^31: from the f32 weights
//     on, the kernel sums every slot in f64 (32-lane groups, a warp's
//     rounds, the block's warps, the row's ranges) and rounds each slot's
//     sum once to f32, as the plain version
//     (ops/binned.py::_binned_weighted_counts_plain) does with its f64
//     index_add_; both then run the suffix sum in f64 and round once.  So
//     the two differ by the f64 grouping (~N x 2^-53 of the sum) and a rare
//     double rounding, a few f32 ulps of the cell.  (An f32 histogram
//     drifts with the samples a warp adds to one slot: with a constant
//     weight that f32 cannot sum exactly, a few thousand of them pass 1e-6
//     of the sum.)
//   * two launches on one input give identical bits: no float is ever added
//     in arrival order (no float atomics anywhere).
//
// The TPU kernel one-hot encoded each sample's coarse block and fine
// threshold through MXU gathers (a threshold table with a finite sentinel,
// 128-lane tiles) and carried each weight as three exact bf16 components
// (w3, with a 2^-100 gate).  None of that is carried over.
//
// Design (deterministic).  Pass 1: a block of W warps owns either one row
// and a range of samples (the warps take turns over it, 32 samples a warp
// a round), or, when the rows are adjacent in memory (the multiclass (N, C)
// buffer read as (C, N) in place), W rows and a range of samples, a warp a
// row.  Each warp keeps a private (tp, fp) histogram of 2 (T + 1) f64.
// A sample adds its weight to one cell, its slot in the tp half or the fp
// half.  In a round, lanes whose samples share a cell (__match_any_sync)
// sum their weights in lane order through shuffles, and the group's lowest
// lane adds that sum into the warp's histogram: a warp's histogram grows
// in a fixed order.  The match is dear, and rare slots rarely collide, so
// where shared memory has room for it each warp also keeps a (T + 1) int
// tag array: a round first checks through it that its slots are all
// distinct, and then each lane adds its own sample, the same sums the
// match gives.
// The block then sums its warps' histograms in warp order into one f64
// partial per (row, sample range) in global memory.  Pass 2: a thread a
// slot sums a row's partials in range order, then a block a row rounds
// each slot to f32 and runs the suffix sums from slot T down
// (_suffix_cumsum, pallas_binned.py:81) over fixed chunks of the slots in
// f64, rounding once.  Shared memory holds the W histograms, their tags
// and the thresholds, 213 KB at T = 2048, W = 5; W shrinks for larger T,
// the tags go first (past T = 9 684), and past T = 11 621 (one histogram
// and the thresholds over 227 KB) the warps' histograms live in a zeroed
// global scratch instead, one per (row, range, warp), summed by pass 2 in
// (range, warp) order.  Scratch: rows x ranges x 2 (T + 1) f64 (x W on
// the global path of the one-row layout); the wrapper sizes it.
//
// Bound on the H100: bytes.  At the (1000, 2^17) x 2048 shape the kernel
// reads 524 MB of f32 scores, 131 MB of hits and 0.5 MB of weights and
// writes 16 MB, ~0.20 ms at 3.35 TB/s.  Each sample's slot is guessed from
// the grid's ends and walked to (slot_of), not searched for.  Few warps an
// SM (the private histograms fill shared memory) is what this simple design
// leaves.

#include <cuda_runtime.h>

#include "count_le.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kUnroll = 8;  // samples a lane has in flight
constexpr int kWalk = 4;    // steps from the guessed slot before a search
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // H100 per-block opt-in limit
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

// One round of 32 samples of one warp.  A sample adds its weight to one
// cell of the warp's histogram: its slot in the tp half for a hit, in the
// fp half (t1 further on) for a miss.  Lanes whose samples share a cell
// are merged in lane order, then the group's lowest lane adds the sum.
// From the f32 weights on, everything is summed in f64.
__device__ __forceinline__ void warp_add(double* hist, int lane, int cell,
                                         float w) {
  // Lanes without a sample carry a cell of their own (-1 - lane), so they
  // match nobody and add nothing.
  const unsigned peers = __match_any_sync(kFull, cell);
  double sum = w;
  if (__any_sync(kFull, peers != (1u << lane))) {
    sum = 0.0;
    for (int l = 0; l < 32; ++l) {
      const float a = __shfl_sync(kFull, w, l);
      if ((peers >> l) & 1u) sum += a;
    }
  }
  if (cell >= 0 && lane == __ffs(peers) - 1) hist[cell] += sum;
}

// The same round, with a cheap test first: each lane with a sample writes
// its lane id at its slot of the warp's tag array and reads it back; only
// when some lane reads another's (two samples share a slot) does the round
// take warp_add's match and merge, which cost far more than the test.  With
// every slot of the round distinct, each lane adds its own sample: the same
// sums warp_add gives for groups of one.  The tags need no reset: each
// round writes every slot it reads.
__device__ __forceinline__ void warp_add_tagged(double* hist, int* tag,
                                                int lane, int k, int cell,
                                                float w) {
  if (k >= 0) tag[k] = lane;
  __syncwarp();
  const bool shared_slot = k >= 0 && tag[k] != lane;
  if (__any_sync(kFull, shared_slot)) {
    warp_add(hist, lane, cell, w);
  } else if (k >= 0) {
    hist[cell] += w;
  }
  __syncwarp();
}

// The slot of a score, #{ j : t[j] <= x } (NaN: T), exactly as count_le
// gives it.  The guess interpolates between the grid's ends, then walks to
// the count: one or two probes on a near-uniform grid (the linspace and
// bisected grids of the binned metrics) instead of log2(T) dependent ones;
// a grid far from uniform runs out of steps and takes the binary search.
// `scale` is (T - 1) / (t[T-1] - t[0]), 0 when T = 1 or the ends are equal.
__device__ __forceinline__ int slot_of(const float* th, int t, int top,
                                       float lo, float scale, float x) {
  if (x != x) return t;
  if (scale == 0.0f) return count_le<1>(th, t, top, x);
  if (!(x >= lo)) return 0;
  const float g = (x - lo) * scale;
  int k = g < (float)(t - 1) ? (int)g + 1 : t;  // >= 1, as x >= t[0]
  for (int step = 0; step < kWalk; ++step) {
    if (th[k - 1] > x) {
      --k;
    } else if (k < t && th[k] <= x) {
      ++k;
    } else {
      return k;
    }
  }
  return count_le<1>(th, t, top, x);
}

// One group of kUnroll samples a lane, lane's first at q, the next `step`
// further on: score, weight and hit; a sample past q_end (or of a row past
// the last) reads nothing and weighs 0.
__device__ __forceinline__ void load_group(
    const float* __restrict__ srow, long long s_col,
    const unsigned char* __restrict__ hrow, long long h_col,
    const float* __restrict__ weights, bool live, long long q, long long step,
    long long q_end, float* x, float* w, bool* h) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u, q += step) {
    const bool valid = live && q < q_end;
    x[u] = valid ? srow[q * s_col] : 0.0f;
    w[u] = valid ? weights[q] : 0.0f;
    h[u] = valid && hrow[q * h_col] != 0;
  }
}

// ROW_WARPS: the warps of a block each own a row (adjacent rows in memory);
// else they share the block's one row.  SMEM_HIST: the warps' histograms in
// shared memory (else in the zeroed global scratch).  TAGS: each warp also
// has a (T + 1) int tag array there (warp_add_tagged).  SMEM_THR:
// thresholds staged in shared memory.
template <bool ROW_WARPS, bool SMEM_HIST, bool TAGS, bool SMEM_THR>
__global__ void wcount_partial_kernel(
    const float* __restrict__ scores, long long s_row, long long s_col,
    const unsigned char* __restrict__ hits, long long h_row, long long h_col,
    const float* __restrict__ weights, int rows, int n,
    const float* __restrict__ thresholds, int t, int top, int per_range,
    double* __restrict__ scratch) {
  // Shared memory: the warps' f64 histograms, then their int tags, then
  // the f32 thresholds.
  extern __shared__ double smem[];
  const int t1 = t + 1;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* tags = reinterpret_cast<int*>(smem + (SMEM_HIST ? warps * 2 * t1 : 0));
  float* sth = reinterpret_cast<float*>(tags + (TAGS ? warps * t1 : 0));
  if (SMEM_THR) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) sth[i] = thresholds[i];
  }
  const float* th = SMEM_THR ? sth : thresholds;
  const float lo = thresholds[0], hi = thresholds[t - 1];
  const float scale = t > 1 && hi > lo ? (float)(t - 1) / (hi - lo) : 0.0f;

  const int row = ROW_WARPS ? (int)blockIdx.x * warps + warp : (int)blockIdx.x;
  const int range = (int)blockIdx.y;
  const int ranges = (int)gridDim.y;
  // This warp's histogram: in shared memory, or its own scratch slice
  // (row, range, warp); ROW_WARPS has one warp a (row, range).
  double* hist;
  if (SMEM_HIST) {
    hist = smem + warp * 2 * t1;
    for (int i = lane; i < 2 * t1; i += 32) hist[i] = 0.0;
  } else {
    const long long part = ROW_WARPS
        ? (long long)row * ranges + range
        : ((long long)row * ranges + range) * warps + warp;
    hist = scratch + part * 2 * t1;
  }
  __syncthreads();

  const bool live = row < rows;
  const float* srow = scores + (long long)row * s_row;
  const unsigned char* hrow = hits + (long long)row * h_row;
  const long long q_begin = (long long)range * per_range;
  const long long q_end = min((long long)n, q_begin + per_range);
  // The warps that share a row take turns: warp v's rounds start at
  // q_begin + 32 v and step by 32 x (the warps on the row).
  const long long step = 32LL * (ROW_WARPS ? 1 : warps);
  const long long group = step * kUnroll;
  // Loads run one group ahead of the binning (two register buffers), so a
  // warp always has kUnroll samples a lane in flight while it bins the last.
  float x[kUnroll], w[kUnroll];
  bool h[kUnroll];
  long long q0 = q_begin + 32LL * (ROW_WARPS ? 0 : warp);
  load_group(srow, s_col, hrow, h_col, weights, live, q0 + lane, step, q_end, x,
             w, h);
  // The loop bound is the warp's own, so all 32 lanes reach every
  // __match_any_sync together.
  for (; q0 < q_end; q0 += group) {
    float nx[kUnroll], nw[kUnroll];
    bool nh[kUnroll];
    load_group(srow, s_col, hrow, h_col, weights, live, q0 + group + lane, step,
               q_end, nx, nw, nh);
    int k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = live && q0 + u * step + lane < q_end;
      k[u] = valid ? slot_of(th, t, top, lo, scale, x[u]) : -1 - lane;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int cell = k[u] < 0 || h[u] ? k[u] : k[u] + t1;
      if (TAGS) {
        warp_add_tagged(hist, tags + warp * t1, lane, k[u], cell, w[u]);
      } else {
        warp_add(hist, lane, cell, w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = nx[u];
      w[u] = nw[u];
      h[u] = nh[u];
    }
  }

  if (!SMEM_HIST) return;
  __syncthreads();
  // The block's partial for each of its rows: the warps' histograms summed
  // in warp order (one warp a row under ROW_WARPS: a copy).
  const int block_rows = ROW_WARPS ? warps : 1;
  for (int g = 0; g < block_rows; ++g) {
    const int r = ROW_WARPS ? (int)blockIdx.x * warps + g : row;
    if (r >= rows) break;
    double* out = scratch + ((long long)r * ranges + range) * 2 * t1;
    for (int i = threadIdx.x; i < 2 * t1; i += blockDim.x) {
      double acc = smem[(ROW_WARPS ? g : 0) * 2 * t1 + i];
      if (!ROW_WARPS) {
        for (int v = 1; v < warps; ++v) acc += smem[v * 2 * t1 + i];
      }
      out[i] = acc;
    }
  }
}

// Pass 2a: each thread sums one slot of one row over the row's `parts`
// partial histograms, in part order, into the first.
__global__ void wcount_reduce_kernel(double* __restrict__ scratch, int t,
                                     int parts) {
  const int t2 = 2 * (t + 1);
  const int i = (int)blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= t2) return;
  double* base = scratch + (long long)blockIdx.x * parts * t2;
  double acc = base[i];
  for (int p = 1; p < parts; ++p) acc += base[(long long)p * t2 + i];
  base[i] = acc;
}

// Pass 2b, one block of kSuffixThreads a row: the suffix sums from slot T
// down, in f64, each rounded once to f32.  Thread i owns a contiguous chunk
// of the slots of each half (tp, fp): it sums its chunk, one thread a half
// turns the chunk sums into the sum of every chunk above, top down, and
// each thread then runs its chunk's suffix from that offset.  A fixed
// partition, so the same bits every run; in f64, so the grouping moves no
// f32 result but by a rare double rounding (an f32 running sum would round
// once a slot, ~sqrt(T) ulps of the row's total apart from the plain
// version).  The row's slots are staged in shared memory first
// (coalesced) when they fit.
constexpr int kSuffixThreads = 256;

template <bool STAGE>
__global__ void __launch_bounds__(kSuffixThreads)
wcount_suffix_kernel(const double* __restrict__ scratch, int t, int parts,
                     float* __restrict__ w_tp, float* __restrict__ w_fp,
                     float* __restrict__ w_pos) {
  extern __shared__ float staged[];
  __shared__ double above[2][kSuffixThreads];
  const int t1 = t + 1;
  const long long row = blockIdx.x;
  const double* base = scratch + row * parts * 2 * t1;
  // Each slot's f64 sum is rounded once to f32 as it is read, as the plain
  // version rounds its per-slot sums.
  if (STAGE) {
    for (int i = threadIdx.x; i < 2 * t1; i += kSuffixThreads) staged[i] = (float)base[i];
    __syncthreads();
  }
  auto slot = [&](int i) -> double {
    return STAGE ? (double)staged[i] : (double)(float)base[i];
  };
  const int per = (t1 + kSuffixThreads - 1) / kSuffixThreads;
  const int lo = min(t1, (int)threadIdx.x * per);
  const int hi = min(t1, lo + per);
  for (int half = 0; half < 2; ++half) {
    double sum = 0.0;
    for (int k = lo; k < hi; ++k) sum += slot(half * t1 + k);
    above[half][threadIdx.x] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    const int half = threadIdx.x == 0 ? 0 : 1;
    double acc = 0.0;
    for (int c = kSuffixThreads - 1; c >= 0; --c) {
      const double chunk = above[half][c];
      above[half][c] = acc;
      acc += chunk;
    }
  }
  __syncthreads();
  for (int half = 0; half < 2; ++half) {
    float* out = (half == 0 ? w_tp : w_fp) + row * t;
    double acc = above[half][threadIdx.x];
    for (int k = hi - 1; k >= lo; --k) {
      acc += slot(half * t1 + k);
      if (k >= 1) {
        out[k - 1] = (float)acc;
      } else if (half == 0) {
        w_pos[row] = (float)acc;
      }
    }
  }
}

template <bool ROW_WARPS, bool SMEM_HIST, bool TAGS, bool SMEM_THR>
cudaError_t launch_partial(dim3 grid, int threads, size_t smem,
                           cudaStream_t stream, const float* s, long long s_row,
                           long long s_col, const unsigned char* h,
                           long long h_row, long long h_col, const float* w,
                           int rows, int n, const float* th, int t, int top,
                           int per_range, double* scratch) {
  auto kernel = wcount_partial_kernel<ROW_WARPS, SMEM_HIST, TAGS, SMEM_THR>;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(s, s_row, s_col, h, h_row, h_col, w,
                                          rows, n, th, t, top, per_range,
                                          scratch);
  return cudaGetLastError();
}

template <bool ROW_WARPS>
cudaError_t launch_rows(int warps, int smem_hist, int ranges, int per_range,
                        cudaStream_t stream, const float* s, long long s_row,
                        long long s_col, const unsigned char* h,
                        long long h_row, long long h_col, const float* w,
                        int rows, int n, const float* th, int t,
                        double* scratch) {
  const int top = top_step(t);
  const int row_blocks = ROW_WARPS ? (rows + warps - 1) / warps : rows;
  const dim3 grid(row_blocks, ranges);
  const long long thr_bytes = (long long)t * sizeof(float);
  const long long hist_bytes = (long long)warps * 2 * (t + 1) * sizeof(double);
  const long long tag_bytes = (long long)warps * (t + 1) * sizeof(int);
  if (smem_hist == 2) {
    if (hist_bytes + tag_bytes + thr_bytes > kMaxSmem) return cudaErrorInvalidValue;
    return launch_partial<ROW_WARPS, true, true, true>(
        grid, warps * 32, (size_t)(hist_bytes + tag_bytes + thr_bytes), stream,
        s, s_row, s_col, h, h_row, h_col, w, rows, n, th, t, top, per_range,
        scratch);
  }
  if (smem_hist == 1) {
    if (hist_bytes + thr_bytes > kMaxSmem) return cudaErrorInvalidValue;
    return launch_partial<ROW_WARPS, true, false, true>(
        grid, warps * 32, (size_t)(hist_bytes + thr_bytes), stream, s, s_row,
        s_col, h, h_row, h_col, w, rows, n, th, t, top, per_range, scratch);
  }
  if (thr_bytes <= kMaxSmem) {
    return launch_partial<ROW_WARPS, false, false, true>(
        grid, warps * 32, (size_t)thr_bytes, stream, s, s_row, s_col, h, h_row,
        h_col, w, rows, n, th, t, top, per_range, scratch);
  }
  return launch_partial<ROW_WARPS, false, false, false>(
      grid, warps * 32, 0, stream, s, s_row, s_col, h, h_row, h_col, w, rows, n,
      th, t, top, per_range, scratch);
}

}  // namespace

// scores: (rows, n) f32 and hits: (rows, n) bytes (0 = miss), each at any
// strides; weights: (n,) f32, contiguous; thresholds: (t,) f32, contiguous,
// ascending, t >= 1; rows, n >= 1.  The wrapper plans the launch: `warps`
// (1..8) a block, `row_warps` (a warp a row, for rows adjacent in memory),
// `smem_hist` (2: the warps' histograms and tag arrays in shared memory;
// 1: the histograms only; 0: the histograms in the scratch), `ranges` sample
// ranges of `per_range` samples a row (ranges * per_range >= n, ranges <=
// 65535), and `scratch`: rows * parts * 2 (t + 1) f32, parts = ranges, or
// ranges * warps on the global path of the one-row layout, zeroed by the
// caller on the global path.  Outputs: w_tp, w_fp (rows, t) and w_pos
// (rows,) f32, every element written.  Returns cudaGetLastError() after
// the launches (cudaErrorInvalidValue for a plan that does not fit).
extern "C" int binned_wcount_launch(const void* scores, long long s_row,
                                    long long s_col, const void* hits,
                                    long long h_row, long long h_col,
                                    const void* weights, int rows, int n,
                                    const void* thresholds, int t, int warps,
                                    int row_warps, int smem_hist, int ranges,
                                    int per_range, void* scratch, void* w_tp,
                                    void* w_fp, void* w_pos, void* stream) {
  if (warps < 1 || warps > kMaxWarps || ranges < 1 || ranges > kMaxGridY ||
      (long long)ranges * per_range < n || rows < 1 || t < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const float* s = static_cast<const float*>(scores);
  const unsigned char* h = static_cast<const unsigned char*>(hits);
  const float* w = static_cast<const float*>(weights);
  const float* th = static_cast<const float*>(thresholds);
  double* sc = static_cast<double*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = row_warps
      ? launch_rows<true>(warps, smem_hist, ranges, per_range, st, s, s_row,
                          s_col, h, h_row, h_col, w, rows, n, th, t, sc)
      : launch_rows<false>(warps, smem_hist, ranges, per_range, st, s, s_row,
                           s_col, h, h_row, h_col, w, rows, n, th, t, sc);
  if (err != cudaSuccess) return (int)err;
  const int parts = (!row_warps && !smem_hist) ? ranges * warps : ranges;
  if (parts > 1) {
    const dim3 grid(rows, (2 * (t + 1) + 255) / 256);
    wcount_reduce_kernel<<<grid, 256, 0, st>>>(sc, t, parts);
  }
  float* tp = static_cast<float*>(w_tp);
  float* fp = static_cast<float*>(w_fp);
  float* pos = static_cast<float*>(w_pos);
  const long long staged = 2LL * (t + 1) * (long long)sizeof(float);
  // Beside the static 2 x kSuffixThreads doubles of chunk sums.
  const long long room = kMaxSmem - 2LL * kSuffixThreads * (long long)sizeof(double);
  if (staged <= room) {
    if (staged > kDefaultSmem - 2LL * kSuffixThreads * (long long)sizeof(double)) {
      err = cudaFuncSetAttribute(wcount_suffix_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)staged);
      if (err != cudaSuccess) return (int)err;
    }
    wcount_suffix_kernel<true><<<rows, kSuffixThreads, (size_t)staged, st>>>(
        sc, t, parts, tp, fp, pos);
  } else {
    wcount_suffix_kernel<false><<<rows, kSuffixThreads, 0, st>>>(sc, t, parts,
                                                                 tp, fp, pos);
  }
  return (int)cudaGetLastError();
}
