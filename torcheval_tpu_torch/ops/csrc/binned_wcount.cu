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
//     exact in any order; pallas_binned.py:245-251 states the same bound
//     for the TPU kernel);
//   * any other weights: |kernel - plain| <= 1e-6 * (sum of |w| over the
//     samples that reach the cell), for any N < 2^31 (the plain version,
//     ops/binned.py::_binned_weighted_counts_plain, sums each slot in f64,
//     rounds it once to f32 and runs the suffix sum in f64);
//   * two launches on one input give identical bits.
//
// The TPU kernel one-hot encoded each sample's coarse block and fine
// threshold through MXU gathers (a threshold table with a finite sentinel,
// 128-lane tiles) and carried each weight as three exact bf16 components
// (w3, with a 2^-100 gate).  None of that is carried over.
//
// Two routes; the wrapper (ops/binned.py::binned_weighted_counts) picks one
// from the weights' range, and counts each launch under its own name.
//
// Fixed point (binned_wcount_fixed_launch; LAUNCHES["binned_weighted_counts"]).
// Every weight becomes the int64 round(w / q), q = 2^e a power of two the
// wrapper takes from max |w| and N so that no cell of a row can reach 2^62
// in magnitude (N max|w| < 2^62 q).  It takes this route when every weight
// is finite and the smallest nonzero |w| is at least 2^21 q, so a sample's
// rounding is at most 2^-22 |w| (2.4e-7): the cells' error stays within the
// contract beside the f32 roundings of the slot and the suffix.  Over that
// range an f32 weight with no bits below q, unit and integer weights among
// them, converts exactly.  The wrapper reads max |w| and the smallest
// finite nonzero |w| back from one pass of wcount_range_kernel.
// Deterministic because integer sums are exact in any order: threads add
// their samples into the block's histogram with 64-bit shared-memory
// atomics, blocks add theirs into the row's histogram with 64-bit global
// atomics, and whatever the order the cells hold the same integers.
// Pass 1: a block of 512 threads owns one row, a range of samples (grid y)
// and a window of the slots (grid z: the slots are cut in windows only
// where one row's 2 (T + 1) int64 pass shared memory, as at T = 16 384;
// each window's block bins every sample and adds those in its window).
// Its histogram is 32.8 KB at T = 2048 against the f64 route's 41 KB a
// warp: four blocks of 16 warps fit an SM (64 warps, where the f64 route
// held 5), each thread with kFixedUnroll samples in flight, a block's
// consecutive loads neighbouring (coalesced).  The grid takes the rows
// fastest, so the blocks resident together read neighbouring rows over the
// same samples: in the (N, C) buffer read as (C, N) in place, a 32-byte
// sector holds eight neighbouring classes, comes from DRAM once and from
// L2 for the other seven.  (Blocks of 2, 4 and 8 neighbouring classes, a
// warp reading whole sector pieces, were slower: their histograms left 1
// or 2 blocks an SM.)  The launch aims at a block an SM: each block zeroes
// and flushes a whole histogram window.  Pass 2: a block a row rounds each
// slot's integer times q once to f32 (through f64) and runs the same f64
// suffix sums as the f64 route.
//
// f64 (binned_wcount_launch; LAUNCHES["binned_weighted_counts_f64"]): any
// other weights (a NaN or infinite weight, or a range past 2^21 q).  From
// the f32 weights on, the kernel sums every slot in f64 (32-lane groups, a
// warp's rounds, the block's warps, the row's ranges) and rounds each
// slot's sum once to f32, as the plain version does; the two differ by the
// f64 grouping (~N x 2^-53 of the sum) and a rare double rounding.
// Deterministic because no float is ever added in arrival order (no float
// atomics anywhere).  (An f32 histogram drifts with the samples a warp adds
// to one slot: with a constant weight that f32 cannot sum exactly, a few
// thousand of them pass 1e-6 of the sum.)
//
// Design of the f64 route.  Pass 1: a block of W warps owns either one
// row and a range of samples (the warps take turns over it, 32 samples a
// warp a round), or, when the rows are adjacent in memory (the multiclass (N, C)
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
// the grid's ends and walked to (count_le.cuh's slot_of), not searched
// for.  The f64 route, this kernel's first design, holds 5 warps an SM
// (its private f64 histograms fill shared memory), 5 x 32 lanes x 8
// samples in flight, and reads the (C, N) class view a class a warp, 32
// sectors a load: its pass
// 1 moves those 656 MB in ~3.6 ms on the H100.  The fixed-point route keeps
// 64 warps an SM; what holds it back now is its 64-bit shared-memory
// atomics (a 32-bit add in their place, wrong sums but the same loads,
// runs ~0.2 ms faster at that shape).  The f64 route is kept as it was.

#include <cuda_runtime.h>

#include "count_le.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kUnroll = 8;  // samples a lane has in flight (f64 route)
constexpr int kFixedUnroll = 4;  // the same for the fixed-point route
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

// The weights' range, for the wrapper's choice of route, in one pass:
// bits[0] = the largest |w| as f32 bits (NaN above inf above every finite
// value: the bits of a non-negative float order as the float does), bits[1]
// = 0x7f800000 minus the bits of the smallest finite nonzero |w| (0 when
// there is none).  Integer maxima: the same result in any order.
__global__ void wcount_range_kernel(const float* __restrict__ w, long long n,
                                    unsigned* __restrict__ bits) {
  unsigned hi = 0u, lo = 0u;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned b = __float_as_uint(w[i]) & 0x7fffffffu;
    hi = max(hi, b);
    if (b != 0u && b < 0x7f800000u) lo = max(lo, 0x7f800000u - b);
  }
  hi = __reduce_max_sync(kFull, hi);
  lo = __reduce_max_sync(kFull, lo);
  if ((threadIdx.x & 31) == 0) {
    atomicMax(bits, hi);
    atomicMax(bits + 1, lo);
  }
}

// The fixed-point route's pass 1: a block owns one row (grid x), a range
// of samples (grid y) and a window of the slots (grid z).  Shared memory:
// the block's histogram, (tp window, fp window) int64, then the f32
// thresholds when SMEM_THR.  Thread i takes the range's samples i, i +
// 512, ...; the block then adds its histogram's nonzero cells into `hist`,
// rows x 2 (T + 1) int64, zeroed by the caller.
constexpr int kFixedThreads = 512;

template <bool SMEM_THR>
__global__ void __launch_bounds__(kFixedThreads)
wcount_fixed_kernel(const float* __restrict__ scores, long long s_row, long long s_col,
                    const unsigned char* __restrict__ hits, long long h_row,
                    long long h_col, const float* __restrict__ weights, int n,
                    const float* __restrict__ thresholds, int t, int top, double scale,
                    int window, int per_range, unsigned long long* __restrict__ hist) {
  extern __shared__ unsigned long long cells[];
  const int t1 = t + 1;
  float* sth = reinterpret_cast<float*>(cells + 2 * window);
  for (int i = threadIdx.x; i < 2 * window; i += blockDim.x) cells[i] = 0ull;
  if (SMEM_THR) {
    for (int i = threadIdx.x; i < t; i += blockDim.x) sth[i] = thresholds[i];
  }
  const float* th = SMEM_THR ? sth : thresholds;
  const float lo = thresholds[0], hi = thresholds[t - 1];
  const float th_scale = t > 1 && hi > lo ? (float)(t - 1) / (hi - lo) : 0.0f;
  __syncthreads();

  const long long row = blockIdx.x;
  const int k_lo = (int)blockIdx.z * window;
  const int k_hi = min(t1, k_lo + window);
  const long long q_end = min((long long)n, (long long)blockIdx.y * per_range + per_range);
  const long long step = blockDim.x;
  const float* srow = scores + row * s_row;
  const unsigned char* hrow = hits + row * h_row;
  for (long long q0 = (long long)blockIdx.y * per_range + threadIdx.x; q0 < q_end;
       q0 += step * kFixedUnroll) {
    float x[kFixedUnroll], w[kFixedUnroll];
    bool h[kFixedUnroll];
#pragma unroll
    for (int u = 0; u < kFixedUnroll; ++u) {
      const long long q = q0 + u * step;
      const bool valid = q < q_end;
      x[u] = valid ? srow[q * s_col] : 0.0f;
      w[u] = valid ? weights[q] : 0.0f;  // a zero weight adds nothing
      h[u] = valid && hrow[q * h_col] != 0;
    }
#pragma unroll
    for (int u = 0; u < kFixedUnroll; ++u) {
      if (w[u] == 0.0f) continue;
      const int k = slot_of(th, t, top, lo, th_scale, x[u]);
      if (k < k_lo || k >= k_hi) continue;
      const long long wq = __double2ll_rn((double)w[u] * scale);
      atomicAdd(&cells[(h[u] ? 0 : window) + (k - k_lo)], (unsigned long long)wq);
    }
  }
  __syncthreads();
  unsigned long long* out = hist + row * 2 * t1;
  for (int i = threadIdx.x; i < 2 * window; i += blockDim.x) {
    const unsigned long long v = cells[i];
    const int half = i / window, k = k_lo + i % window;
    if (v != 0ull && k < k_hi) atomicAdd(&out[half * t1 + k], v);
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

// A slot's sum rounded once to f32: an f64 sum, or an int64 fixed-point
// sum times its quantum (a power of two, so only the int64 -> f64 and the
// f64 -> f32 conversions round).
__device__ __forceinline__ float slot_f32(const double* p, long long i, double) {
  return (float)p[i];
}
__device__ __forceinline__ float slot_f32(const long long* p, long long i, double quantum) {
  return (float)((double)p[i] * quantum);
}

template <bool STAGE, typename Src>
__global__ void __launch_bounds__(kSuffixThreads)
wcount_suffix_kernel(const Src* __restrict__ scratch, int t, int parts, double quantum,
                     float* __restrict__ w_tp, float* __restrict__ w_fp,
                     float* __restrict__ w_pos) {
  extern __shared__ float staged[];
  __shared__ double above[2][kSuffixThreads];
  const int t1 = t + 1;
  const long long row = blockIdx.x;
  const Src* base = scratch + row * parts * 2 * t1;
  // Each slot's sum is rounded once to f32 as it is read, as the plain
  // version rounds its per-slot sums.
  if (STAGE) {
    for (int i = threadIdx.x; i < 2 * t1; i += kSuffixThreads) {
      staged[i] = slot_f32(base, i, quantum);
    }
    __syncthreads();
  }
  auto slot = [&](int i) -> double {
    return STAGE ? (double)staged[i] : (double)slot_f32(base, i, quantum);
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

// Pass 2b: the suffix sums of each row's first histogram (pass 2a has
// summed the row's other partials into it).
template <typename Src>
cudaError_t launch_suffix(const Src* sc, int t, int parts, double quantum, int rows,
                          float* tp, float* fp, float* pos, cudaStream_t st) {
  const long long staged = 2LL * (t + 1) * (long long)sizeof(float);
  // Beside the static 2 x kSuffixThreads doubles of chunk sums.
  const long long room = kMaxSmem - 2LL * kSuffixThreads * (long long)sizeof(double);
  if (staged <= room) {
    if (staged > kDefaultSmem - 2LL * kSuffixThreads * (long long)sizeof(double)) {
      cudaError_t err = cudaFuncSetAttribute(wcount_suffix_kernel<true, Src>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)staged);
      if (err != cudaSuccess) return err;
    }
    wcount_suffix_kernel<true, Src><<<rows, kSuffixThreads, (size_t)staged, st>>>(
        sc, t, parts, quantum, tp, fp, pos);
  } else {
    wcount_suffix_kernel<false, Src><<<rows, kSuffixThreads, 0, st>>>(sc, t, parts, quantum,
                                                                       tp, fp, pos);
  }
  return cudaGetLastError();
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
  return (int)launch_suffix(sc, t, parts, 1.0, rows, static_cast<float*>(w_tp),
                            static_cast<float*>(w_fp), static_cast<float*>(w_pos), st);
}

// The fixed-point route.  scores, hits, weights, thresholds, rows, n, t and
// the outputs as binned_wcount_launch; every weight finite.  scale = 1 / q
// and quantum = q, q a power of two with n x max|w| < 2^62 q.  The wrapper
// plans `window` slots a block (splits = ceil((t + 1) / window) <= 65535),
// `ranges` sample ranges of `per_range` samples (ranges * per_range >= n,
// ranges <= 65535) and whether the thresholds go to shared memory
// (`smem_thr`); hist: rows x 2 (t + 1) int64, zeroed by the caller.
// Returns cudaGetLastError() after the launches (cudaErrorInvalidValue for
// a plan that does not fit).
extern "C" int binned_wcount_fixed_launch(
    const void* scores, long long s_row, long long s_col, const void* hits,
    long long h_row, long long h_col, const void* weights, int rows, int n,
    const void* thresholds, int t, double scale, double quantum, int window, int ranges,
    int per_range, int smem_thr, void* hist, void* w_tp, void* w_fp, void* w_pos,
    void* stream) {
  const int splits = window < 1 ? 0 : (t + window) / window;  // ceil((t + 1) / window)
  const long long smem = 16LL * window + (smem_thr ? 4LL * t : 0);
  if (window < 1 || splits > kMaxGridY || ranges < 1 || ranges > kMaxGridY ||
      (long long)ranges * per_range < n || rows < 1 || t < 1 || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = smem_thr ? wcount_fixed_kernel<true> : wcount_fixed_kernel<false>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // Rows fastest: the blocks resident together read neighbouring rows over
  // the same samples, so a strided (C, N) class view's sectors, shared by
  // eight neighbouring classes, come from DRAM once and from L2 after.
  const dim3 grid(rows, ranges, splits);
  kernel<<<grid, kFixedThreads, (size_t)smem, st>>>(
      static_cast<const float*>(scores), s_row, s_col, static_cast<const unsigned char*>(hits),
      h_row, h_col, static_cast<const float*>(weights), n,
      static_cast<const float*>(thresholds), t, top_step(t), scale, window, per_range,
      static_cast<unsigned long long*>(hist));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_suffix(static_cast<const long long*>(hist), t, 1, quantum, rows,
                            static_cast<float*>(w_tp), static_cast<float*>(w_fp),
                            static_cast<float*>(w_pos), st);
}

// weights: (n,) f32, n >= 1; bits: 2 x uint32 (see wcount_range_kernel),
// zeroed here.  Returns cudaGetLastError() after the launch.
extern "C" int binned_wcount_range_launch(const void* weights, long long n, void* bits,
                                          void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bits, 0, 2 * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + 255) / 256 < 528 ? (n + 255) / 256 : 528;  // 4 an SM
  wcount_range_kernel<<<(int)blocks, 256, 0, st>>>(static_cast<const float*>(weights), n,
                                                    static_cast<unsigned*>(bits));
  return (int)cudaGetLastError();
}
