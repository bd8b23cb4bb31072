// Per-threshold prediction counts of the binned AUROC / AUPRC / PR-curve
// family: the per-bin (total, hit) histogram under their update, and its
// suffix sum.
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
// here or in the suffix sum over the slots).  Slot 0 holds the scores below
// t[0] (and masked -inf ones); slot j + 1 is bin j, the scores with
// t[j] <= x < t[j+1].  A NaN score counts at every threshold, as the sort
// formulation orders it, so it goes to slot T, as does +inf.  A second
// kernel of this file runs each row's suffix sum over the packed slots and
// writes num_tp[r][j] = #{ i : s >= t[j], hit }, num_fp, num_pos (the suffix
// sum at slot 0's hits) and num_total, all int32.
//
// The TPU kernel one-hot encoded each sample's coarse block and fine
// threshold through bf16 MXU gathers, with a finite pad sentinel and an
// f32 accumulator exact below 2^24 samples a row, to avoid scatters, which
// serialize on a TPU.  None of that is carried over: here each sample is
// one slot_of (count_le.cuh) and one 64-bit atomic into L2.
//
// Design of the count kernels.  The wrapper's plan (ops/binned.py::
// binned_count_plan) sizes the grid from the SM count: blocks of 16 warps,
// each warp walking warp tiles of 256 samples (grid-stride), 8 samples a
// lane whose loads are all issued before any slot is computed (a warp's
// first tile before the block stages its thresholds).  Layouts:
//   * G = 1 (a warp's lanes are samples of one row).  VEC: the rows are
//     contiguous and aligned, so lane l loads samples 4l .. 4l + 3 of each
//     128-sample half of the tile as one 16-byte float4 and one 4-byte word
//     of hits (a half's last partial group reads element by element);
//     otherwise lane l reads samples l, l + 32, .. at any strides.
//   * G = 32 (stride_row == 1: the multiclass (N, C) buffer read as (C, N)
//     in place): lane l owns row 32g + l and 8 consecutive samples, the
//     score loads coalesced over the lanes; VEC reads the lane's 8 hits as
//     one 8-byte word (hit rows contiguous and 8-byte aligned).
// The slot is slot_of's guess from the grid's ends (count_le.cuh), its two
// probes issued for all 8 samples together (slots_of), then slot_of's walk
// and binary search only where the guess misses, as on a grid far from
// uniform.  SMEM stages the thresholds in shared memory first; otherwise
// the probes read them through the read-only path, where the table stays
// in L1/L2.  Each sample then adds (1 << 32) | hit with one
// 64-bit atomicAdd (a RED) into the L2-resident histogram.  G = 1 takes the
// 32 samples of a round together: when every lane's slot is the same
// (__reduce_min_sync == __reduce_max_sync), the warp's count and its hits
// join a pending add that one lane makes when the slot changes or the tile
// ends, so scores that all sit in one bin cost one atomic a warp tile;
// when two neighbouring lanes share a slot (a skew), the round merges its
// lanes by slot (__match_any_sync) first; otherwise, as on spread scores,
// each lane adds its own sample with no match.  (Without the pending add,
// every score in one bin took 2x as long; without the match, scores in
// two bins 10x; spread scores the same either way: PERF.md.)  G = 32's
// lanes are distinct rows, so each lane merges runs of one slot among its
// own 8 samples.
// Integer adds commute: the counts are bit-exact in any block order.
//
// The private route (one row whose slots and thresholds fit in a block's
// shared memory, as the binned lifecycle's update and a binary rank block
// do) keeps the L2 out of the count: binned_private_kernel counts a
// histogram a block in shared memory and writes it whole, and
// binned_cell_suffix_kernel sums the blocks' copies a cell of 64 slots a
// block, so the call needs no zero fill and no global atomic.
//
// The suffix kernel splits each row into chunks of 1024 slots for a row
// that fits one, else of 2048, a block each: a block stages its chunk
// coalesced in shared memory and sums the slots above it on the way, each
// thread sums 8 consecutive slots, a warp shuffle scan and the warps' sums
// give each thread the sum above its slots, the suffix sums go back in
// place, then are unpacked and written coalesced.  The sums are integers,
// so any tree gives the same bits.
//
// Bound on the H100: bytes.  At the binned lifecycle's (1, 2^19) update the
// call reads 2 MiB of scores and 0.5 MiB of hits, ~0.8 us at 3.35 TB/s.
// On the L2 route what holds it far above that is the 2^19 atomics into
// an 80 KB histogram in L2 (PERF.md); the private route, which takes
// that update, avoids them and is held by the launches and its blocks'
// copies.

#include <cuda_runtime.h>

#include <cstdint>

#include "count_le.cuh"

namespace {

constexpr int kWarps = 16;               // warps a block of the count kernel
constexpr int kThreads = kWarps * 32;
constexpr int kPer = 8;                  // samples a lane has in flight
constexpr int kTile = 32 * kPer;         // samples a warp tile (G = 1)
constexpr int kHalf = kTile / 2;         // samples a float4 round of the warp
constexpr int kSuffixPer = 8;            // slots a thread of the suffix kernel
constexpr int kCell = 64;                // slots a cell of the private route
constexpr int kCellThreads = 256;        // threads a block of its suffix kernel
constexpr int kPrivateTilesPerWarp = 15; // so a block counts below 2^16 samples
static_assert(kPrivateTilesPerWarp * kWarps * kTile < (1 << 16), "a block's counts fit 16 bits");
static_assert(kCell == 64, "a warp sums and scans a cell two slots a lane");
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;  // H100 per-block opt-in limit
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

typedef unsigned long long u64;

// One round of G = 1: lane `lane` holds slot k (-1: no sample) and its hit.
// A round whose samples all fall in one slot joins the warp's pending add
// (`pend_slot`, `pend`: the same in every lane) while the slot repeats;
// the caller flushes it.
__device__ __forceinline__ void warp_add(u64* out, int lane, int k, bool hit, int& pend_slot,
                                         u64& pend) {
  const unsigned live = __ballot_sync(kFull, k >= 0);
  if (live == 0u) return;
  const unsigned hits = __ballot_sync(kFull, k >= 0 && hit);
  const int lo = __reduce_min_sync(kFull, k >= 0 ? k : kNone);
  const int hi = __reduce_max_sync(kFull, k);
  if (lo == hi) {  // every sample of the round in one slot
    if (lo != pend_slot) {
      if (pend_slot >= 0 && lane == 0) atomicAdd(out + pend_slot, pend);
      pend_slot = lo;
      pend = 0;
    }
    pend += ((u64)__popc(live) << 32) | (unsigned)__popc(hits);
    return;
  }
  const int next = __shfl_down_sync(kFull, k, 1);
  if (__any_sync(kFull, k >= 0 && lane < 31 && next == k)) {
    const unsigned peers = __match_any_sync(kFull, k);
    if (k >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(out + k, ((u64)__popc(peers) << 32) | (unsigned)__popc(peers & hits));
    }
  } else if (k >= 0) {
    atomicAdd(out + k, (1ULL << 32) | (unsigned)hit);
  }
}

// The slots of a lane's K samples (-1 where there is none), as slot_of
// gives them, with the guesses' probes issued together: a guess k is the
// slot when t[k-1] <= x < t[k] (t[T] read as +inf); any other sample
// (NaN, below the grid, a guess that misses, a grid with equal ends) takes
// slot_of itself.
template <int K>
__device__ __forceinline__ void slots_of(const float* th, int t, int top, float lo,
                                         float scale, const float (&x)[K],
                                         const bool (&valid)[K], int (&k)[K]) {
  bool guessed[K];
  float below[K], above[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    guessed[u] = valid[u] && scale != 0.0f && x[u] >= lo;
    k[u] = guessed[u] ? slot_guess(t, lo, scale, x[u]) : 1;
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    below[u] = th[k[u] - 1];
    above[u] = k[u] < t ? th[k[u]] : __int_as_float(0x7f800000);
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (!(guessed[u] && below[u] <= x[u] && x[u] < above[u])) {
      k[u] = valid[u] ? slot_of(th, t, top, lo, scale, x[u]) : -1;
    }
  }
}

// A G = 1 tile of one row into lane `lane`'s registers: its scores, hits
// and which of them exist.  VEC: lane l's samples 4l .. 4l + 3 of each
// 128-sample half as one float4 and one word of hits (the row contiguous
// and aligned); else samples l, l + 32, .. at any strides.
template <bool VEC>
__device__ __forceinline__ void load_row_tile(const float* __restrict__ srow, long long s_col,
                                              const unsigned char* __restrict__ hrow,
                                              long long h_col, long long q0, int n, int lane,
                                              float (&x)[kPer], bool (&h)[kPer],
                                              bool (&valid)[kPer]) {
  if (VEC) {
#pragma unroll
    for (int u = 0; u < kPer / 4; ++u) {
      const long long q = q0 + u * kHalf + 4 * lane;
      if (q + 4 <= n) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(srow + q));
        const unsigned b = __ldg(reinterpret_cast<const unsigned*>(hrow + q));
        x[4 * u] = v.x;
        x[4 * u + 1] = v.y;
        x[4 * u + 2] = v.z;
        x[4 * u + 3] = v.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[4 * u + e] = ((b >> (8 * e)) & 0xffu) != 0u;
          valid[4 * u + e] = true;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          valid[4 * u + e] = q + e < n;
          x[4 * u + e] = valid[4 * u + e] ? srow[q + e] : 0.0f;
          h[4 * u + e] = valid[4 * u + e] && hrow[q + e] != 0;
        }
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long q = q0 + u * 32 + lane;
      valid[u] = q < n;
      x[u] = valid[u] ? srow[q * s_col] : 0.0f;
      h[u] = valid[u] && hrow[q * h_col] != 0;
    }
  }
}

// The thresholds into shared memory, 16 bytes a thread where aligned.
__device__ __forceinline__ void stage_table(const float* __restrict__ thresholds, int t,
                                            float* sth) {
  if ((reinterpret_cast<uintptr_t>(thresholds) & 15u) == 0u) {
    const float4* src = reinterpret_cast<const float4*>(thresholds);
    float4* dst = reinterpret_cast<float4*>(sth);
#pragma unroll 4
    for (int i = threadIdx.x; i < (t >> 2); i += kThreads) dst[i] = __ldg(src + i);
    for (int i = (t & ~3) + threadIdx.x; i < t; i += kThreads) sth[i] = thresholds[i];
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < t; i += kThreads) sth[i] = __ldg(thresholds + i);
  }
}

template <int G, bool VEC, bool SMEM>
__global__ void __launch_bounds__(kThreads)
binned_count_kernel(const float* __restrict__ scores, long long s_row,
                    long long s_col, const unsigned char* __restrict__ hits,
                    long long h_row, long long h_col, int rows, int n,
                    const float* __restrict__ thresholds, int t, int top,
                    u64* __restrict__ hist) {
  extern __shared__ __align__(16) float sth[];
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * kWarps;
  // Tiles a row (G = 1) or a group of 32 rows (G = 32), and all tiles.
  const long long per = ((long long)n + (G == 1 ? kTile : kPer) - 1) / (G == 1 ? kTile : kPer);
  const long long tiles = (G == 1 ? (long long)rows : (long long)((rows + 31) / 32)) * per;

  // A tile's scores, hits and which of them exist, into this lane's
  // registers.  G = 1: lane samples of one row; G = 32: lane = row.
  float x[kPer];
  bool h[kPer], valid[kPer];
  auto load = [&](long long tile) {
    const int row = G == 1 ? (int)(tile / per) : (int)(tile / per) * 32 + lane;
    const bool live = row < rows;
    const float* srow = scores + (long long)row * s_row;
    const unsigned char* hrow = hits + (long long)row * h_row;
    if (G == 1) {
      load_row_tile<VEC>(srow, s_col, hrow, h_col, tile % per * kTile, n, lane, x, h, valid);
    } else {
      const long long q0 = tile % per * kPer;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        valid[u] = live && q0 + u < n;
        x[u] = valid[u] ? srow[(q0 + u) * s_col] : 0.0f;
      }
      if (VEC && live && q0 + kPer <= n) {
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(hrow + q0));
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          h[u] = (((u < 4 ? b.x : b.y) >> (8 * (u & 3))) & 0xffu) != 0u;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kPer; ++u) h[u] = valid[u] && hrow[(q0 + u) * h_col] != 0;
      }
    }
  };

  // The first tile's loads go out before the thresholds are staged.
  if (warp < tiles) load(warp);
  if (SMEM) {
    stage_table(thresholds, t, sth);
    __syncthreads();
  }
  const float* th = SMEM ? sth : thresholds;
  const float lo = thresholds[0], hi = thresholds[t - 1];
  const float scale = t > 1 && hi > lo ? (float)(t - 1) / (hi - lo) : 0.0f;

  // The loop bound is the warp's, so all 32 lanes reach the votes
  // together; lanes past the row or the rows carry no sample.
  for (long long tile = warp; tile < tiles; tile += warps) {
    if (tile != warp) load(tile);
    int k[kPer];
    slots_of(th, t, top, lo, scale, x, valid, k);
    if (G == 1) {
      u64* out = hist + tile / per * (t + 1);
      int pend_slot = -1;
      u64 pend = 0;
#pragma unroll
      for (int u = 0; u < kPer; ++u) warp_add(out, lane, k[u], h[u], pend_slot, pend);
      if (pend_slot >= 0 && lane == 0) atomicAdd(out + pend_slot, pend);
    } else {
      // Lanes are distinct rows: each merges runs of one slot among its
      // own samples.
      u64* out = hist + ((tile / per) * 32 + lane) * (long long)(t + 1);
      int run = -1;
      u64 acc = 0;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (!valid[u]) continue;
        if (k[u] != run) {
          if (run >= 0) atomicAdd(out + run, acc);
          run = k[u];
          acc = 0;
        }
        acc += (1ULL << 32) | (unsigned)h[u];
      }
      if (run >= 0) atomicAdd(out + run, acc);
    }
  }
}

// One row, a private histogram a block (the plan's route for a row whose
// histogram and thresholds fit in shared memory beside each other, and
// whose blocks each see fewer than 2^16 samples).  Each slot is one
// 32-bit word, (count << 16) | hits: a block's counts and hits stay below
// 2^16, so no sum of them carries.  A block stages its thresholds, counts
// its tiles with shared-memory atomics (a round whose lanes share one slot
// as one add), then writes its histogram whole to its copy, copies[block],
// and the suffix sums of its cells of kCell slots, cell_sums[cell][block]
// = every slot from the cell's first on: plain stores, so nothing needs
// zeroing first.  binned_cell_suffix_kernel adds the copies up.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
binned_private_kernel(const float* __restrict__ scores, long long s_col,
                      const unsigned char* __restrict__ hits, long long h_col, int n,
                      const float* __restrict__ thresholds, int t, int top,
                      unsigned* __restrict__ copies, unsigned* __restrict__ cell_sums) {
  extern __shared__ __align__(16) unsigned char raw[];
  const int t1 = t + 1;
  const int cells = (t1 + kCell - 1) / kCell;
  unsigned* slots = reinterpret_cast<unsigned*>(raw);
  float* sth = reinterpret_cast<float*>(raw + ((t1 * 4 + 15) & ~15));
  unsigned* cell = reinterpret_cast<unsigned*>(sth + ((t + 3) & ~3));
  const int lane = threadIdx.x & 31;
  const int warp_in = threadIdx.x >> 5;
  const long long warp = (long long)blockIdx.x * kWarps + warp_in;
  const long long warps = (long long)gridDim.x * kWarps;
  const long long tiles = ((long long)n + kTile - 1) / kTile;

  float x[kPer];
  bool h[kPer], valid[kPer];
  if (warp < tiles) load_row_tile<VEC>(scores, s_col, hits, h_col, warp * kTile, n, lane, x, h, valid);
  for (int i = threadIdx.x; i < t1; i += kThreads) slots[i] = 0u;
  stage_table(thresholds, t, sth);
  __syncthreads();
  const float lo = thresholds[0], hi = thresholds[t - 1];
  const float scale = t > 1 && hi > lo ? (float)(t - 1) / (hi - lo) : 0.0f;

  for (long long tile = warp; tile < tiles; tile += warps) {
    if (tile != warp) load_row_tile<VEC>(scores, s_col, hits, h_col, tile * kTile, n, lane, x, h, valid);
    int k[kPer];
    slots_of(sth, t, top, lo, scale, x, valid, k);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const unsigned live = __ballot_sync(kFull, k[u] >= 0);
      const unsigned hit = __ballot_sync(kFull, k[u] >= 0 && h[u]);
      const int first = __reduce_min_sync(kFull, k[u] >= 0 ? k[u] : kNone);
      if (first == __reduce_max_sync(kFull, k[u])) {  // one slot (or no sample)
        if (lane == 0 && live != 0u) {
          atomicAdd(slots + first, ((unsigned)__popc(live) << 16) | (unsigned)__popc(hit));
        }
      } else if (k[u] >= 0) {
        atomicAdd(slots + k[u], (1u << 16) | (unsigned)h[u]);
      }
    }
  }
  __syncthreads();

  unsigned* mine = copies + (long long)blockIdx.x * t1;
  for (int i = threadIdx.x; i < t1; i += kThreads) mine[i] = slots[i];
  for (int c = warp_in; c < cells; c += kWarps) {
    const int a = c * kCell + lane, b = a + 32;
    const unsigned v = (a < t1 ? slots[a] : 0u) + (b < t1 ? slots[b] : 0u);
    const unsigned sum = __reduce_add_sync(kFull, v);
    if (lane == 0) cell[c] = sum;
  }
  __syncthreads();
  if (warp_in == 0) {  // suffix sums over the cells, from the top
    unsigned carry = 0u;
    for (int base = (cells - 1) / 32 * 32; base >= 0; base -= 32) {
      const int c = base + lane;
      unsigned v = c < cells ? cell[c] : 0u;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_down_sync(kFull, v, d);
        if (lane + d < 32) v += o;
      }
      if (c < cells) cell_sums[(long long)c * gridDim.x + blockIdx.x] = carry + v;
      carry += __shfl_sync(kFull, v, 0);
    }
  }
}

// (count << 16) | hits of one block as (count << 32) | hits.
__device__ __forceinline__ u64 widen(unsigned v) {
  return ((u64)(v >> 16) << 32) | (v & 0xffffu);
}

// The suffix sum of binned_private_kernel's copies, unpacked: a block a
// cell of kCell slots, kCellThreads threads.  Each slot is summed over the
// copies (kCellThreads / kCell threads a slot, coalesced), the slots above
// the cell are the copies' cell_sums of the next cell, and one warp scans
// the cell's slots from the top.
__global__ void __launch_bounds__(kCellThreads)
binned_cell_suffix_kernel(const unsigned* __restrict__ copies,
                          const unsigned* __restrict__ cell_sums, int blocks, int t, int n,
                          int* __restrict__ num_tp, int* __restrict__ num_fp,
                          int* __restrict__ num_pos, int* __restrict__ num_total) {
  constexpr int kGroups = kCellThreads / kCell;
  __shared__ u64 part[kGroups][kCell];
  __shared__ u64 above_w[kCellThreads / 32];
  const int t1 = t + 1;
  const int cells = (t1 + kCell - 1) / kCell;
  const int c = blockIdx.x;
  const int s = threadIdx.x % kCell;
  const int g = threadIdx.x / kCell;
  const int slot = c * kCell + s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64 acc = 0;
  if (slot < t1) {
#pragma unroll 8
    for (int b = g; b < blocks; b += kGroups) acc += widen(copies[(long long)b * t1 + slot]);
  }
  part[g][s] = acc;
  u64 above = 0;
  if (c + 1 < cells) {
#pragma unroll 4
    for (int b = threadIdx.x; b < blocks; b += kCellThreads) {
      above += widen(cell_sums[(long long)(c + 1) * blocks + b]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) above += __shfl_xor_sync(kFull, above, d);
  if (lane == 0) above_w[warp] = above;
  __syncthreads();
  if (warp == 0) {  // lane l: slots 2l and 2l + 1 of the cell
    above = 0;
#pragma unroll
    for (int w = 0; w < kCellThreads / 32; ++w) above += above_w[w];
    u64 x0 = 0, x1 = 0;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      x0 += part[q][2 * lane];
      x1 += part[q][2 * lane + 1];
    }
    const u64 own = x0 + x1;
    u64 below = own;  // this lane's pair and every later lane's
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 o = __shfl_down_sync(kFull, below, d);
      if (lane + d < 32) below += o;
    }
    u64 run = above + below - own;
    int* tp = num_tp;
    int* fp = num_fp;
#pragma unroll
    for (int e = 1; e >= 0; --e) {
      run += e ? x1 : x0;
      const int k = c * kCell + 2 * lane + e;
      if (k < t1) {
        const int hit = (int)(unsigned)(run & 0xffffffffULL);
        if (k == 0) {
          *num_pos = hit;
          *num_total = n;
        } else {
          tp[k - 1] = hit;
          fp[k - 1] = (int)(run >> 32) - hit;
        }
      }
    }
  }
}

// Each row's suffix sum over its T + 1 packed slots, unpacked: `chunks`
// blocks a row, each owning THREADS x kSuffixPer consecutive slots.  A
// block reads its chunk coalesced into shared memory (a pad word after
// every kSuffixPer, so that a thread's run of kSuffixPer words sits on
// distinct banks) and sums every slot above the chunk on the way (the
// blocks of a row need nothing from each other); each thread sums its run,
// a warp shuffle scan gives each lane the runs after it, warp 0 scans the
// warps' sums and adds the slots above the chunk, the thread writes its
// run's suffix sums back in place, and the chunk is unpacked and written
// coalesced.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
binned_suffix_kernel(const u64* __restrict__ hist, int t, int n, int chunks,
                     int* __restrict__ num_tp, int* __restrict__ num_fp,
                     int* __restrict__ num_pos, int* __restrict__ num_total) {
  constexpr int kWarpsHere = THREADS / 32;
  constexpr int kChunk = THREADS * kSuffixPer;
  extern __shared__ u64 chunk[];  // kChunk + kChunk / kSuffixPer words
  __shared__ u64 warp_runs[kWarpsHere];   // a warp's slots
  __shared__ u64 warp_above[kWarpsHere];  // a warp's share of the slots above the chunk,
                                          // then every slot above the warp's
  const int row = blockIdx.x / chunks;
  const int c0 = blockIdx.x % chunks * kChunk;
  const int t1 = t + 1;
  const int len = min(kChunk, t1 - c0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const u64* h = hist + (long long)row * t1;
#pragma unroll
  for (int j = 0; j < kSuffixPer; ++j) {
    const int i = j * THREADS + threadIdx.x;
    chunk[i + i / kSuffixPer] = i < len ? h[c0 + i] : 0ULL;
  }
  u64 part = 0;  // slots above the chunk, this thread's share
#pragma unroll 16
  for (int i = c0 + kChunk + threadIdx.x; i < t1; i += THREADS) part += h[i];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) part += __shfl_down_sync(kFull, part, d);
  __syncthreads();

  const int base = threadIdx.x * (kSuffixPer + 1);
  u64 v[kSuffixPer];
  u64 own = 0;
#pragma unroll
  for (int j = 0; j < kSuffixPer; ++j) {
    v[j] = chunk[base + j];
    own += v[j];
  }
  u64 below = own;  // this lane's run and every later lane's
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const u64 o = __shfl_down_sync(kFull, below, d);
    if (lane + d < 32) below += o;
  }
  if (lane == 0) {
    warp_runs[warp] = below;
    warp_above[warp] = part;
  }
  __syncthreads();
  if (warp == 0) {  // lane w: every slot above warp w's
    const u64 runs = lane < kWarpsHere ? warp_runs[lane] : 0ULL;
    u64 above = lane < kWarpsHere ? warp_above[lane] : 0ULL;
    u64 later = runs;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) above += __shfl_xor_sync(kFull, above, d);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 o = __shfl_down_sync(kFull, later, d);
      if (lane + d < 32) later += o;
    }
    if (lane < kWarpsHere) warp_above[lane] = above + later - runs;
  }
  __syncthreads();
  u64 run = warp_above[warp] + below - own;
#pragma unroll
  for (int j = kSuffixPer - 1; j >= 0; --j) {
    run += v[j];
    chunk[base + j] = run;
  }
  __syncthreads();
  int* tp = num_tp + (long long)row * t;
  int* fp = num_fp + (long long)row * t;
#pragma unroll
  for (int j = 0; j < kSuffixPer; ++j) {
    const int i = j * THREADS + threadIdx.x;
    if (i < len) {
      const int k = c0 + i;
      const u64 cum = chunk[i + i / kSuffixPer];
      const int hit = (int)(unsigned)(cum & 0xffffffffULL);
      if (k == 0) {
        num_pos[row] = hit;
        num_total[row] = n;
      } else {
        tp[k - 1] = hit;
        fp[k - 1] = (int)(cum >> 32) - hit;
      }
    }
  }
}

template <int THREADS>
cudaError_t launch_suffix(const u64* hist, int rows, int t, int n, int* tp, int* fp, int* pos,
                          int* total, cudaStream_t stream) {
  const int chunks = (t + THREADS * kSuffixPer) / (THREADS * kSuffixPer);  // of t + 1 slots
  constexpr size_t smem = (size_t)THREADS * (kSuffixPer + 1) * sizeof(u64);
  static_assert(smem <= (size_t)kDefaultSmem, "a chunk needs no shared-memory opt-in");
  binned_suffix_kernel<THREADS><<<rows * chunks, THREADS, smem, stream>>>(hist, t, n, chunks,
                                                                          tp, fp, pos, total);
  return cudaGetLastError();
}

template <int G, bool VEC, bool SMEM>
cudaError_t launch_count(int blocks, const float* scores, long long s_row, long long s_col,
                         const unsigned char* hits, long long h_row, long long h_col,
                         int rows, int n, const float* thresholds, int t, u64* hist,
                         cudaStream_t stream) {
  const size_t smem = SMEM ? (size_t)t * sizeof(float) : 0;
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(binned_count_kernel<G, VEC, SMEM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  binned_count_kernel<G, VEC, SMEM><<<blocks, kThreads, smem, stream>>>(
      scores, s_row, s_col, hits, h_row, h_col, rows, n, thresholds, t, top_step(t), hist);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_layout(bool vec, bool smem, int blocks, const float* s, long long s_row,
                          long long s_col, const unsigned char* h, long long h_row,
                          long long h_col, int rows, int n, const float* th, int t,
                          u64* hist, cudaStream_t st) {
  if (vec) {
    return smem ? launch_count<G, true, true>(blocks, s, s_row, s_col, h, h_row, h_col, rows,
                                              n, th, t, hist, st)
                : launch_count<G, true, false>(blocks, s, s_row, s_col, h, h_row, h_col, rows,
                                               n, th, t, hist, st);
  }
  return smem ? launch_count<G, false, true>(blocks, s, s_row, s_col, h, h_row, h_col, rows,
                                             n, th, t, hist, st)
              : launch_count<G, false, false>(blocks, s, s_row, s_col, h, h_row, h_col, rows,
                                              n, th, t, hist, st);
}

// Shared memory of binned_private_kernel: the slots, the thresholds and
// the cells' sums, each 16-byte aligned.
long long private_smem(int t) {
  const long long t1 = (long long)t + 1;
  return ((t1 * 4 + 15) & ~15LL) + 4 * (((long long)t + 3) & ~3LL) + 4 * ((t1 + kCell - 1) / kCell);
}

template <bool VEC>
cudaError_t launch_private(int blocks, const float* s, long long s_col, const unsigned char* h,
                           long long h_col, int n, const float* th, int t, unsigned* copies,
                           unsigned* cell_sums, int* tp, int* fp, int* pos, int* total,
                           cudaStream_t st) {
  const size_t smem = (size_t)private_smem(t);
  if (smem > (size_t)kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(binned_private_kernel<VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  binned_private_kernel<VEC><<<blocks, kThreads, smem, st>>>(s, s_col, h, h_col, n, th, t,
                                                            top_step(t), copies, cell_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cells = (t + kCell) / kCell;  // of t + 1 slots
  binned_cell_suffix_kernel<<<cells, kCellThreads, 0, st>>>(copies, cell_sums, blocks, t, n, tp,
                                                             fp, pos, total);
  return cudaGetLastError();
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0u;
}

}  // namespace

// scores: (rows, n) f32 and hits: (rows, n) bytes (0 = miss), each at any
// strides; thresholds: (t,) f32, contiguous, ascending, t >= 1; num_tp,
// num_fp: (rows, t) int32 and num_pos, num_total: (rows,) int32, written
// whole.  The plan (ops/binned.py::binned_count_plan): group_rows 32 or 1,
// vec (16-byte score and 4-byte hit loads for G = 1, 8-byte hit loads for
// G = 32), smem (thresholds staged in shared memory), private_route, and
// the blocks of the count kernel.  The global route zeroes scratch,
// (rows, t + 1) uint64, with cudaMemsetAsync, launches the count kernel,
// then the suffix kernel; the private route (one row) takes scratch as
// (blocks, t + 1) uint32 copies and cell_sums as (cells, blocks) uint32,
// both written whole, and launches binned_private_kernel, then
// binned_cell_suffix_kernel.  A plan the operands do not allow (a vector
// load they do not align for, a table past shared memory) is refused with
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launches.
extern "C" int binned_count_launch(const void* scores, long long s_row, long long s_col,
                                   const void* hits, long long h_row, long long h_col,
                                   int rows, int n, const void* thresholds, int t,
                                   int group_rows, int vec, int smem, int private_route,
                                   int blocks, void* scratch, void* cell_sums, void* num_tp,
                                   void* num_fp, void* num_pos, void* num_total,
                                   void* stream) {
  const float* s = static_cast<const float*>(scores);
  const unsigned char* h = static_cast<const unsigned char*>(hits);
  const float* th = static_cast<const float*>(thresholds);
  u64* packed = static_cast<u64*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tp = static_cast<int*>(num_tp);
  int* fp = static_cast<int*>(num_fp);
  int* pos = static_cast<int*>(num_pos);
  int* total = static_cast<int*>(num_total);
  const bool row_step = rows == 1;
  bool ok = blocks >= 1 && t >= 1 && (group_rows == 1 || group_rows == 32);
  if (private_route) {
    // A block's counts must stay below 2^16: at most 15 tiles a warp.
    const long long tiles = ((long long)n + kTile - 1) / kTile;
    const long long warps = (long long)blocks * kWarps;
    ok = ok && rows == 1 && group_rows == 1 && private_smem(t) <= kMaxSmem &&
         (tiles + warps - 1) / warps <= kPrivateTilesPerWarp &&
         (!vec || (s_col == 1 && h_col == 1 && aligned(s, 16) && aligned(h, 4)));
    if (!ok) return (int)cudaErrorInvalidValue;
    unsigned* copies = static_cast<unsigned*>(scratch);
    unsigned* sums = static_cast<unsigned*>(cell_sums);
    return (int)(vec ? launch_private<true>(blocks, s, s_col, h, h_col, n, th, t, copies, sums,
                                            tp, fp, pos, total, st)
                     : launch_private<false>(blocks, s, s_col, h, h_col, n, th, t, copies, sums,
                                             tp, fp, pos, total, st));
  }
  if (vec && group_rows == 1) {
    ok = ok && s_col == 1 && h_col == 1 && aligned(s, 16) && aligned(h, 4) &&
         (row_step || (s_row % 4 == 0 && h_row % 4 == 0));
  } else if (vec) {
    ok = ok && h_col == 1 && aligned(h, 8) && (row_step || h_row % 8 == 0);
  }
  if (smem) ok = ok && (long long)t * (long long)sizeof(float) <= kMaxSmem;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(packed, 0, (size_t)rows * (size_t)(t + 1) * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  err = group_rows == 32
          ? launch_layout<32>(vec != 0, smem != 0, blocks, s, s_row, s_col, h, h_row, h_col,
                              rows, n, th, t, packed, st)
          : launch_layout<1>(vec != 0, smem != 0, blocks, s, s_row, s_col, h, h_row, h_col,
                             rows, n, th, t, packed, st);
  if (err != cudaSuccess) return (int)err;
  // Chunks of 1024 slots for rows that fit one, else of 2048.
  err = t + 1 <= 128 * kSuffixPer ? launch_suffix<128>(packed, rows, t, n, tp, fp, pos, total, st)
                                  : launch_suffix<256>(packed, rows, t, n, tp, fp, pos, total, st);
  return (int)err;
}
