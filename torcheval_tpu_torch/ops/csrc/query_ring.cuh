// The query tiles shared by rank_sum.cu and rank_hist.cu: a persistent
// block walks the tiles of its row group through a ring of kStages tiles in
// shared memory, filled by asynchronous copies (cp.async) while the warps
// search the tile before.  The wrapper's plan (ops/ustat.py::_rank_plan)
// mirrors every constant here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace query_ring {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 64;                    // a tile: kSlots x 32 f32, 8 KiB
constexpr int kTileFloats = kSlots * 32;
constexpr int kStages = 4;                    // tiles in the ring, 32 KiB
constexpr int kInFlight = kSlots / kWarps;    // slots a warp takes from a tile
constexpr int kRingBytes = kStages * kTileFloats * (int)sizeof(float);
constexpr int kDefaultSmem = 48 * 1024;       // more needs the opt-in attribute

// The (rq, n) f32 queries: element (row, q) at base[row * stride_row +
// q * stride_col].  A tile of row group `row0` holds, for G = 32, samples
// q0 .. q0 + kSlots - 1 (slots) of rows row0 .. row0 + 31 (columns), q0 =
// tile * kSlots; for G = 1, samples q0 + 32 s + c of row row0 at slot s,
// column c, q0 = tile * kTileFloats.  Either way slot s, column c sits at
// [s * 32 + c], so lane c of a warp reads its column without bank conflicts.
struct View {
  const float* base;
  long long stride_row, stride_col;
  int rq, n;
};

template <int G>
__device__ __forceinline__ int tiles_of(int n) {
  const int per = G == 32 ? kSlots : kTileFloats;
  return (int)(((long long)n + per - 1) / per);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How many of the kInFlight slots warp w takes from tile `tile` (slots
// w * kInFlight + i, i = 0, 1, ...) hold a query in lane c's column: a
// count, not a mask, so that the searches keep the predicate registers.
template <int G>
__device__ __forceinline__ int live_slots(const View& v, int row0, int tile, int w, int c) {
  long long left;
  if (G == 32) {
    if (c >= v.rq - row0) return 0;
    left = v.n - (long long)tile * kSlots - w * kInFlight;
  } else {
    const long long m = v.n - (long long)tile * kTileFloats - w * kInFlight * 32 - c;
    left = m > 0 ? (m + 31) / 32 : 0;
  }
  return (int)(left < 0 ? 0 : left < kInFlight ? left : kInFlight);
}

// Start the copies of one tile into `dst`.  vec16: 16-byte copies of four
// adjacent columns (G = 32: stride_row == 1; G = 1: stride_col == 1; the
// base and the other stride 16-byte aligned), a partial last chunk
// zero-filled and never read past the view; else one 4-byte copy an
// element, at any strides.  Cells that hold no query are not written.
template <int G>
__device__ __forceinline__ void issue_tile(float* dst, const View& v, int row0, int tile,
                                           bool vec16) {
  const int tid = threadIdx.x;
  if (G == 32) {
    const long long q0 = (long long)tile * kSlots;
    const int slots = (int)min((long long)kSlots, v.n - q0);
    const int cols = min(32, v.rq - row0);
    const float* src = v.base + (long long)row0 * v.stride_row + q0 * v.stride_col;
    if (vec16) {
      for (int i = tid; i < slots * 8; i += kThreads) {
        const int s = i >> 3, c4 = (i & 7) * 4;
        if (c4 < cols) {
          cp_async16(dst + s * 32 + c4, src + s * v.stride_col + c4,
                     4 * min(4, cols - c4));
        }
      }
    } else {
      for (int i = tid; i < slots * 32; i += kThreads) {
        const int s = i >> 5, c = i & 31;
        if (c < cols) cp_async4(dst + i, src + s * v.stride_col + c * v.stride_row);
      }
    }
  } else {
    const long long q0 = (long long)tile * kTileFloats;
    const int count = (int)min((long long)kTileFloats, v.n - q0);
    const float* src = v.base + (long long)row0 * v.stride_row + q0 * v.stride_col;
    if (vec16) {
      for (int i = tid * 4; i < count; i += kThreads * 4) {
        cp_async16(dst + i, src + i, 4 * min(4, count - i));
      }
    } else {
      for (int i = tid; i < count; i += kThreads) cp_async4(dst + i, src + i * v.stride_col);
    }
  }
}

// Walk tiles first, first + step, ... < tiles of row group row0 through
// the ring: kStages - 1 tiles are in flight while body(tile_smem, tile)
// searches one.  One barrier a tile: it shows every thread's copies of
// this tile, and that every warp is done with the buffer the next copy
// overwrites (the one searched in the turn before).
template <int G, class Body>
__device__ __forceinline__ void walk_tiles(float* ring, const View& v, int row0, int first,
                                           int step, int tiles, bool vec16, Body&& body) {
  int next = first;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (next < tiles) issue_tile<G>(ring + st * kTileFloats, v, row0, next, vec16);
    cp_async_commit();
    next += step;
  }
  int k = 0;
  for (int t = first; t < tiles; t += step, ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (next < tiles) {
      issue_tile<G>(ring + ((k + kStages - 1) % kStages) * kTileFloats, v, row0, next, vec16);
    }
    cp_async_commit();
    next += step;
    body(ring + (k % kStages) * kTileFloats, t);
  }
  cp_async_wait<0>();
}

// Stage rows row0 .. row0 + rows - 1 of the (R, cap) tables in shared
// memory, entry k of row g at dst[k * G + g]: for G = 32 a thread moves
// four entries of one row (a 16-byte load where the tables allow it), so
// the 32 lanes of a warp write 32 banks.
template <int G>
__device__ __forceinline__ void stage_tables(float* dst, const float* tables, int row0,
                                             int rows, int cap) {
  if (G == 1) {
    const float* src = tables + (long long)row0 * cap;
    for (int i = threadIdx.x; i < cap; i += kThreads) dst[i] = src[i];
    return;
  }
  const bool aligned = ((uintptr_t)tables & 15) == 0;
  for (int i = threadIdx.x; i < 32 * (cap / 4); i += kThreads) {
    const int g = i & 31, k = (i >> 5) * 4;
    if (g < rows) {
      const float* src = tables + (long long)(row0 + g) * cap + k;
      const float4 q = aligned ? *reinterpret_cast<const float4*>(src)
                               : make_float4(src[0], src[1], src[2], src[3]);
      dst[(k + 0) * 32 + g] = q.x;
      dst[(k + 1) * 32 + g] = q.y;
      dst[(k + 2) * 32 + g] = q.z;
      dst[(k + 3) * 32 + g] = q.w;
    }
  }
}

}  // namespace query_ring
