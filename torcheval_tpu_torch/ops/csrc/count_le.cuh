// The binary search shared by rank_sum.cu, rank_hist.cu and the two binned
// kernels, and the binned kernels' slot of a score (slot_of).
#pragma once

#include <type_traits>

// #{table[k] <= x} for an ascending table of `cap` entries, entry k at
// table[k * STRIDE]: a branchless upper_bound over power-of-two steps from
// `top`, the largest power of two <= cap.  A NaN x compares false
// everywhere and counts 0; callers that need another answer test for it.
template <int STRIDE>
__device__ __forceinline__ int count_le(const float* table, int cap, int top,
                                        float x) {
  int lo = 0;
  for (int step = top; step > 0; step >>= 1) {
    int probe = lo + step;
    if (probe <= cap && table[(probe - 1) * STRIDE] <= x) {
      lo = probe;
    }
  }
  return lo;
}

// count_le for K queries at once, their searches interleaved step by step
// so that K independent loads are in flight: la[i] = #{ta[k] <= x[i]} and,
// with TWO, lb[i] = #{tb[k] <= -x[i]} as well (2K searches).  Each step
// checks `probe <= cap`; count_le_shared below is the unguarded form for
// tables in shared memory at the route's capacities.
template <int K, int STRIDE, bool TWO>
__device__ __forceinline__ void count_le_many(const float* ta, const float* tb,
                                              int cap, int top,
                                              const float (&x)[K], int (&la)[K],
                                              int (&lb)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    la[i] = 0;
    lb[i] = 0;
  }
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int pa = la[i] + step;
      if (pa <= cap && ta[(pa - 1) * STRIDE] <= x[i]) la[i] = pa;
      if (TWO) {
        const int pb = lb[i] + step;
        if (pb <= cap && tb[(pb - 1) * STRIDE] <= -x[i]) lb[i] = pb;
      }
    }
  }
}

// A float of shared memory at a 32-bit shared-space byte address + OFF.
// Volatile: the compiler must not hoist it above the barrier that
// publishes the staged tables.
template <int OFF>
__device__ __forceinline__ float ld_shared(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];" : "=f"(v) : "r"(addr), "n"(OFF));
  return v;
}

// The steps of count_le_shared: STEP, STEP / 2, .. 1 entries,
// each a load at the search's address plus a constant, a compare and a
// predicated add.
template <int STEP, int K, int ENTRY, bool TWO>
__device__ __forceinline__ void fixed_steps(unsigned (&a)[K], unsigned (&b)[K],
                                            const float (&x)[K]) {
  if constexpr (STEP > 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (ld_shared<(STEP - 1) * ENTRY>(a[i]) <= x[i]) a[i] += STEP * ENTRY;
      if (TWO && ld_shared<(STEP - 1) * ENTRY>(b[i]) <= -x[i]) b[i] += STEP * ENTRY;
    }
    fixed_steps<STEP / 2, K, ENTRY, TWO>(a, b, x);
  }
}

// count_le_many for tables in shared memory (ta, tb: shared-space byte
// addresses of entry 0, entries STRIDE floats apart) with cap == TOP, a
// power of two known at compile time.  Each search keeps the address of
// its entry lo, so a step is three instructions (a load at the address
// plus a constant, a compare, a predicated add) and carries no
// `probe <= cap` guard: the steps TOP/2 .. 1 reach at most entry TOP - 2,
// and one last compare at entry lo (<= TOP - 1) adds the final one.  The
// first step probes the same entry for every query of a table, so it is
// loaded once.  Same counts as count_le.
template <int K, int STRIDE, bool TWO, int TOP>
__device__ __forceinline__ void count_le_shared(unsigned ta, unsigned tb,
                                                const float (&x)[K], int (&la)[K],
                                                int (&lb)[K]) {
  constexpr int kEntry = STRIDE * 4;  // bytes from one entry to the next
  constexpr int kHalf = TOP / 2 * kEntry;
  const float fa = ld_shared<kHalf - kEntry>(ta);
  const float fb = TWO ? ld_shared<kHalf - kEntry>(tb) : 0.0f;
  unsigned a[K], b[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    a[i] = fa <= x[i] ? ta + kHalf : ta;
    b[i] = fb <= -x[i] ? tb + kHalf : tb;
  }
  fixed_steps<TOP / 4, K, kEntry, TWO>(a, b, x);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    la[i] = (int)((a[i] - ta) / kEntry) + (ld_shared<0>(a[i]) <= x[i]);
    if (TWO) lb[i] = (int)((b[i] - tb) / kEntry) + (ld_shared<0>(b[i]) <= -x[i]);
  }
}

// Calls f(std::integral_constant<int, TOP>{}) with TOP = cap for the
// capacities that have a fixed-step form (count_le_shared): the route's,
// 16 .. 512 (ops/ustat.py::_win_cap, _FIXED_CAPS); TOP = -1 for any other.
template <class F>
inline auto with_top(int cap, F&& f) {
  switch (cap) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    case 512: return f(std::integral_constant<int, 512>{});
    default: return f(std::integral_constant<int, -1>{});
  }
}

// The largest power of two <= n (n >= 1), the first step of count_le.
inline int top_step(int n) {
  int top = 1;
  while (top * 2 <= n) top *= 2;
  return top;
}

// Steps slot_of walks from its guessed slot before it takes count_le.
constexpr int kWalk = 4;

// slot_of's first guess for a score x >= lo on a grid of `scale` > 0:
// interpolated between the grid's ends, in [1, T] (>= 1, as x >= t[0]).
__device__ __forceinline__ int slot_guess(int t, float lo, float scale, float x) {
  const float g = (x - lo) * scale;
  return g < (float)(t - 1) ? (int)g + 1 : t;
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
  int k = slot_guess(t, lo, scale, x);
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
