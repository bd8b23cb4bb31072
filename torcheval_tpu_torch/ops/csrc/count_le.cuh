// The binary search shared by rank_sum.cu, rank_hist.cu and binned_count.cu.
#pragma once

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

// The largest power of two <= n (n >= 1), the first step of count_le.
inline int top_step(int n) {
  int top = 1;
  while (top * 2 <= n) top *= 2;
  return top;
}
