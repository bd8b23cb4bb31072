// Batched Levenshtein distance over tokenized sequences, on the host.
//
// The string flavour of the text metrics (word error rate, word
// information preserved / lost) is host work: sentences are split and
// interned in Python, and no device tensor exists until the three counters
// are folded into the metric's state.  Its inner loop is this C++ batch DP,
// which is also the oracle the device kernel (ops/csrc/wavefront.cu) is held
// against.  Tokens arrive as int32 ids; distances use the classic two-row
// dynamic program, O(len_a * len_b) time and O(min_len) space per pair.
//
// Exposed through a plain C ABI for ctypes.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Edit distance between a[0:na] and b[0:nb].
int64_t tvt_levenshtein(const int32_t* a, int64_t na, const int32_t* b,
                        int64_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  // Iterate over the longer sequence, keep rows over the shorter one.
  if (nb > na) {
    std::swap(a, b);
    std::swap(na, nb);
  }
  std::vector<int64_t> row(static_cast<size_t>(nb) + 1);
  for (int64_t j = 0; j <= nb; ++j) row[static_cast<size_t>(j)] = j;
  for (int64_t i = 1; i <= na; ++i) {
    int64_t diag = row[0];
    row[0] = i;
    for (int64_t j = 1; j <= nb; ++j) {
      int64_t up = row[static_cast<size_t>(j)];
      int64_t cost = (a[i - 1] == b[j - 1]) ? diag : diag + 1;
      row[static_cast<size_t>(j)] =
          std::min({cost, up + 1, row[static_cast<size_t>(j - 1)] + 1});
      diag = up;
    }
  }
  return row[static_cast<size_t>(nb)];
}

// Batched form: pair i spans a[a_offsets[i]:a_offsets[i+1]] vs
// b[b_offsets[i]:b_offsets[i+1]]; writes out[i].  One ctypes crossing for
// the whole batch.
void tvt_levenshtein_batch(const int32_t* a, const int64_t* a_offsets,
                           const int32_t* b, const int64_t* b_offsets,
                           int64_t n_pairs, int64_t* out) {
  for (int64_t i = 0; i < n_pairs; ++i) {
    out[i] = tvt_levenshtein(a + a_offsets[i], a_offsets[i + 1] - a_offsets[i],
                             b + b_offsets[i], b_offsets[i + 1] - b_offsets[i]);
  }
}

}  // extern "C"
