// Batched token-level Levenshtein distance: one warp a pair, lanes on row
// strips, columns swept in a skewed pipeline with no block barrier.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_wavefront.py::
// _wavefront_kernel (entry _edit_distance_pallas).  For each pair r it
// computes the edit distance between a[r, :a_lens[r]] and b[r, :b_lens[r]]
// as an exact int32:
//
//     D[i, j] = min(D[i-1, j] + 1, D[i, j-1] + 1, D[i-1, j-1] + (x[i-1] != y[j-1]))
//     D[i, 0] = i,  D[0, j] = j
//
// The TPU kernel advanced the whole padded bucket one anti-diagonal per grid
// step, with pairs on sublanes, ids on lanes padded to 128, poisoned
// out-of-matrix lanes and a one-hot capture.  All of that is TPU layout,
// and none of it is carried over.
//
// Design.  Unit-cost Levenshtein distance is symmetric, so the shorter
// side x (length m) goes on the rows and the longer y (length n >= m) on
// the columns.  One warp owns a pair; a block holds kWarps warps, each on
// its own pair, and nothing in the sweep waits on another warp.  Lane k
// owns the R consecutive rows k R + 1 .. k R + R of a band of 32 R rows:
// it keeps their x tokens and their cells of the previous column in
// registers.  The warp sweeps the columns in a skewed pipeline: at step s
// lane k computes column j = s - k, so lane k - 1 has finished column j one
// step before, and one __shfl_up_sync hands lane k that lane's bottom cell
// (the cell above the strip; the one a column back, the diagonal, it kept
// from the step before) and the token y[j-1] it used.  Lane 0 takes its
// token, and the cell above it, from a chunk of 32 columns the warp loaded
// together (coalesced), one chunk ahead; a chunk of 32 steps in which
// every lane is inside the matrix runs without the per-lane bounds test.
// R is 1, 2, 4 or 8: the least
// that covers the pair's m rows in one band, 8 past 256 rows, chosen per
// pair (ops/wavefront.py::_strip_rows is the same rule), so a short pair
// has few lanes and few steps: n + lanes - 1.  Rows past 256 go in bands
// of 256: the last lane writes its bottom row to a per-warp global carry
// (two buffers, written by one band and read by the next, one __syncwarp
// between), which lane 0 of the next band reads in its chunks.  Cells of
// rows past m are computed and never read (the DP flows down and right);
// x and y are read only below their lengths, so pad values never matter.
// The lane that holds row m writes D[m, n] after the last band.
//
// The first version of this kernel ran one block a pair over the
// anti-diagonals with a __syncthreads() a diagonal (~200 for a pair of ~100
// tokens) and most of its 288 threads idle on most diagonals.  Here a step
// costs R cells a lane and three or four shuffles, and no warp waits on
// another: about 5x faster at the corpus update on the H100 (PERF.md).
//
// Bound on the H100: operations.  A cell needs five integer operations (a
// compare, two adds, two mins), and the card issues 132 SMs x 64 int32
// lanes x 1.98 GHz = 16.7e12 of them a second.  The bytes, n x (La + Lb) x
// 4 read once, take less time than that from a few tokens a pair on.  The
// pipeline's fill and drain (lanes - 1 steps a band), the idle lanes of a
// strip past m and the shuffles and feed of each step are the work this
// design does beyond the cells; the R = 8 strips' 64 registers a thread
// hold an SM to 32 warps (forcing fewer registers spills, and was slower).
//
// Deterministic: integer minima, no atomics, one fixed schedule.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps (pairs in flight) a block
constexpr int kMaxR = 8;   // rows a lane at most: a band is 256 rows
constexpr unsigned kFull = 0xffffffffu;

// Lane 0's feed for 32 columns: y[c0 + lane] and the carry above the band
// at the same column, 0 past n (never used: lane 0 stops at n).
__device__ __forceinline__ void load_chunk(const int* __restrict__ y, const int* cin,
                                           int c0, int n, int lane, int& tok, int& up) {
  const int c = c0 + lane;
  tok = c < n ? y[c] : 0;
  up = (cin != nullptr && c < n) ? cin[c] : 0;
}

// One step s of the sweep: lane k computes column j = s - k of its strip.
// Lane 0 takes the column's token and the cell above the band from the
// chunk registers (lane c of them); every other lane takes lane k - 1's
// bottom cell and token from the step before.  GUARD: lanes outside the
// matrix (j < 1 in the pipeline's fill, j > n in its drain) keep their
// cells; unguarded steps are those where every lane is inside.
template <int R, bool GUARD>
__device__ __forceinline__ void step(int s, int c, int lane, int n, bool first, int* cout,
                                     int tok_cur, int up_cur, const int (&xt)[R],
                                     int (&col)[R], int& up_prev, int& tok, int& bottom) {
  const int feed_tok = __shfl_sync(kFull, tok_cur, c);
  const int feed_up = first ? s : __shfl_sync(kFull, up_cur, c);
  int up = __shfl_up_sync(kFull, bottom, 1);
  tok = __shfl_up_sync(kFull, tok, 1);
  if (lane == 0) {
    up = feed_up;
    tok = feed_tok;
  }
  const int j = s - lane;
  if (!GUARD || (j >= 1 && j <= n)) {
    int diag = up_prev, above = up;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int left = col[r];
      const int v = min(min(above, left) + 1, diag + (xt[r] != tok));
      diag = left;
      col[r] = v;
      above = v;
    }
    up_prev = up;
    bottom = col[R - 1];
    if (cout != nullptr && lane == 31) cout[j - 1] = bottom;
  }
}

// D[m, n] of x (m rows) against y (n >= m >= 1 columns), R rows a lane.
// carry: two buffers of carry_len >= n ints for this warp (used only when
// m > 32 R).  The steps go in chunks of 32, one chunk of feed registers
// each; a chunk where every lane is inside the matrix runs unguarded.
template <int R>
__device__ int sweep(const int* __restrict__ x, int m, const int* __restrict__ y, int n,
                     int* carry, int carry_len, int lane) {
  constexpr int kBand = 32 * R;
  int result = 0;
  for (int base = 0, band = 0; base < m; base += kBand, ++band) {
    const bool last = base + kBand >= m;
    const int* cin = band == 0 ? nullptr : carry + (band & 1) * carry_len;
    int* cout = last ? nullptr : carry + ((band + 1) & 1) * carry_len;
    const int row0 = base + lane * R;  // the row above this lane's strip
    int xt[R], col[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xt[r] = row0 + r < m ? x[row0 + r] : -1;
      col[r] = row0 + r + 1;  // column 0: D[i, 0] = i
    }
    int up_prev = row0;  // D[row0, j - 1]
    const int lanes = min(32, (m - base + R - 1) / R);
    const int steps = n + lanes - 1;
    int tok_cur, up_cur, tok_next, up_next;
    load_chunk(y, cin, 0, n, lane, tok_cur, up_cur);
    int tok = 0, bottom = 0;
    for (int s0 = 1; s0 <= steps; s0 += 32) {
      // Steps s0 .. s0 + 31 feed lane 0 columns s0 .. s0 + 31 (chunk
      // indices s0 - 1 ..); the next chunk's loads are in flight meanwhile.
      load_chunk(y, cin, s0 - 1 + 32, n, lane, tok_next, up_next);
      if (s0 >= 32 && s0 + 31 <= n) {
#pragma unroll 8
        for (int c = 0; c < 32; ++c) {
          step<R, false>(s0 + c, c, lane, n, cin == nullptr, cout, tok_cur, up_cur, xt, col,
                         up_prev, tok, bottom);
        }
      } else {
        const int end = min(32, steps - s0 + 1);
        for (int c = 0; c < end; ++c) {
          step<R, true>(s0 + c, c, lane, n, cin == nullptr, cout, tok_cur, up_cur, xt, col,
                        up_prev, tok, bottom);
        }
      }
      tok_cur = tok_next;
      up_cur = up_next;
    }
    if (last) {
      const int k = (m - 1 - base) / R, rr = (m - 1 - base) % R;
      int v = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) v = r == rr ? col[r] : v;
      result = __shfl_sync(kFull, v, k);
    }
    __syncwarp();  // this band's carry is visible to the next band's loads
  }
  return result;
}

__global__ void __launch_bounds__(kWarps * 32)
wavefront_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 const int* __restrict__ a_lens, const int* __restrict__ b_lens, int n,
                 int wa, int wb, int* __restrict__ scratch, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * kWarps;
  const int carry_len = wa > wb ? wa : wb;
  int* const carry = scratch == nullptr ? nullptr : scratch + warp * 2 * carry_len;
  for (long long p = warp; p < n; p += warps) {
    const int la = min(max(a_lens[p], 0), wa);
    const int lb = min(max(b_lens[p], 0), wb);
    const bool a_rows = la <= lb;
    const int* x = a_rows ? a + p * wa : b + p * wb;
    const int* y = a_rows ? b + p * wb : a + p * wa;
    const int m = a_rows ? la : lb;
    const int cols = a_rows ? lb : la;
    int d;
    if (m == 0) {
      d = cols;
    } else if (m <= 32) {
      d = sweep<1>(x, m, y, cols, carry, carry_len, lane);
    } else if (m <= 64) {
      d = sweep<2>(x, m, y, cols, carry, carry_len, lane);
    } else if (m <= 128) {
      d = sweep<4>(x, m, y, cols, carry, carry_len, lane);
    } else {
      d = sweep<kMaxR>(x, m, y, cols, carry, carry_len, lane);
    }
    if (lane == 0) out[p] = d;
  }
}

}  // namespace

// a: (n, wa) int32, b: (n, wb) int32, contiguous; a_lens, b_lens, out: (n,)
// int32; n >= 1.  `blocks` blocks of 4 warps stride over the pairs, a warp
// a pair.  scratch is null when min(wa, wb) <= 256 (every pair one band),
// else blocks x 4 x 2 x max(wa, wb) int32: each warp's two carry rows.
// Returns cudaGetLastError() after the launch.
extern "C" int wavefront_launch(const void* a, const void* b, const void* a_lens,
                                const void* b_lens, int n, int wa, int wb,
                                void* scratch, int blocks, void* out, void* stream) {
  const int rows = wa < wb ? wa : wb;
  if (blocks < 1 || n < 1 || (rows > 32 * kMaxR && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  wavefront_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<const int*>(a_lens), static_cast<const int*>(b_lens), n, wa, wb,
      static_cast<int*>(scratch), static_cast<int*>(out));
  return (int)cudaGetLastError();
}
