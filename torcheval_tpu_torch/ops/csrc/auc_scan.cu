// Exact tie-aware AUC over rows already sorted by descending score.
//
// Replaces the TPU kernel torcheval_tpu/ops/pallas_auc.py::_auc_scan_kernel
// (entry auc_from_sorted).  Per row, in Mann-Whitney form:
//
//     acc  = sum over tie groups g of  P_g * (end_fp_g + prevend_fp_g)
//     area = P * N_neg - acc / 2,      AUC = area / (P * N_neg)
//
// with P_g the group's positives, end_fp_g / prevend_fp_g the cumulative
// negatives at the end of the group and of the group before it, and 0.5
// for a row with no positives or no negatives.  A group is settled at the
// first element of the NEXT group (t[i] != t[i-1]), whose exclusive
// cumulative counts are the group's end values; the row's last group is
// settled after the loop from the row totals.
//
// Design.  One block per row loops over tiles of 4096 elements (256
// threads x 16 consecutive elements each), carrying per-row scalars from
// tile to tile: the running positive/negative counts, the counts at the
// last group boundary, and the last threshold.  That loop takes the place
// of the TPU grid's sequential axis.  Per tile: a coalesced load into
// shared memory, an exclusive block scan of each thread's positives, an
// exclusive block max-scan of the boundary counts (cumulative counts only
// grow, so the nearest boundary to the left is the max), then each thread
// walks its 16 elements again and adds its groups' products.  The products
// are summed EXACTLY in int64 (acc < 2^61 for N < 2^31), so the result
// does not depend on summation order and equals the plain PyTorch version
// bit for bit; the JAX kernel's Kahan f32 sum agrees bitwise while its
// partial sums stay below 2^24.  The final f32 arithmetic is spelled with
// _rn intrinsics so nvcc cannot contract it into an FMA.
//
// Bound on the H100: bytes (each sorted score, 4 B, and hit, 1 B, read
// once).  Known weakness: one row runs on one SM, so a single long binary
// row (2^22 samples) uses 1 of 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;
constexpr unsigned kFull = 0xffffffffu;

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Exclusive scan of one int per thread across the block; `*total` gets the
// reduction over all threads.  `buf` holds kWarps + 1 ints.  Every thread
// of the block must call it.
template <class Op>
__device__ int block_scan_exclusive(int v, Op op, int identity, int* buf,
                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = op(incl, y);
  }
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? buf[lane] : identity;
    for (int d = 1; d < kWarps; d <<= 1) {
      int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = op(w, y);
    }
    if (lane < kWarps) buf[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int prefix = warp > 0 ? buf[warp - 1] : identity;
  *total = buf[kWarps - 1];
  __syncthreads();  // buf is reused by the next scan
  return op(prefix, excl);
}

__global__ void __launch_bounds__(kThreads)
auc_scan_kernel(const float* __restrict__ thresholds,
                const uint8_t* __restrict__ hits, long long n,
                float* __restrict__ out) {
  __shared__ float s_t[kTile];
  __shared__ uint8_t s_h[kTile];
  __shared__ int s_buf[kWarps + 1];
  __shared__ long long s_red[kWarps];

  const int tid = threadIdx.x;
  const float* t_row = thresholds + (long long)blockIdx.x * n;
  const uint8_t* h_row = hits + (long long)blockIdx.x * n;

  // Per-row carries, identical in every thread.
  int cum_tp = 0, cum_fp = 0;  // counts before this tile
  int pe_tp = 0, pe_fp = 0;    // counts at the last group boundary
  float prev_t = 0.0f;         // last threshold of the previous tile
  long long acc = 0;           // this thread's share of the group sum

  for (long long base = 0; base < n; base += kTile) {
    const int valid = (int)(n - base < kTile ? n - base : kTile);
    for (int k = tid; k < valid; k += kThreads) {
      s_t[k] = t_row[base + k];
      s_h[k] = h_row[base + k] != 0;
    }
    __syncthreads();

    const int lo = tid * kPerThread;
    const int hi_end = min(lo + kPerThread, valid);
    // First walk: this thread's positives and its last boundary, counted
    // from the start of its elements.
    int my_tp = 0, last_tp = -1, last_fp = -1;
    for (int k = lo; k < hi_end; ++k) {
      bool flag = k > 0 ? s_t[k] != s_t[k - 1] : (base > 0 && s_t[0] != prev_t);
      if (flag) {
        last_tp = my_tp;
        last_fp = (k - lo) - my_tp;
      }
      my_tp += s_h[k];
    }
    int tile_tp;
    const int ex_tp = block_scan_exclusive(my_tp, Sum(), 0, s_buf, &tile_tp);
    const int start = lo < valid ? lo : valid;
    const int ex_fp = start - ex_tp;
    // Absolute counts at this thread's last boundary (-1: none).
    int b_tp = -1, b_fp = -1;
    if (last_tp >= 0) {
      b_tp = cum_tp + ex_tp + last_tp;
      b_fp = cum_fp + ex_fp + last_fp;
    }
    int max_tp, max_fp;
    int prev_tp = block_scan_exclusive(b_tp, Max(), -1, s_buf, &max_tp);
    int prev_fp = block_scan_exclusive(b_fp, Max(), -1, s_buf, &max_fp);
    if (prev_tp < 0) {  // no boundary earlier in this tile
      prev_tp = pe_tp;
      prev_fp = pe_fp;
    }
    // Second walk: settle each group that ends before one of our elements.
    int run_tp = cum_tp + ex_tp, run_fp = cum_fp + ex_fp;
    for (int k = lo; k < hi_end; ++k) {
      bool flag = k > 0 ? s_t[k] != s_t[k - 1] : (base > 0 && s_t[0] != prev_t);
      if (flag) {
        acc += (long long)(run_tp - prev_tp) * ((long long)run_fp + prev_fp);
        prev_tp = run_tp;
        prev_fp = run_fp;
      }
      int h = s_h[k];
      run_tp += h;
      run_fp += 1 - h;
    }
    if (max_tp >= 0) {
      pe_tp = max_tp;
      pe_fp = max_fp;
    }
    cum_tp += tile_tp;
    cum_fp += valid - tile_tp;
    prev_t = s_t[valid - 1];
    __syncthreads();  // the next tile overwrites s_t / s_h
  }

  for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(kFull, acc, d);
  if ((tid & 31) == 0) s_red[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_red[w];
    // The row's last group ends at its last element.
    total += (long long)(cum_tp - pe_tp) * ((long long)cum_fp + pe_fp);
    float factor = __fmul_rn(__int2float_rn(cum_tp), __int2float_rn(cum_fp));
    float area = __fsub_rn(factor, __fmul_rn(0.5f, __ll2float_rn(total)));
    out[blockIdx.x] = factor == 0.0f ? 0.5f : __fdiv_rn(area, factor);
  }
}

}  // namespace

// thresholds (rows, n) f32 and hits (rows, n) 1-byte 0/1, both contiguous,
// rows sorted by descending threshold; out (rows,) f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int auc_scan_launch(const void* thresholds, const void* hits,
                               int rows, long long n, void* out, void* stream) {
  auc_scan_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thresholds), static_cast<const uint8_t*>(hits),
      n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
