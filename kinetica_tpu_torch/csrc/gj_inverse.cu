// Batched f32 explicit inverse by Gauss-Jordan with partial pivoting.
//
// Replaces kinetica_tpu/ops/pallas_linalg.py::_gj_batch_kernel (launched by
// _gj_call, gj_inverse). Same elimination as the reference: for column k
// the pivot is the first row i >= k holding the column's largest |a_ik|
// (a NaN among them keeps row k); a pivot with |p| < 1e-30 is clamped to
// +-1e-30 (0 -> +1e-30) so that a singular member comes out huge but
// finite; the pivot row is multiplied by 1/p; row m takes old row k by
// arithmetic, x_m + (x_k - x_m), as the reference's does (an exact copy
// differs where x_k - x_m rounds: on a matrix that is singular in f32 a
// later pivot then cancels to exactly 0 and the inverse reaches the
// clamp); and every row subtracts its column-k multiple of the pivot row
// by one fused multiply-add, rounded once, as XLA's CPU backend runs the
// reference's update.
//
// What bounds it on an H100: the n sequential column steps. The arithmetic
// (2 n^3 flops, 7.8e5 at n = 73) and the traffic (2 n^2 floats per matrix)
// are small; each step's latency (publish a column, find the pivot,
// publish two rows, update) is what a call costs, so the design cuts the
// work, the branches and the barriers inside a step.
//
// Design (one 512-thread block per matrix):
// - The matrix lives in registers. Thread (warp w, lane l) owns rows
//   w + 16 i (i < 8) and columns l + 32 j (j < 4) of a 128 x 128 tile:
//   32 floats. Indices come from threadIdx. Rows and columns past n hold
//   zeros and meet only zeros in the shared vectors (zeroed at the start,
//   written below n only), so the update runs unmasked.
// - In-place Gauss-Jordan: n x n storage, column k replaced by the
//   inverse's column as it is eliminated (no [A | I] half: half the work).
//   The row exchange goes through the published rows; the column order
//   this leaves is undone on the write-out (the exchanges as column swaps
//   in reverse order), so the result keeps the first-max pivot order.
// - Per column step, two barriers: the owners of column k publish it into
//   a double-buffered shared vector; every warp finds the pivot itself
//   from it (a warp-shuffle argmax, no third barrier); the owners of rows
//   m and k publish them as they are, and every thread scales its four
//   entries of row m by 1 / p (the division stays off the owners' path);
//   the owners of row m add x_k - x_m to it (the exchange by arithmetic,
//   read from the published row k), and every thread updates its
//   registers with selects and one fused multiply-add an entry. The plain
//   version rounds each of these once too (its multiply-add in f64,
//   rounded to odd where rounding on to f32 could differ), so the kernel
//   equals gj_inverse_plain bit for bit (the same in-place elimination,
//   pivot order and write-out). The in-place form
//   holds the values of the reference's [A | I]: the exchange's arithmetic
//   is exact on the identity half's 0 and 1 entries that it leaves out.
// - Which thread owns row m, row k or column k is a predicate on each
//   register (row m's exchange: a branch per unrolled register row, on
//   that predicate), never a branch that picks a register: such a branch
//   on a data-dependent tile index made nvcc index the tile at run time
//   and move it to local memory (128 bytes of stack a thread). Row m's
//   exchange as a select on every entry, with row k held in four more
//   registers, made nvcc spill; as written, 79 registers and no stack
//   (CUDA 12.8, sm_90a).
// - Shared memory is the published vectors, 3 KB, static: no launch
//   attribute.
// The TPU kernel eliminated every batch member in lockstep with one-hot
// row masks over the whole [A | I] block; here each block indexes its own
// pivot row.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kMaxN / kWarps;  // rows of a thread: warp + 16 i
constexpr int kCols = kMaxN / 32;      // columns of a thread: lane + 32 j
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
gj_inverse_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  __shared__ float col_s[2][kMaxN];  // column k, by step parity
  __shared__ float rowp_s[kMaxN];    // pivot row m
  __shared__ float rowk_s[kMaxN];    // old row k (column k: 0)
  __shared__ int piv_s[kMaxN];       // pivot row of each step
  __shared__ int dst_s[kMaxN];       // output column of each stored column

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t mat = static_cast<size_t>(blockIdx.x) * n * n;
  const float* ab = a + mat;

  for (int e = threadIdx.x; e < kMaxN; e += kThreads)
    col_s[0][e] = col_s[1][e] = rowp_s[e] = rowk_s[e] = 0.0f;
  float x[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = warp + kWarps * i, c = lane + 32 * j;
      x[i][j] = (r < n && c < n) ? ab[r * n + c] : 0.0f;
    }
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    float* col = col_s[k & 1];
    // 1. the owners of column k publish it, then clear it: from here on
    //    the column collects the inverse's column
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const bool own = lane + 32 * j == k;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + kWarps * i;
        if (own && r < n) col[r] = x[i][j];
        x[i][j] = own ? 0.0f : x[i][j];
      }
    }
    __syncthreads();

    // 2. every warp finds the pivot row m (the same in every lane): the
    //    first row i >= k with the largest |a_ik|, row k if one is NaN
    float bv = -1.0f;
    int bi = n;
    bool nan = false;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int i = lane + 32 * q;
      const float v = (i >= k && i < n) ? fabsf(col[i]) : -1.0f;
      nan |= v != v;
      const bool t = v > bv;  // i grows with q: a tie keeps the earlier row
      bv = t ? v : bv;
      bi = t ? i : bi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      const bool t = (ov > bv) | ((ov == bv) & (oi < bi));
      bv = t ? ov : bv;
      bi = t ? oi : bi;
    }
    const int m = (__any_sync(kFull, nan) || bi >= n) ? k : bi;
    if (threadIdx.x == 0) piv_s[k] = m;

    // 3. the owners of rows m and k publish them (column k of both is
    //    already 0); every warp computes the clamped 1 / p
    if (warp == m % kWarps) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + kWarps * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = lane + 32 * j;
          if (r == m && c < n) rowp_s[c] = x[i][j];
        }
      }
    }
    if (warp == k % kWarps) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + kWarps * i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = lane + 32 * j;
          if (r == k && c < n) rowk_s[c] = x[i][j];
        }
      }
    }
    float p = col[m];
    if (fabsf(p) < kTiny) p = p < 0.0f ? -kTiny : kTiny;
    const float inv = 1.0f / p;
    __syncthreads();

    // 4. update: row k becomes the scaled pivot row (column k: 1 / p), row
    //    m becomes x_m + (x_k - x_m) (the exchange by arithmetic) minus
    //    its multiple (old a_kk) of it, every other row r minus a_rk times
    //    it, by one fused multiply-add. Row m is register row i of one
    //    warp: its branch is warp-uniform and indexes no register
    float pr[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      pr[j] = lane + 32 * j == k ? inv : __fmul_rn(rowp_s[lane + 32 * j], inv);
    const float fk = col[k];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp + kWarps * i;
      const bool is_m = r == m, is_k = r == k;
      if (is_m) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          x[i][j] = __fadd_rn(x[i][j],
                              __fsub_rn(rowk_s[lane + 32 * j], x[i][j]));
      }
      const float f = is_m ? fk : col[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        x[i][j] = is_k ? pr[j] : __fmaf_rn(-f, pr[j], x[i][j]);
    }
  }
  __syncthreads();

  // undo the exchanges as column swaps (k, piv[k]) in reverse order: each
  // stored column follows its position through them
  if (threadIdx.x < n) {
    int pos = threadIdx.x;
    for (int k = n - 1; k >= 0; --k) {
      const int m = piv_s[k];
      pos = pos == k ? m : (pos == m ? k : pos);
    }
    dst_s[threadIdx.x] = pos;
  }
  __syncthreads();

  float* ob = out + mat;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = warp + kWarps * i, c = lane + 32 * j;
      if (r < n && c < n) ob[r * n + dst_s[c]] = x[i][j];
    }
  }
}

}  // namespace

extern "C" int gj_inverse_launch(const void* a, void* out, int batch, int n,
                                 void* stream) {
  if (n < 1 || n > kMaxN || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gj_inverse_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
