// Batched explicit inverse by Gauss-Jordan with partial pivoting, in f32
// (gj_inverse_kernel) or f64 (gj_inverse64_kernel): one elimination,
// written once as a template over the element type. The Newton factor
// runs the f64 kernel; the f32 one has no caller on the solve path and
// stands as the witness that the elimination is the reference's.
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
// - The f64 elimination is the same, each operation rounded once in f64,
//   except the update, which rounds its product and its difference apart
//   (the plain version's f64 arithmetic, so the two agree bit for bit); its
//   tile is 32 doubles a thread.
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
constexpr unsigned kFull = 0xffffffffu;

// each operation rounded once, in the element type
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
// x - f p: one fused multiply-add in f32 (the reference's rounding); in f64
// the product and the difference rounded apart (the plain version's)
__device__ __forceinline__ float update(float x, float f, float p) {
  return __fmaf_rn(-f, p, x);
}
__device__ __forceinline__ double update(double x, double f, double p) {
  return __dsub_rn(x, __dmul_rn(f, p));
}

template <typename T>
__device__ __forceinline__ void gj_inverse_body(const T* __restrict__ a,
                                                T* __restrict__ out, int n) {
  constexpr T kTiny = T(1e-30);
  __shared__ T col_s[2][kMaxN];  // column k, by step parity
  __shared__ T rowp_s[kMaxN];    // pivot row m
  __shared__ T rowk_s[kMaxN];    // old row k (column k: 0)
  __shared__ int piv_s[kMaxN];   // pivot row of each step
  __shared__ int dst_s[kMaxN];   // output column of each stored column

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t mat = static_cast<size_t>(blockIdx.x) * n * n;
  const T* ab = a + mat;

  for (int e = threadIdx.x; e < kMaxN; e += kThreads)
    col_s[0][e] = col_s[1][e] = rowp_s[e] = rowk_s[e] = T(0);
  T x[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = warp + kWarps * i, c = lane + 32 * j;
      x[i][j] = (r < n && c < n) ? ab[r * n + c] : T(0);
    }
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    T* col = col_s[k & 1];
    // 1. the owners of column k publish it, then clear it: from here on
    //    the column collects the inverse's column
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const bool own = lane + 32 * j == k;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + kWarps * i;
        if (own && r < n) col[r] = x[i][j];
        x[i][j] = own ? T(0) : x[i][j];
      }
    }
    __syncthreads();

    // 2. every warp finds the pivot row m (the same in every lane): the
    //    first row i >= k with the largest |a_ik|, row k if one is NaN
    T bv = T(-1);
    int bi = n;
    bool nan = false;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int i = lane + 32 * q;
      const T v = (i >= k && i < n) ? abs_of(col[i]) : T(-1);
      nan |= v != v;
      const bool t = v > bv;  // i grows with q: a tie keeps the earlier row
      bv = t ? v : bv;
      bi = t ? i : bi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_xor_sync(kFull, bv, off);
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
    T p = col[m];
    if (abs_of(p) < kTiny) p = p < T(0) ? -kTiny : kTiny;
    const T inv = T(1) / p;
    __syncthreads();

    // 4. update: row k becomes the scaled pivot row (column k: 1 / p), row
    //    m becomes x_m + (x_k - x_m) (the exchange by arithmetic) minus
    //    its multiple (old a_kk) of it, every other row r minus a_rk times
    //    it, by one fused multiply-add. Row m is register row i of one
    //    warp: its branch is warp-uniform and indexes no register
    T pr[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      pr[j] = lane + 32 * j == k ? inv : mul_rn(rowp_s[lane + 32 * j], inv);
    const T fk = col[k];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp + kWarps * i;
      const bool is_m = r == m, is_k = r == k;
      if (is_m) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          x[i][j] = add_rn(x[i][j], sub_rn(rowk_s[lane + 32 * j], x[i][j]));
      }
      const T f = is_m ? fk : col[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        x[i][j] = is_k ? pr[j] : update(x[i][j], f, pr[j]);
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

  T* ob = out + mat;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int r = warp + kWarps * i, c = lane + 32 * j;
      if (r < n && c < n) ob[r * n + dst_s[c]] = x[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gj_inverse_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  gj_inverse_body(a, out, n);
}

__global__ void __launch_bounds__(kThreads)
gj_inverse64_kernel(const double* __restrict__ a, double* __restrict__ out,
                    int n) {
  gj_inverse_body(a, out, n);
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

extern "C" int gj_inverse64_launch(const void* a, void* out, int batch, int n,
                                   void* stream) {
  if (n < 1 || n > kMaxN || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  gj_inverse64_kernel<<<batch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<double*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
