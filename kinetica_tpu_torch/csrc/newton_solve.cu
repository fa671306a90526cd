// Newton solve (I - c J) dy = b with an f32 preconditioner and adaptive
// refinement, one launch for a batch of lanes.
//
// Replaces kinetica_tpu/ops/pallas_linalg.py::_newton_solve_kernel
// (driven by _make_fused_solve and fused_newton_solve). Same algorithm,
// per lane:
//     dy = M b                                  (f32 matvec)
//     sweep: r = b - (dy - c * (J dy))          (J dy in f32, r in f64)
//            corr = M r; dy += corr             (f32 matvec, f64 update)
// One sweep is mandatory; further sweeps run while
// ||corr||_2 > 1e-4 * max(||dy||_2, 1e-30) (f32 norms), up to n_sweeps
// sweeps in all. A lane that stops is frozen. The reference carries b, c,
// the residual and dy as double-f32 pairs; Hopper has native f64, so they
// are doubles here.
//
// What bounds it on an H100: the dependent chain of up to 2 n_sweeps + 1
// matvecs of one lane, each a few microseconds of barrier-separated work.
// Per lane M and J are 2 n^2 floats (42.6 KB at n = 73, 262 KB at n = 181,
// 2 MB at n = 512), read from global memory up to 2 n_sweeps + 1 times; a
// B=64 call moves under 3 MB from device memory at n = 73 and about 17 MB
// at n = 181 (each pass of it from the L2 cache).
//
// Design: one block per lane, so the lane's stop test needs no host read
// and no other lane. M and J stay in global memory; the vectors (b, dy in
// f64, the matvec input and output in f32) live in shared memory. Each
// warp owns rows i, i + 8, ...; its 32 threads sum strided columns and a
// butterfly shuffle finishes the row, so every sum has a fixed order and
// the result is the same from run to run. n is at most 512, the widest
// system the block-Schur inverse factors; that sizes the shared vectors
// statically (2 x 512 doubles + 2 x 512 floats = 12 KB, under the 48 KB a
// block may hold statically), so no launch needs a dynamic size.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 512;

// out[i] = sum_j A[i, j] v[j] for the (n, n) row-major f32 matrix A.
__device__ __forceinline__ void matvec(const float* __restrict__ A,
                                       const float* v, float* out, int n) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < n; i += kWarps) {
    const float* row = A + static_cast<size_t>(i) * n;
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) acc += row[j] * v[j];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[i] = acc;
  }
}

__global__ void newton_solve_kernel(const float* __restrict__ M,
                                    const float* __restrict__ J,
                                    const double* __restrict__ b,
                                    const double* __restrict__ c,
                                    double* __restrict__ dy_out, int n,
                                    int n_sweeps) {
  __shared__ double sb[kMaxN];
  __shared__ double sdy[kMaxN];
  __shared__ float v[kMaxN];
  __shared__ float w[kMaxN];
  __shared__ float red_c[kWarps];
  __shared__ float red_d[kWarps];
  __shared__ int more;

  const int tid = threadIdx.x;
  const size_t vec = static_cast<size_t>(blockIdx.x) * n;
  const float* Mb = M + vec * n;
  const float* Jb = J + vec * n;
  const double cb = c[blockIdx.x];

  for (int i = tid; i < n; i += kThreads) {
    sb[i] = b[vec + i];
    v[i] = static_cast<float>(sb[i]);
  }
  __syncthreads();
  matvec(Mb, v, w, n);
  __syncthreads();
  for (int i = tid; i < n; i += kThreads) sdy[i] = static_cast<double>(w[i]);
  if (tid == 0) more = 1;
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps && more; ++sweep) {
    for (int i = tid; i < n; i += kThreads) v[i] = static_cast<float>(sdy[i]);
    __syncthreads();
    matvec(Jb, v, w, n);                                  // J dy
    __syncthreads();
    for (int i = tid; i < n; i += kThreads)
      v[i] = static_cast<float>(sb[i] - (sdy[i] - cb * static_cast<double>(w[i])));
    __syncthreads();
    matvec(Mb, v, w, n);                                  // corr = M r
    __syncthreads();

    float nc = 0.0f, nd = 0.0f;
    for (int i = tid; i < n; i += kThreads) {
      const double y = sdy[i] + static_cast<double>(w[i]);
      sdy[i] = y;
      const float y32 = static_cast<float>(y);
      nc += w[i] * w[i];
      nd += y32 * y32;
    }
    for (int off = 16; off > 0; off >>= 1) {
      nc += __shfl_xor_sync(0xffffffffu, nc, off);
      nd += __shfl_xor_sync(0xffffffffu, nd, off);
    }
    if ((tid & 31) == 0) { red_c[tid >> 5] = nc; red_d[tid >> 5] = nd; }
    __syncthreads();
    if (tid == 0) {
      float sc = 0.0f, sd = 0.0f;
      for (int q = 0; q < kWarps; ++q) { sc += red_c[q]; sd += red_d[q]; }
      more = sqrtf(sc) > 1e-4f * fmaxf(sqrtf(sd), 1e-30f);
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += kThreads) dy_out[vec + i] = sdy[i];
}

}  // namespace

extern "C" int newton_solve_launch(const void* M, const void* J, const void* b,
                                   const void* c, void* dy, int batch, int n,
                                   int n_sweeps, void* stream) {
  if (n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  newton_solve_kernel<<<batch, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(M), static_cast<const float*>(J),
      static_cast<const double*>(b), static_cast<const double*>(c),
      static_cast<double*>(dy), n, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}
