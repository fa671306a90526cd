// Batched f32 explicit inverse by Gauss-Jordan with partial pivoting.
//
// Replaces kinetica_tpu/ops/pallas_linalg.py::_gj_batch_kernel (launched by
// _gj_call, gj_inverse). Same elimination as the reference: for column k
// the pivot is the first row i >= k holding the column's largest |a_ik|;
// a pivot with |p| < 1e-30 is clamped to +-1e-30 (0 -> +1e-30) so that a
// singular member comes out huge but finite; rows k and m swap, the pivot
// row is multiplied by 1/p, and every other row subtracts its column-k
// multiple of the pivot row, over the whole augmented [A | I] width.
//
// What bounds it on an H100: the n sequential column steps, each a block
// reduction plus three barriers. The arithmetic (n * n * 2n fused
// multiply-adds, 7.8e5 at n = 73) and the traffic (2 n^2 floats per
// matrix) are small; the barrier latency of n = 73 dependent steps is
// what a call costs.
//
// Design: one block per matrix, the augmented block in shared memory
// (n * 2n floats: 42.6 KB at n = 73, 131 KB at the n = 128 limit, above
// 48 KB through the dynamic shared-memory attribute). The pivot search is
// a warp-shuffle then cross-warp argmax with the lowest row winning ties;
// the row swap, the scaling and the elimination are strided over the
// block's threads. The TPU kernel eliminated every batch member in
// lockstep with one-hot row masks because it had no dynamic row indexing;
// here each block indexes its own pivot row directly.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void gj_inverse_kernel(const float* __restrict__ a,
                                  float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  const int w = 2 * n;
  float* aug = smem;          // (n, 2n) augmented [A | I]
  float* fac = aug + n * w;   // (n) column-k multipliers
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int piv_row;
  __shared__ float piv_inv;

  const int tid = threadIdx.x;
  const float* ab = a + static_cast<size_t>(blockIdx.x) * n * n;
  for (int e = tid; e < n * w; e += blockDim.x) {
    const int i = e / w, c = e - i * w;
    aug[e] = c < n ? ab[i * n + c] : (c - n == i ? 1.0f : 0.0f);
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // pivot search: largest |a_ik| over i >= k, lowest i on ties
    float v = -1.0f;
    int idx = n;
    for (int i = k + tid; i < n; i += blockDim.x) {
      const float x = fabsf(aug[i * w + k]);
      if (better(x, i, v, idx)) { v = x; idx = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, idx, off);
      if (better(ov, oi, v, idx)) { v = ov; idx = oi; }
    }
    if ((tid & 31) == 0) { red_v[tid >> 5] = v; red_i[tid >> 5] = idx; }
    __syncthreads();
    if (tid == 0) {
      float bv = red_v[0];
      int bi = red_i[0];
      for (int q = 1; q < kWarps; ++q)
        if (better(red_v[q], red_i[q], bv, bi)) { bv = red_v[q]; bi = red_i[q]; }
      if (bi >= n) bi = k;  // a NaN column: keep the diagonal row
      float p = aug[bi * w + k];
      if (fabsf(p) < kTiny) p = p < 0.0f ? -kTiny : kTiny;
      piv_row = bi;
      piv_inv = 1.0f / p;
    }
    __syncthreads();

    // swap rows k and m; row k becomes the scaled pivot row
    const int m = piv_row;
    const float inv = piv_inv;
    for (int c = tid; c < w; c += blockDim.x) {
      const float ak = aug[k * w + c];
      const float am = aug[m * w + c];
      aug[k * w + c] = am * inv;
      if (m != k) aug[m * w + c] = ak;
    }
    __syncthreads();

    for (int i = tid; i < n; i += blockDim.x)
      fac[i] = i == k ? 0.0f : aug[i * w + k];
    __syncthreads();

    for (int e = tid; e < n * w; e += blockDim.x) {
      const int i = e / w, c = e - i * w;
      if (i != k) aug[e] = aug[e] - fac[i] * aug[k * w + c];
    }
    __syncthreads();
  }

  float* ob = out + static_cast<size_t>(blockIdx.x) * n * n;
  for (int e = tid; e < n * n; e += blockDim.x) {
    const int i = e / n, c = e - i * n;
    ob[e] = aug[i * w + n + c];
  }
}

}  // namespace

extern "C" int gj_inverse_launch(const void* a, void* out, int batch, int n,
                                 void* stream) {
  const size_t smem = static_cast<size_t>(n) * (2 * n + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gj_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gj_inverse_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
