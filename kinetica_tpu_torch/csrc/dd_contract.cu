// f64 mass-action contraction du = r @ N for a batch of lanes.
//
// Replaces kinetica_tpu/ops/pallas_matmul.py::_dd_chunk_kernel (driven by
// _dd_call_slices, _make_dd_matmul and DDContraction). That kernel splits
// each f64 rate into three f32 slices, multiplies them exactly by the
// small-integer stoichiometry and sums with TwoSum compensation, one
// DD_CHUNK of 128 reactions per launch, because the TPU has no native
// f64. Hopper has native f64, so this kernel multiplies and sums in plain
// double and takes any real stoichiometry.
//
// What bounds it on an H100: nothing at the main path's size. One lane
// reads nr doubles and writes ns (about 9 KB at 1095 reactions / 73
// species), and does 2 flops per nonzero of N; launch latency dominates.
//
// Design: one block per lane. The block stages the lane's rates in shared
// memory (8.8 KB at 1095 reactions, above 48 KB through the dynamic
// shared-memory attribute), then one thread per species sums its row of
// the transposed stoichiometry (a CSR list of (reaction, coefficient)) in
// a fixed order. There are no atomics, so the result is the same from run
// to run. The summation loop is the second phase of fused_rhs.cu written
// the same way, so the two kernels agree bit for bit on equal rates.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void dd_contract_kernel(const double* __restrict__ r,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ rxn,
                                   const double* __restrict__ coef,
                                   double* __restrict__ du, int ns, int nr) {
  extern __shared__ double sr[];  // (nr) reaction rates of this lane
  const int b = blockIdx.x;
  const double* rb = r + static_cast<size_t>(b) * nr;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) sr[j] = rb[j];
  __syncthreads();

  double* dub = du + static_cast<size_t>(b) * ns;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    double acc = 0.0;
    for (int e = row_ptr[s]; e < row_ptr[s + 1]; ++e) acc += coef[e] * sr[rxn[e]];
    dub[s] = acc;
  }
}

}  // namespace

extern "C" int dd_contract_launch(const void* r, const void* row_ptr,
                                  const void* rxn, const void* coef, void* du,
                                  int batch, int ns, int nr, void* stream) {
  const size_t smem = static_cast<size_t>(nr) * sizeof(double);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dd_contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dd_contract_kernel<<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(r), static_cast<const int*>(row_ptr),
      static_cast<const int*>(rxn), static_cast<const double*>(coef),
      static_cast<double*>(du), ns, nr);
  return static_cast<int>(cudaGetLastError());
}
