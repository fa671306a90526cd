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
// What bounds it on an H100: the bytes (nr rates read, ns written a lane;
// 2 flops per nonzero of N).
//
// Design: the grid and the contraction of fused_rhs.cu, from the same
// header (csr_rows.cuh): a (slices, lanes) grid; each block stages its
// lane's rates in shared memory (above 48 KB through the dynamic
// shared-memory attribute, above 227 KB refused) and sums its species
// rows one warp a row in a fixed order. There are no atomics, so the
// result is the same from run to run, and on equal rates it equals the
// fused RHS bit for bit.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

__global__ void __launch_bounds__(csr_rows::kThreads)
dd_contract_kernel(const double* __restrict__ r,
                   const int* __restrict__ row_ptr, const int* __restrict__ rxn,
                   const double* __restrict__ coef, double* __restrict__ du,
                   int ns, int nr, int n_slices) {
  extern __shared__ double sr[];  // (nr) reaction rates of this lane
  const int b = blockIdx.x / n_slices;
  const int slice = blockIdx.x - b * n_slices;
  const double* rb = r + static_cast<size_t>(b) * nr;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) sr[j] = rb[j];
  __syncthreads();

  csr_rows::contract(sr, row_ptr, rxn, coef, du + static_cast<size_t>(b) * ns,
                     ns, slice, n_slices);
}

}  // namespace

extern "C" int dd_contract_launch(const void* r, const void* row_ptr,
                                  const void* rxn, const void* coef, void* du,
                                  int batch, int ns, int nr, void* stream) {
  const size_t smem = static_cast<size_t>(nr) * sizeof(double);
  if (smem > csr_rows::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > csr_rows::kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        dd_contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_slices = csr_rows::slices(batch, ns);
  dd_contract_kernel<<<batch * n_slices, csr_rows::kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(r), static_cast<const int*>(row_ptr),
      static_cast<const int*>(rxn), static_cast<const double*>(coef),
      static_cast<double*>(du), ns, nr, n_slices);
  return static_cast<int>(cudaGetLastError());
}
