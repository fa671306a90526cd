// Fused mass-action right-hand side for a batch of lanes (f64).
//
// Replaces kinetica_tpu/ops/pallas_matmul.py::_fused_grid_kernel and
// ::_fused_scan_kernel (launched by _fused_call, class FusedMassActionRHS).
// Those kernels compute, for every lane b,
//     du[b, s] = sum_j N[j, s] * k[b, j] * prod_slot u_aug[b, slot[j, slot]]
// with double-f32 pairs, one-hot MXU gathers and a TwoSum-compensated
// contraction, because the TPU has no native f64. Hopper has native f64,
// so this kernel gathers, multiplies and sums in plain double.
//
// What bounds it on an H100: the bytes, k above all (nr doubles a lane:
// 2.3 MB at 4473 reactions and B = 64, 0.7 us at 3.35 TB/s); the f64
// arithmetic (arity + 2 nnz flops a lane) is far below. What held the
// first version back was the grid (one block a lane: 64 of 132 SMs at
// B = 64, one at B = 1) and its contraction (one thread a species row, a
// chain of up to 240 dependent loads).
//
// Design: a (slices, lanes) grid, slices chosen so that the grid fills
// the card (csr_rows::slices). Every block of a lane stages u_aug and
// computes all of the lane's rates r_j into shared memory (k read
// coalesced; the other slices' reads of it hit L2), synchronises, then
// contracts its own species rows one warp a row (csr_rows.cuh, shared with
// dd_contract.cu). There are no atomics, so the result is the same from
// run to run. Above 48 KB of rates the launch raises the block's dynamic
// shared-memory limit; above 227 KB it refuses.
#include <cuda_runtime.h>

#include "csr_rows.cuh"

namespace {

__global__ void __launch_bounds__(csr_rows::kThreads)
fused_rhs_kernel(const double* __restrict__ u_aug,
                 const double* __restrict__ k, const int* __restrict__ slots,
                 const int* __restrict__ row_ptr, const int* __restrict__ rxn,
                 const double* __restrict__ coef, double* __restrict__ du,
                 int ns, int nr, int arity, int n_slices) {
  extern __shared__ double smem[];
  double* su = smem;            // (ns + 1) clipped concentrations and 1
  double* r = smem + (ns + 1);  // (nr) reaction rates
  const int b = blockIdx.x / n_slices;
  const int slice = blockIdx.x - b * n_slices;
  const double* ub = u_aug + static_cast<size_t>(b) * (ns + 1);
  const double* kb = k + static_cast<size_t>(b) * nr;

  for (int i = threadIdx.x; i < ns + 1; i += blockDim.x) su[i] = ub[i];
  __syncthreads();

  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    const int* sj = slots + static_cast<size_t>(j) * arity;
    double p = su[sj[0]];
    for (int s = 1; s < arity; ++s) p *= su[sj[s]];
    r[j] = kb[j] * p;
  }
  __syncthreads();

  csr_rows::contract(r, row_ptr, rxn, coef, du + static_cast<size_t>(b) * ns,
                     ns, slice, n_slices);
}

}  // namespace

extern "C" int fused_rhs_launch(const void* u_aug, const void* k,
                                const void* slots, const void* row_ptr,
                                const void* rxn, const void* coef, void* du,
                                int batch, int ns, int nr, int arity,
                                void* stream) {
  const size_t smem = static_cast<size_t>(ns + 1 + nr) * sizeof(double);
  if (smem > csr_rows::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > csr_rows::kStaticSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_slices = csr_rows::slices(batch, ns);
  fused_rhs_kernel<<<batch * n_slices, csr_rows::kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(u_aug), static_cast<const double*>(k),
      static_cast<const int*>(slots), static_cast<const int*>(row_ptr),
      static_cast<const int*>(rxn), static_cast<const double*>(coef),
      static_cast<double*>(du), ns, nr, arity, n_slices);
  return static_cast<int>(cudaGetLastError());
}
