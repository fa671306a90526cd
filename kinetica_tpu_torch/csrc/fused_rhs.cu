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
// What bounds it on an H100: nothing at the main path's size. One lane
// reads (ns + 1 + nr) doubles and writes ns (about 10 KB at 1095
// reactions / 73 species), so a B=64 call moves well under 1 MB and does
// about 5e5 flops: launch latency dominates.
//
// Design: one block per lane. The block stages u_aug in shared memory,
// computes every reaction rate r_j into shared memory (8.8 KB at 1095
// reactions), synchronises, then one thread per species sums its row of
// the transposed stoichiometry (a CSR list of (reaction, coefficient))
// in a fixed order. There are no atomics, so the result is the same from
// run to run and step counts do not wander. Above 48 KB of rates the
// launch raises the block's dynamic shared-memory limit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void fused_rhs_kernel(const double* __restrict__ u_aug,
                                 const double* __restrict__ k,
                                 const int* __restrict__ slots,
                                 const int* __restrict__ row_ptr,
                                 const int* __restrict__ rxn,
                                 const double* __restrict__ coef,
                                 double* __restrict__ du,
                                 int ns, int nr, int arity) {
  extern __shared__ double smem[];
  double* su = smem;            // (ns + 1) clipped concentrations and 1
  double* r = smem + (ns + 1);  // (nr) reaction rates
  const int b = blockIdx.x;
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

  double* dub = du + static_cast<size_t>(b) * ns;
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    double acc = 0.0;
    for (int e = row_ptr[s]; e < row_ptr[s + 1]; ++e) acc += coef[e] * r[rxn[e]];
    dub[s] = acc;
  }
}

}  // namespace

extern "C" int fused_rhs_launch(const void* u_aug, const void* k,
                                const void* slots, const void* row_ptr,
                                const void* rxn, const void* coef, void* du,
                                int batch, int ns, int nr, int arity,
                                void* stream) {
  const size_t smem = static_cast<size_t>(ns + 1 + nr) * sizeof(double);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fused_rhs_kernel<<<batch, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(u_aug), static_cast<const double*>(k),
      static_cast<const int*>(slots), static_cast<const int*>(row_ptr),
      static_cast<const int*>(rxn), static_cast<const double*>(coef),
      static_cast<double*>(du), ns, nr, arity);
  return static_cast<int>(cudaGetLastError());
}
