// The species contraction du[s] = sum_j N[j, s] r[j] of one lane, shared by
// fused_rhs.cu and dd_contract.cu.
//
// N^T is stored as CSR rows per species, ordered by reaction. One warp
// sums one species row: the lanes stride its entries, so their loads are
// independent (a row of 240 entries is 8 loads a lane, not a chain of
// 240), and a fixed xor-shuffle tree combines the 32 partial sums. The
// order depends on the row and the warp width alone, never on the grid,
// so the result is the same from run to run, and the two kernels that
// include this header agree bit for bit on equal rates.
//
// The grid is (slices, lanes): each lane's species rows are dealt to
// `n_slices` blocks, so that a small batch still fills the card.
#pragma once

#include <cuda_runtime.h>

namespace csr_rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetBlocks = 264;             // two blocks on each of 132 SMs
constexpr size_t kMaxSmem = 227 * 1024;        // a block's dynamic limit
constexpr size_t kStaticSmem = 48 * 1024;      // without the attribute

// Blocks per lane: about kTargetBlocks in all, and no block with fewer
// species than warps.
inline int slices(int batch, int ns) {
  const int want = (kTargetBlocks + batch - 1) / batch;
  const int most = (ns + kWarps - 1) / kWarps;
  return want < most ? want : (most > 0 ? most : 1);
}

// du[sp] for the species sp = slice + n_slices * (w + kWarps * t) of this
// block's warps w; r holds the lane's rates (shared memory).
__device__ __forceinline__ void contract(const double* r,
                                         const int* __restrict__ row_ptr,
                                         const int* __restrict__ rxn,
                                         const double* __restrict__ coef,
                                         double* __restrict__ du, int ns,
                                         int slice, int n_slices) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int sp = slice + n_slices * warp; sp < ns; sp += n_slices * kWarps) {
    double acc = 0.0;
    const int end = row_ptr[sp + 1];
    for (int e = row_ptr[sp] + lane; e < end; e += 32)
      acc += coef[e] * r[rxn[e]];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) du[sp] = acc;
  }
}

}  // namespace csr_rows
