// Start-up probe: a grid of blocks accumulating into one output.
//
// Replaces the probe kernel `k` of
// kinetica_tpu/ops/pallas_matmul.py::fused_grid_supported, which runs a
// 2-step Pallas grid whose steps add an (8, 128) f32 block of ones into one
// output block that stays resident, and checks that the result is 2.0.
// The reference uses the answer to choose between the grid and the scan
// form of its fused RHS kernel.
//
// Here the grid's blocks run in parallel on different SMs, so they
// accumulate into the output (zeroed by the caller) with atomicAdd.
// Adding 1.0 to 0.0 or 1.0 is exact in f32, so every element must come
// out as exactly the number of blocks whatever the order of the adds.
//
// What bounds it on an H100: launch latency only (2 blocks, 1024 atomic
// adds). It runs once per process.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void grid_probe_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) atomicAdd(out + i, x[i]);
}

}  // namespace

extern "C" int grid_probe_launch(const void* x, void* out, int n, int blocks,
                                 void* stream) {
  grid_probe_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
