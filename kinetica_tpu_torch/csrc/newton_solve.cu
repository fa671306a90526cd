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
// What bounds it on an H100: the bytes. Per lane M and J are 2 n^2 floats
// (42.6 KB at n = 73, 262 KB at n = 181, 2 MB at n = 512) and the rest is
// a few vectors; read once, a B=64 call at n = 181 moves 16.8 MB, 5.0 us
// at 3.35 TB/s. The work (2 n^2 flops a matvec, at most 2 n_sweeps + 1
// dependent matvecs) is far below the f32 rate.
//
// Design: one lane over a thread-block cluster of cs blocks (cs = 1, 2, 4,
// 8 or 16, chosen by ops/newton_solve.py::_cluster_plan: the smallest cs
// whose slabs fit in shared memory, doubled while the grid still fits the
// SMs once and each block keeps a row per warp). Block `rank` owns rows
// [rank n / cs, (rank + 1) n / cs) and
// - stages its rows of M and J in shared memory once (cp.async, M's slab
//   first so dy = M b starts while J's is in flight); every matvec after
//   that reads shared memory, so M and J leave device memory once;
// - keeps b and dy in f64 for its own rows, and the matvec inputs dy32, r
//   and corr in f32 for all n rows: each block computes its rows and
//   stores the f32 values into every block's copy (distributed shared
//   memory, cooperative_groups::this_cluster().map_shared_rank).
// Per sweep: J dy on own rows -> r to every block -> cluster barrier A;
// M r on own rows, dy += corr -> corr and dy32 to every block -> cluster
// barrier B; then every block computes the stop test itself over its
// gathered corr and dy32, so all blocks of a cluster reach the same
// decision without another exchange. dy32, r and corr have separate
// buffers, so the two barriers order each store after the peers' last
// read of that buffer (r is read before B, dy32 and corr before the next
// A). Every store into another block's shared memory is followed by a
// cluster barrier that all blocks of the cluster pass before they exit,
// so no block exits while a peer may still write to it. A first cluster
// barrier makes sure every block of the cluster has started before the
// first remote store: a block arrives as it starts and waits just before
// that store, so the barrier's latency hides behind the staging. A warp
// sums its rows four at a time, side by side, so their dependent adds and
// shuffles overlap.
//
// Bit-equal to the one-block-per-lane kernel this replaced, at every cs:
// each row's dot product is summed in the same order (lane j takes
// columns j, j + 32, ..., then an xor butterfly 16-8-4-2-1; every lane
// ends with lane 0's value), the elementwise expressions are written as
// they were (nvcc contracts them the same way), and the stop test sums in
// the same order (thread t of 256 takes i = t mod 256, butterfly, then
// the 8 warp partials in order).
//
// Traps:
// - cp.async.bulk (TMA's 1-D copy) needs 16-byte-aligned addresses and
//   sizes; a row of M is 4 n bytes (292 B at n = 73, 724 B at n = 181) and
//   a lane 4 n^2 (21316 B, 131044 B), all = 4 mod 16. The staging here
//   uses cp.async with 16-byte pieces over the aligned body of a slab
//   and 4-byte pieces at its ends; the slab starts in shared memory at
//   the same offset mod 16 as in device memory.
// - n = 512 needs cs = 16 (2 MB a lane; 8 blocks would hold 262 KB each),
//   a non-portable cluster size, and above 48 KB of dynamic shared memory:
//   both attributes are set before the first launch. A plan the card
//   cannot schedule (cudaOccupancyMaxActiveClusters = 0) is refused by the
//   wrapper, never replaced by another kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr int kRowsInFlight = 4;  // rows a warp sums side by side

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// The shared memory of one block, in this order: b and dy for its rows
// (f64), the M and J slabs (each with 3 floats of slack, so a slab can
// start at its device offset mod 16 bytes), dy32, r and corr for all n
// rows (f32), the 2 x 8 warp partials of the stop test.
struct Layout {
  int rows, slab, vec;
  __host__ __device__ Layout(int n, int cs)
      : rows((n + cs - 1) / cs), slab(pad4(rows * n + 3)), vec(pad4(n)) {}
  __host__ __device__ size_t bytes() const {
    return 2 * rows * sizeof(double) +
           (2 * static_cast<size_t>(slab) + 3 * vec + 2 * kWarps) * sizeof(float);
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Starts the copy of `count` floats from src into the 16-byte-aligned
// `region` and returns where the copy begins in it: at src's offset mod
// 16 bytes, so that the body moves in 16-byte pieces.
__device__ __forceinline__ const float* stage(float* region, const float* src,
                                              int count) {
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* dst = region + mis;
  const int head = min((4 - mis) & 3, count);
  const int body = (count - head) >> 2;
  for (int k = threadIdx.x; k < head; k += kThreads) cp_async4(dst + k, src + k);
  for (int k = threadIdx.x; k < body; k += kThreads)
    cp_async16(dst + head + 4 * k, src + head + 4 * k);
  for (int k = head + 4 * body + threadIdx.x; k < count; k += kThreads)
    cp_async4(dst + k, src + k);
  return dst;
}

// acc[q] = sum_j A[il0 + 8 q, j] v[j] for the rows il0 + 8 q < rows of the
// row-major slab A, one warp: lane j takes columns j, j + 32, ... of each
// row and the butterfly leaves each row's sum in every lane. The rows are
// summed side by side, so their dependent adds and shuffles overlap; each
// row's own order is that of one row alone.
__device__ __forceinline__ void rows_dot(const float* A, const float* v,
                                         int n, int lane, int il0, int rows,
                                         float (&acc)[kRowsInFlight]) {
#pragma unroll
  for (int q = 0; q < kRowsInFlight; ++q) acc[q] = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float vj = v[j];
#pragma unroll
    for (int q = 0; q < kRowsInFlight; ++q)
      if (il0 + q * kWarps < rows) acc[q] += A[(il0 + q * kWarps) * n + j] * vj;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < kRowsInFlight; ++q)
      acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
  }
}

// The two halves of a cluster barrier, for the first one: a block arrives
// as it starts and waits only before its first store into a peer.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
    newton_solve_kernel(const float* __restrict__ M, const float* __restrict__ J,
                        const double* __restrict__ b,
                        const double* __restrict__ c,
                        double* __restrict__ dy_out, int n, int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L(n, cs);
  double* sb = reinterpret_cast<double*>(smem);
  double* sdy = sb + L.rows;
  float* region_m = reinterpret_cast<float*>(sdy + L.rows);
  float* region_j = region_m + L.slab;
  float* dy32 = region_j + L.slab;
  float* rv = dy32 + L.vec;
  float* corr = rv + L.vec;
  float* red_c = corr + L.vec;
  float* red_d = red_c + kWarps;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t sys = blockIdx.x / cs;  // the lane of the batch
  const size_t vec = sys * n;
  const int lo = rank * n / cs;
  const int rows = (rank + 1) * n / cs - lo;
  constexpr int kStride = kWarps * kRowsInFlight;  // a warp's row groups
  float acc[kRowsInFlight];

  cluster_arrive_relaxed();       // S: this block has started
  const float* sM = stage(region_m, M + (vec + lo) * n, rows * n);
  cp_async_commit();
  const float* sJ = stage(region_j, J + (vec + lo) * n, rows * n);
  cp_async_commit();
  for (int i = tid; i < rows; i += kThreads) sb[i] = b[vec + lo + i];
  for (int i = tid; i < n; i += kThreads) rv[i] = static_cast<float>(b[vec + i]);
  const double cb = c[sys];
  // lane p < cs stores a row's value into block p's copy
  const bool sender = lane < cs;
  const unsigned peer = sender ? lane : 0;
  float* const peer_dy32 = cluster.map_shared_rank(dy32, peer);
  float* const peer_rv = cluster.map_shared_rank(rv, peer);
  float* const peer_corr = cluster.map_shared_rank(corr, peer);
  cp_async_wait<1>();
  __syncthreads();                // M's slab and rv visible in the block
  cluster_wait();                 // S: every block of the cluster started

  for (int il0 = warp; il0 < rows; il0 += kStride) {        // dy = M b
    rows_dot(sM, rv, n, lane, il0, rows, acc);
#pragma unroll
    for (int q = 0; q < kRowsInFlight; ++q) {
      const int il = il0 + q * kWarps;
      if (il >= rows) continue;
      if (lane == 0) sdy[il] = static_cast<double>(acc[q]);
      if (sender) peer_dy32[lo + il] = acc[q];
    }
  }
  cp_async_wait<0>();
  cluster.sync();                 // dy32 gathered; J's slab visible

  bool more = true;
  for (int sweep = 0; sweep < n_sweeps && more; ++sweep) {
    for (int il0 = warp; il0 < rows; il0 += kStride) {      // r = b - (dy - c J dy)
      rows_dot(sJ, dy32, n, lane, il0, rows, acc);
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const int il = il0 + q * kWarps;
        if (il >= rows) continue;
        const float r = static_cast<float>(
            sb[il] - (sdy[il] - cb * static_cast<double>(acc[q])));
        if (sender) peer_rv[lo + il] = r;
      }
    }
    cluster.sync();               // A: r gathered
    for (int il0 = warp; il0 < rows; il0 += kStride) {      // corr = M r; dy += corr
      rows_dot(sM, rv, n, lane, il0, rows, acc);
#pragma unroll
      for (int q = 0; q < kRowsInFlight; ++q) {
        const int il = il0 + q * kWarps;
        if (il >= rows) continue;
        const double y = sdy[il] + static_cast<double>(acc[q]);
        __syncwarp();
        if (lane == 0) sdy[il] = y;
        if (sender) {
          peer_corr[lo + il] = acc[q];
          peer_dy32[lo + il] = static_cast<float>(y);
        }
      }
    }
    cluster.sync();               // B: corr and dy32 gathered

    float nc = 0.0f, nd = 0.0f;
    for (int i = tid; i < n; i += kThreads) {
      nc += corr[i] * corr[i];
      nd += dy32[i] * dy32[i];
    }
    for (int off = 16; off > 0; off >>= 1) {
      nc += __shfl_xor_sync(0xffffffffu, nc, off);
      nd += __shfl_xor_sync(0xffffffffu, nd, off);
    }
    if (lane == 0) { red_c[warp] = nc; red_d[warp] = nd; }
    __syncthreads();
    float sc = 0.0f, sd = 0.0f;
    for (int q = 0; q < kWarps; ++q) { sc += red_c[q]; sd += red_d[q]; }
    more = sqrtf(sc) > 1e-4f * fmaxf(sqrtf(sd), 1e-30f);
  }

  for (int i = tid; i < rows; i += kThreads) dy_out[vec + lo + i] = sdy[i];
}

bool valid_cluster(int cs) {
  return cs == 1 || cs == 2 || cs == 4 || cs == 8 || cs == kMaxCluster;
}

// The two function attributes, once per device: the non-portable cluster
// size 16 and the opt-in dynamic shared memory, whose size is returned.
cudaError_t prepare(int* optin) {
  static int optin_of[kMaxDevices] = {};  // 0: attributes not set yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && optin_of[dev] > 0) {
    *optin = optin_of[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(newton_solve_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(newton_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *optin);
  if (err == cudaSuccess && dev < kMaxDevices) optin_of[dev] = *optin;
  return err;
}

// A launch of `batch` clusters of cs blocks at width n; refuses a layout
// above the opt-in shared memory.
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int batch, int n, int cs, void* stream) {
  int optin = 0;
  const cudaError_t err = prepare(&optin);
  if (err != cudaSuccess) return err;
  const size_t bytes = Layout(n, cs).bytes();
  if (bytes > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(batch) * cs);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// The multiprocessors and the opt-in shared memory of a block on the
// current device, for the wrapper's cluster plan.
extern "C" int newton_solve_device_limits(int* sm_count, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}

// How many clusters of cs blocks at width n the current device can hold
// at once (0: the plan cannot be scheduled).
extern "C" int newton_solve_max_clusters(int n, int cs, int* clusters) {
  *clusters = 0;
  if (n < 1 || n > kMaxN || !valid_cluster(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(&cfg, attr, 1, n, cs, nullptr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(clusters, newton_solve_kernel, &cfg);
  return static_cast<int>(err);
}

extern "C" int newton_solve_launch(const void* M, const void* J, const void* b,
                                   const void* c, void* dy, int batch, int n,
                                   int n_sweeps, int cs, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || n_sweeps < 1 || !valid_cluster(cs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(&cfg, attr, batch, n, cs, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, newton_solve_kernel,
                           static_cast<const float*>(M),
                           static_cast<const float*>(J),
                           static_cast<const double*>(b),
                           static_cast<const double*>(c),
                           static_cast<double*>(dy), n, n_sweeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
