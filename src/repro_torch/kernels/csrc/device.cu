// The card's limits, for the shared-memory check (analysis/smem.py) and
// launch/mesh.py:device_limits: one query of cudaDeviceGetAttribute and of
// the largest cluster the card schedules.
#include <cuda_runtime.h>

namespace {

// the cluster probe's block and grid: the SGMV cluster kernels' block of
// 256 threads (sgmv.cu kThreads), 8 clusters of the largest size asked
constexpr int kProbeThreads = 256;
constexpr int kProbeGrid = 8 * 16;

// A block that does nothing: the largest cluster the card schedules.
__global__ void cluster_probe_kernel() {}

}  // namespace

// The limits of card `device` into out[0..7]: SMs, shared bytes a block
// after the opt-in, shared bytes an SM, the runtime's reserved shared bytes
// a block, registers an SM, registers a block, threads an SM, and the
// largest cluster of 256-thread blocks it schedules (non-portable sizes
// allowed). Returns a CUDA error code.
extern "C" int device_limits_query(int device, long long* out) {
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxRegistersPerBlock,
      cudaDevAttrMaxThreadsPerMultiProcessor};
  for (int i = 0; i < 7; ++i) {
    int v = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&v, attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i] = v;
  }
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_probe_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  int n = 0;
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kProbeGrid);
    cfg.blockDim = dim3(kProbeThreads);
    err = cudaOccupancyMaxPotentialClusterSize(&n, cluster_probe_kernel,
                                               &cfg);
  }
  cudaSetDevice(prev);
  out[7] = n;
  return static_cast<int>(err);
}
