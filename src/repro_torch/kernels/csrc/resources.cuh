// The resources of one kernel instantiation, shared by the libraries'
// queries (sgmv.cu's sgmv_kernel_resources, flash.cu's
// flash_kernel_resources). The build hashes this header with the sources.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

// out[0..4]: registers a thread, static shared bytes, local (spilled)
// bytes a thread, the most threads a block (cudaFuncGetAttributes of
// kern), and `dynamic`, the dynamic shared bytes its launcher sets.
// Returns a CUDA error code.
template <typename Kern>
int func_resources(Kern kern, size_t dynamic, long long* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.sharedSizeBytes);
  out[2] = static_cast<long long>(a.localSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = static_cast<long long>(dynamic);
  return 0;
}
