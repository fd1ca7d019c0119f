// The dynamic shared-memory limit that the kernels taking more than 48 KB
// check before they opt in and launch.

#pragma once

#include <cuda_runtime.h>

// The most dynamic shared memory one block of `kernel` may opt in to on
// the current device: the device's per-block limit less the kernel's
// static shared memory (0 if either query fails).
inline int dynamic_smem_limit(const void* kernel) {
  int dev = 0, limit = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return 0;
  return limit - (int)attr.sharedSizeBytes;
}
