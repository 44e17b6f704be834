// Helpers shared by every kernel library of the port. Each .cu file is
// built into its own shared library with a plain C interface (loaded from
// Python with ctypes), so each includes this header once.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

// Message for a CUDA error code returned by one of the C entry points.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
template <typename Kernel>
static cudaError_t allow_shared_bytes(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
