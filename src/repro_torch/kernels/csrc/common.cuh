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

// Named barriers (bar.sync by the side that waits, bar.arrive by the side
// that is done); id 0 is __syncthreads.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();   // this thread's shared stores before the signal
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
