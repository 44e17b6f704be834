// One output of the causal FIR filter, read from a span in shared memory.
// Shared by fir.cu (the filter on its own, any stride) and fused_tail.cu
// (the stride-1 high-pass of the survivor tail).
#pragma once

// y = sum_k taps[k] * xs[base - k], k = 0 .. T-1, summed in that order.
// `base` is the span position of x[n*stride]; the span starts T-1 samples
// before the block's first output so that base - k never goes below 0.
__device__ __forceinline__ float fir_point(const float* xs,
                                           const float* taps, int T,
                                           int base) {
  float acc = 0.f;
  for (int k = 0; k < T; ++k) acc = fmaf(taps[k], xs[base - k], acc);
  return acc;
}
