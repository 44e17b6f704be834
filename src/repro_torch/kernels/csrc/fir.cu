// Causal FIR filter with decimation: y[b, n] = sum_k h[k] * x[b, n*s - k],
// x zero-padded on the left, n < S / s.
//
// Replaces: src/repro/kernels/fir_hpf/kernel.py, fir_pallas (body
// _fir_kernel). On the main path it is the `compress` stage: 129 taps,
// stride 2, (4, 2,646,000) -> (4, 1,323,000); the survivor-tail `hpf`
// stage uses it at stride 1.
//
// What bounds it on an H100: about even. It reads 4 bytes and writes 2
// per output pair (about 19 us at 3.35 TB/s at the main-path shape) and
// does 2*129 flops per output (about 20 us at the f32 FMA peak).
//
// Design: the grid is (output tile of FIR_OUT_TILE outputs, row). A block
// stages its input span plus the T-1 sample causal halo (one contiguous,
// coalesced load) and the taps in shared memory, so every input sample is
// read from device memory once per tile (plus the 128-sample halo). Each
// thread then sums all taps for outputs strided by the block size, so a
// warp writes consecutive outputs. The polyphase reshape of the TPU kernel
// only served the TPU's contiguous-lane loads and is not needed here; its
// cost is two shared loads per FMA, which a later version can cut with
// register tiling.
#include "common.cuh"
#include "fir.cuh"

constexpr int FIR_OUT_TILE = 1024;
constexpr int FIR_THREADS = 256;

__global__ void __launch_bounds__(FIR_THREADS)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           float* __restrict__ y, long long S, int T, int stride,
           long long out_len) {
  extern __shared__ float smem[];
  float* taps_s = smem;
  float* xs = smem + T;
  const int row = blockIdx.y;
  const long long n0 = static_cast<long long>(blockIdx.x) * FIR_OUT_TILE;
  const int n_out = static_cast<int>(
      min(static_cast<long long>(FIR_OUT_TILE), out_len - n0));
  const long long start = n0 * stride - (T - 1);
  const int span = (n_out - 1) * stride + T;
  const float* xr = x + row * S;

  for (int k = threadIdx.x; k < T; k += blockDim.x) taps_s[k] = taps[k];
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const long long i = start + j;
    xs[j] = (i >= 0 && i < S) ? xr[i] : 0.f;
  }
  __syncthreads();

  float* yr = y + row * out_len + n0;
  for (int j = threadIdx.x; j < n_out; j += blockDim.x)
    yr[j] = fir_point(xs, taps_s, T, j * stride + T - 1);
}

// x: (B, S), taps: (T,), y: (B, out_len) with out_len = S / stride, all
// f32, contiguous, on the current device. Returns a cudaError_t code.
extern "C" int fir_forward(const float* x, const float* taps, float* y,
                           int B, long long S, int T, int stride,
                           long long out_len, void* stream) {
  if (B <= 0 || out_len <= 0) return 0;
  const size_t smem =
      sizeof(float) * (T + (FIR_OUT_TILE - 1) * stride + T);
  cudaError_t err = allow_shared_bytes(fir_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>((out_len + FIR_OUT_TILE - 1) / FIR_OUT_TILE),
      static_cast<unsigned>(B));
  fir_kernel<<<grid, FIR_THREADS, smem,
               static_cast<cudaStream_t>(stream)>>>(x, taps, y, S, T,
                                                    stride, out_len);
  return static_cast<int>(cudaGetLastError());
}
