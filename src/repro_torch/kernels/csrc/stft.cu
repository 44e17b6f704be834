// Short-time Fourier transform: frames of `window` samples every `hop`
// samples, times the Hamming-windowed real-DFT basis, written as complex
// (B, F, K) in (real, imaginary) pairs, F = (S - window) / hop + 1 and
// K = window / 2 + 1.
//
// Replaces: src/repro/kernels/stft_dft/kernel.py, stft_pallas (body
// _stft_kernel, basis dft_basis). On the main path it is the detection
// STFT: (16, 330,750) -> (16, 2582, 129).
//
// What bounds it on an H100: operations. 2*256*258 flops per frame against
// 512 bytes of new input and 1,032 bytes of output: about 86 flops per
// byte, well above the f32 CUDA-core ridge of about 20 (67 TFLOP/s over
// 3.35 TB/s).
//
// Design: the grid is (frame tile of DFT_FRAMES, row, bin tile of
// DFT_BINS). Frame f starts at sample f*hop, so a frame tile is one
// contiguous span of (DFT_FRAMES-1)*hop + window samples, loaded once;
// the even/odd reshapes and separate tail input of the TPU kernel existed
// only because BlockSpecs cannot express overlapping blocks. The whole
// (256, 258) windowed basis is 264 KB and does not fit the 227 KB a block
// may use, so the bins are a grid axis and a block keeps only its
// (256, 64) slice (64 KB). Shared memory per block: 99 KB, two blocks per
// SM. The products are f32 FMAs on the CUDA cores (dft.cuh).
#include "common.cuh"
#include "dft.cuh"

__global__ void __launch_bounds__(DFT_THREADS)
stft_kernel(const float* __restrict__ x, const float* __restrict__ basis,
            float* __restrict__ out, long long S, int F, int K, int window,
            int hop) {
  extern __shared__ float smem[];
  float* basis_s = smem;
  float* span = smem + window * DFT_COLS;
  const int f0 = blockIdx.x * DFT_FRAMES;
  const int row = blockIdx.y;
  const int k0 = blockIdx.z * DFT_BINS;
  const int span_len = (DFT_FRAMES - 1) * hop + window;
  const float* xr = x + row * S;
  const long long s0 = static_cast<long long>(f0) * hop;

  for (int j = threadIdx.x; j < span_len; j += blockDim.x)
    span[j] = (s0 + j < S) ? xr[s0 + j] : 0.f;
  load_basis_tile(basis, window, K, k0, basis_s);
  __syncthreads();

  float acc[DFT_FRAMES_PER_WARP][2];
  dft_tile(span, hop, window, basis_s, acc);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < DFT_FRAMES_PER_WARP; ++i) {
    const int f = f0 + warp * DFT_FRAMES_PER_WARP + i;
    if (f >= F) break;
    float* o = out + (static_cast<long long>(row) * F + f) * (2 * K);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 2 * k0 + lane + 32 * j;
      if (c < 2 * K) o[c] = acc[i][j];
    }
  }
}

// x: (B, S); basis: (window, 2K) interleaved (w*cos, -w*sin) per bin;
// out: (B, F, K, 2). All f32, contiguous, on the current device. Returns
// a cudaError_t code.
extern "C" int stft_forward(const float* x, const float* basis, float* out,
                            int B, long long S, int F, int K, int window,
                            int hop, void* stream) {
  if (B <= 0 || F <= 0) return 0;
  const size_t smem = sizeof(float) * (window * DFT_COLS +
                                       (DFT_FRAMES - 1) * hop + window);
  cudaError_t err = allow_shared_bytes(stft_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((F + DFT_FRAMES - 1) / DFT_FRAMES),
                  static_cast<unsigned>(B),
                  static_cast<unsigned>((K + DFT_BINS - 1) / DFT_BINS));
  stft_kernel<<<grid, DFT_THREADS, smem,
                static_cast<cudaStream_t>(stream)>>>(x, basis, out, S, F,
                                                     K, window, hop);
  return static_cast<int>(cudaGetLastError());
}
