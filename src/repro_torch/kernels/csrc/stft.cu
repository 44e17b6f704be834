// Short-time Fourier transform: frames of W samples every hop = W/2
// samples, Hamming-windowed, real FFT, written as complex (B, F, K) in
// (real, imaginary) pairs, F = (S - W) / hop + 1 and K = W/2 + 1.
//
// Replaces: src/repro/kernels/stft_dft/kernel.py, stft_pallas (body
// _stft_kernel, basis dft_basis). On the main path it is the detection
// STFT: (16, 330,750) -> (16, 2582, 129).
//
// What bounds it on an H100: bytes. A real FFT needs about 2.5 W log2 W
// flops per frame (5.4k at W = 256) against 512 bytes of new input and
// 1,032 bytes of output: 3.5 flops per byte, under the f32 CUDA-core ridge
// of about 20 (67 TFLOP/s over 3.35 TB/s). The TPU kernel's dense DFT (a
// matmul with the windowed basis) needs 25 times the flops and is not the
// algorithm for this card.
//
// Design: the grid is (frame tile, row). A tile of FftShape<W>::FRAMES
// consecutive frames (32 at W = 256) reads one contiguous span of
// (FRAMES + 1) * hop samples (cp.async, 4 bytes a thread), and every frame
// gets the shared-memory real FFT of fft.cuh (window applied as the frame
// is read; twiddles and window from the host's f32 table). The tile's
// output is one contiguous run of FRAMES * 2K floats: thread i writes the
// i-th (re, im) pair, so a warp stores 256 consecutive bytes. Shared memory
// per block: two 32 KB FFT buffers (the span lies in the second) and the
// 3 KB table, so three blocks share an SM.
#include "common.cuh"
#include "fft.cuh"

constexpr int STFT_THREADS = 256;

template <int W>
__global__ void __launch_bounds__(STFT_THREADS)
stft_kernel(const float* __restrict__ x, const float* __restrict__ tables,
            float* __restrict__ out, long long S, int F) {
  using Sh = FftShape<W>;
  extern __shared__ float4 smem4[];
  float* tab_s = reinterpret_cast<float*>(smem4);
  float2* buf_a = reinterpret_cast<float2*>(tab_s + Sh::TABLE_FLOATS);
  float2* buf_b = buf_a + Sh::BUF;
  const int t = threadIdx.x;
  const int f0 = blockIdx.x * Sh::FRAMES;
  const int row = blockIdx.y;

  copy_span_async<STFT_THREADS>(x + row * S, S,
                                static_cast<long long>(f0) * Sh::N, Sh::SPAN,
                                reinterpret_cast<float*>(buf_b), t);
  load_tables<W>(tables, tab_s, t, STFT_THREADS);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  // the last pass writes the buffer the ping-pong reaches, not its input
  float2* Z = Sh::PASSES % 2 ? buf_a : buf_b;
  fft_frames<W, STFT_THREADS>(reinterpret_cast<const float*>(buf_b), tab_s,
                              buf_a, buf_b, Z, t, [] { __syncthreads(); });

  const float2* tw = reinterpret_cast<const float2*>(tab_s);
  const int n_out = min(Sh::FRAMES, F - f0) * Sh::K;
  float2* o = reinterpret_cast<float2*>(out) +
              (static_cast<long long>(row) * F + f0) * Sh::K;
  for (int i = t; i < n_out; i += STFT_THREADS) {
    const int f = i / Sh::K, k = i % Sh::K;
    o[i] = rfft_bin<W>(Z + f * Sh::N, tw, k);
  }
}

template <int W>
static int launch_stft(const float* x, const float* tables, float* out, int B,
                       long long S, int F, cudaStream_t stream) {
  using Sh = FftShape<W>;
  const size_t smem = sizeof(float) * (Sh::TABLE_FLOATS + 4 * Sh::BUF);
  cudaError_t err = allow_shared_bytes(stft_kernel<W>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((F + Sh::FRAMES - 1) / Sh::FRAMES),
                  static_cast<unsigned>(B));
  stft_kernel<W><<<grid, STFT_THREADS, smem, stream>>>(x, tables, out, S, F);
  return static_cast<int>(cudaGetLastError());
}

// x: (B, S); tables: fft_tables.tables(window), (3 * window,); out:
// (B, F, window/2 + 1, 2). All f32, contiguous, on the current device;
// hop = window / 2 and window is 128, 256 or 512. Returns a cudaError_t
// code.
extern "C" int stft_forward(const float* x, const float* tables, float* out,
                            int B, long long S, int F, int window,
                            void* stream) {
  if (B <= 0 || F <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 128: return launch_stft<128>(x, tables, out, B, S, F, s);
    case 256: return launch_stft<256>(x, tables, out, B, S, F, s);
    case 512: return launch_stft<512>(x, tables, out, B, S, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
