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
//
// Every other even window (4 to 510; the reference's Pallas kernel takes
// up to 382) goes to stft_dft_kernel, the direct DFT of dft.cuh: 4 W
// (W/2 + 1) operations a frame against the real FFT's 2.5 W log2 W, 36
// times as many at W = 382, so this kernel is held back by its operations
// where the function is bound by bytes. It is the simple version. A
// block takes DFT_FRAMES frames of one row: their windowed samples staged
// in shared memory, one lane per frame and one warp per bin at a time,
// the tile's spectrum gathered in shared memory and written as one
// contiguous run.
#include "common.cuh"
#include "dft.cuh"
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

constexpr int DFT_THREADS = 256;

__global__ void __launch_bounds__(DFT_THREADS)
stft_dft_kernel(const float* __restrict__ x, const float* __restrict__ tables,
                float* __restrict__ out, long long S, int F, int W) {
  extern __shared__ float4 smem4[];
  float* tab_s = reinterpret_cast<float*>(smem4);
  const float2* tw = reinterpret_cast<const float2*>(tab_s);
  const float* win = tab_s + 2 * W;
  float* xw = tab_s + 3 * W;                          // DFT_FRAMES frames
  // 3W + 32 (W + 1) floats before it: even, so 8-byte aligned
  float2* spec = reinterpret_cast<float2*>(xw + DFT_FRAMES * dft_stride(W));
  const int t = threadIdx.x;
  const int K = W / 2 + 1;
  const int f0 = blockIdx.x * DFT_FRAMES;
  const int n_f = min(DFT_FRAMES, F - f0);
  const int hop = W / 2;

  for (int i = t; i < 3 * W; i += DFT_THREADS) tab_s[i] = tables[i];
  __syncthreads();
  dft_stage_frames<DFT_THREADS>(
      x + blockIdx.y * S + static_cast<long long>(f0) * hop, win, xw, n_f,
      W, hop, t);
  __syncthreads();
  const int lane = t & 31;
  if (lane < n_f)
    for (int k = t >> 5; k < K; k += DFT_THREADS / 32)
      spec[lane * K + k] = dft_bin(xw + lane * dft_stride(W), tw, W, k);
  __syncthreads();
  float2* o = reinterpret_cast<float2*>(out) +
              (static_cast<long long>(blockIdx.y) * F + f0) * K;
  for (int i = t; i < n_f * K; i += DFT_THREADS) o[i] = spec[i];
}

static int launch_stft_dft(const float* x, const float* tables, float* out,
                           int B, long long S, int F, int W,
                           cudaStream_t stream) {
  if (W < 4 || W > 510 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int K = W / 2 + 1;
  const size_t smem = sizeof(float) * (3 * W + DFT_FRAMES * dft_stride(W) +
                                       2 * DFT_FRAMES * K);
  cudaError_t err = allow_shared_bytes(stft_dft_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((F + DFT_FRAMES - 1) / DFT_FRAMES),
                  static_cast<unsigned>(B));
  stft_dft_kernel<<<grid, DFT_THREADS, smem, stream>>>(x, tables, out, S, F,
                                                       W);
  return static_cast<int>(cudaGetLastError());
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
// hop = window / 2 and window is even, 4 to 512 (128, 256 and 512 by the
// FFT, the others by the DFT). Returns a cudaError_t code.
extern "C" int stft_forward(const float* x, const float* tables, float* out,
                            int B, long long S, int F, int window,
                            void* stream) {
  if (B <= 0 || F <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 128: return launch_stft<128>(x, tables, out, B, S, F, s);
    case 256: return launch_stft<256>(x, tables, out, B, S, F, s);
    case 512: return launch_stft<512>(x, tables, out, B, S, F, s);
    default: return launch_stft_dft(x, tables, out, B, S, F, window, s);
  }
}
