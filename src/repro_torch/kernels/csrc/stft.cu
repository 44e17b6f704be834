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
// up to 382) goes to stft_dft_kernel, the folded 3xTF32 DFT of dft.cuh on
// the tensor cores. What bounds it: at W = 382 the function needs 0.019 ms
// of bytes, the folded product 6.1 G multiply-adds (three TF32 products
// each) or 0.025 ms at the TF32 peak; the tile's loads, folds and splits
// around each mma.sync set its pace (dft.cuh), and with them the latency
// of each step's chain. The design: one wave, a block an SM. Each of the
// n_bt bin tiles gets SMs / n_bt blocks, which split the (row, frame tile)
// items in equal runs. A block stages the basis of its DFT_BINS bins once
// and keeps it for its whole run, shared by DFT_GROUPS warp groups that
// walk the run's tiles in turn, each with its own segments (three groups,
// or two where three groups' segments do not fit: W >= 440): a group's
// tile of 64 frames arrives by cp.async as 65 segments of hop + 1 samples
// (4 bytes a
// thread: at W = 382 the hop is 191 floats, an odd stride that TMA cannot
// address frame by frame), and its 4 warps fold and transform it, 16
// frames x 32 bins a warp, each lane storing the (Re, Im) pairs it holds
// as float2 straight to the output, while the other groups' copies travel.
// Blocks of neighbouring bin tiles walk the same items at about the same
// time, so they read the samples from L2. Shared memory at W = 382: 49 KB
// of basis and 3 x 50 KB of segments.
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

// A block: up to DFT_GROUPS warp groups of DFT_GROUP_THREADS that share
// the basis tile, each with its own segments, walking its own tiles of
// DFT_FRAMES frames x 32 bins, 16 frames x 32 bins a warp.
constexpr int DFT_GROUPS = 3;
constexpr int DFT_GROUP_THREADS = 128;
constexpr int DFT_FRAMES = 64;

// Shared memory, in floats, of stft_dft_kernel at window W with `groups`
// warp groups: the basis tile, the fold's coefficients, each group's
// segments.
static size_t stft_dft_floats(int W, int groups) {
  return dft_basis_floats(W) + dft_coef_floats(W) +
         groups * dft_span_floats(W, DFT_FRAMES);
}

// Block b takes bin tile b mod n_bt and the b / n_bt-th of gridDim.x / n_bt
// equal runs of the (row, frame tile) items, in order; its group g takes
// items g, g + groups, ... of the run.
__global__ void __launch_bounds__(DFT_GROUPS * DFT_GROUP_THREADS, 1)
stft_dft_kernel(const float* __restrict__ x, const float* __restrict__ tables,
                float* __restrict__ out, int B, long long S, int F, int W) {
  constexpr int FM = DFT_FRAMES;
  extern __shared__ float4 smem4[];
  const int K = W / 2 + 1, hop = W / 2, R = dft_row(W);
  float* basis_s = reinterpret_cast<float*>(smem4);
  float* coef = basis_s + dft_basis_floats(W);
  const int groups = blockDim.x / DFT_GROUP_THREADS;
  const int t = threadIdx.x, group = t / DFT_GROUP_THREADS;
  const int gt = t % DFT_GROUP_THREADS, warp = gt >> 5, lane = t & 31;
  float* seg = coef + dft_coef_floats(W) + group * dft_span_floats(W, FM);
  const int n_bt = (K + DFT_BINS - 1) / DFT_BINS;
  const int b0 = blockIdx.x % n_bt * DFT_BINS;
  const int run = blockIdx.x / n_bt, n_runs = gridDim.x / n_bt;
  const int n_tiles = (F + FM - 1) / FM;
  const long long items = static_cast<long long>(B) * n_tiles;
  const long long i0 = items * run / n_runs;
  const long long i1 = items * (run + 1) / n_runs;
  const auto gsync = [&] { bar_sync(1 + group, DFT_GROUP_THREADS); };
  const auto copy_item = [&](long long i) {
    const int row = static_cast<int>(i / n_tiles);
    const int f0 = static_cast<int>(i % n_tiles) * FM;
    dft_copy_segments<DFT_GROUP_THREADS>(x + row * S, S,
                                         static_cast<long long>(f0) * hop,
                                         min(FM, F - f0) + 1, W, seg, gt);
  };

  // zeros where no copy writes (segment pads, rows past the last frame):
  // what the tile reads there is then finite
  for (int i = t; i < groups * dft_span_floats(W, FM); i += blockDim.x)
    coef[dft_coef_floats(W) + i] = 0.f;
  if (group == 0) {                      // the first group stages them
    dft_load_basis<DFT_GROUP_THREADS>(tables, W, b0, basis_s, t);
    asm volatile("cp.async.commit_group;" ::: "memory");
    dft_load_coef<DFT_GROUP_THREADS>(tables, W, coef, t);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();                       // basis, coefficients and zeros in
  long long i = i0 + group;
  if (i < i1) copy_item(i);
  for (; i < i1; i += groups) {
    const int row = static_cast<int>(i / n_tiles);
    const int f0 = static_cast<int>(i % n_tiles) * FM;
    const int n_f = min(FM, F - f0);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    gsync();                             // the tile's segments are in
    float2* ot = reinterpret_cast<float2*>(out) +
                 (static_cast<long long>(row) * F + f0) * K + b0;
    for (int m = warp; m < FM / 16; m += DFT_GROUP_THREADS / 32)
      dft_warp_tile<1, 4, 1>(seg, coef, basis_s, basis_s + DFT_BINS * R, W,
                             16 * m, 0, lane,
                             [&](int f, int n, float re, float im) {
                               if (f < n_f && b0 + n < K)
                                 ot[static_cast<long long>(f) * K + n] =
                                     make_float2(re, im);
                             });
    gsync();                             // the segments are read
    if (i + groups < i1) copy_item(i + groups);
  }
}

static int launch_stft_dft(const float* x, const float* tables, float* out,
                           int B, long long S, int F, int W,
                           cudaStream_t stream) {
  if (W < 4 || W > 510 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // three warp groups where their segments fit, else two (W >= 440)
  const int groups = sizeof(float) * stft_dft_floats(W, DFT_GROUPS) <=
                             static_cast<size_t>(max_smem)
                         ? DFT_GROUPS
                         : DFT_GROUPS - 1;
  const size_t smem = sizeof(float) * stft_dft_floats(W, groups);
  err = allow_shared_bytes(stft_dft_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave, a block an SM: each bin tile gets SMs / n_bt blocks, and
  // they split the (row, frame tile) items between them
  const int n_bt = (W / 2 + DFT_BINS) / DFT_BINS;
  const long long items =
      static_cast<long long>(B) * ((F + DFT_FRAMES - 1) / DFT_FRAMES);
  long long runs = max(1, sms / n_bt);
  if (runs > items) runs = items;
  const unsigned blocks = static_cast<unsigned>(n_bt * runs);
  stft_dft_kernel<<<blocks, groups * DFT_GROUP_THREADS, smem, stream>>>(
      x, tables, out, B, S, F, W);
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

// x: (B, S); tables: fft_tables.kernel_tables(window); out:
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
