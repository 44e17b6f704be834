// The fused survivor tail: for each padded survivor index, gather the row
// (an index outside [0, B) gives a zero row), optionally apply the causal
// stride-1 high-pass FIR, take the STFT, estimate the noise PSD as the mean
// power of the first min(noise_frames, Fv) frames, run the MMSE-STSA gain
// recurrence and write the gain-filtered spectrum as complex (R, Fv, K) in
// (real, imaginary) pairs. The inverse STFT stays outside (torch irfft).
//
// Replaces: src/repro/kernels/fused_tail/kernel.py, fused_tail_pallas (body
// _fused_tail_kernel, tail_geometry; `finish` stays outside there too). On
// the main path: wave (48, 110,250), R padded survivor indices ->
// (R, 860, 129).
//
// What bounds it on an H100: not bytes (each row's 441 KB is read once and
// its 888 KB written once) and not operations, but the MMSE recurrence: a
// chain of Fv dependent steps per (row, bin), whose latency no amount of
// parallelism across bins shortens. Everything else has to hide under it.
//
// Design: one block per survivor row, warp-specialised.
//   - A pad slot writes the row's exact zeros and exits.
//   - Producer warps (PRODUCERS threads) stream the row in chunks of
//     FftShape<W>::FRAMES frames. Chunk c+1's span (with the high-pass,
//     plus its Tp-1 sample halo) is copied into one of two stage buffers by
//     cp.async while chunk c is worked on: with the high-pass, the FIR in
//     shared memory (8 outputs per thread from a register window, 8 taps
//     per window); then fft.cuh's complex FFT passes over every frame, the
//     last pass writing into one of two ring slots in shared memory.
//   - Consumer warps (one thread per bin) read their bin's pair Z[k],
//     Z[N-k] of every frame from the slot, do the real FFT's even/odd split
//     (off the chain), carry alpha A^2/lambda in registers through mmse_step
//     (mmse.cuh, shared with the staged kernel) and write re*g, im*g, a
//     warp's stores consecutive in memory.
//   - The roles hand slots over with named barriers (bar.arrive by the
//     side that is done, bar.sync by the side that waits), so the producers
//     load, filter and transform chunk c+1 while the consumers run chunk
//     c's recurrence. The producers synchronise among themselves on a third
//     named barrier.
//   - Noise: with min(noise_frames, Fv) <= FRAMES the consumers sum the
//     power of chunk 0's first frames before its recurrence. A larger count
//     costs prologue chunks: the producers transform those frames first and
//     the consumers only sum them; the main loop then transforms them again.
// Shared memory at W = 256: 64 KB of ring, 64 KB of FFT buffers, 34 KB of
// stage buffers (with the high-pass 35 KB, and 0.5 KB of taps), 3 KB of
// table; one block per SM, which is all one row needs.
//
// Every other even window (4 to 510; the reference's Pallas kernel takes
// up to 382) goes to fused_tail_dft_kernel: the same function through the
// direct DFT of dft.cuh, the simple version, not warp-specialised. One
// block of 256 threads per survivor row walks its frames in chunks of
// DFT_FRAMES: all threads stage the chunk's span (with the high-pass, its
// T-1 sample halo too) and filter it in shared memory, window the frames,
// and compute every (frame, bin) of the chunk into shared memory; then one
// thread per bin carries the recurrence through the chunk with mmse_step,
// as both other kernels do. Noise frames beyond the first chunk take a
// prologue pass over the chunks that hold them, which the main loop then
// computes again.
#include "common.cuh"
#include "dft.cuh"
#include "fft.cuh"
#include "mmse.cuh"

// Producers: 15 warps load, filter and transform. A warp issues from the
// scheduler numbered warp mod 4, so at W = 256 the 5 consumer warps that
// follow land two on scheduler 3, which then has one producer warp fewer.
// On an H100, 15 producer warps came within 1% of the fastest of 8, 12,
// 14, 15 and 16, both with and without the high-pass.
constexpr int PRODUCERS = 480;
constexpr int BAR_PRODUCERS = 1;   // named barrier ids; 0 is __syncthreads
constexpr int BAR_FULL = 2;        // + slot: slot written by the producers
constexpr int BAR_EMPTY = 4;       // + slot: slot read by the consumers
constexpr int FIR_OUT = 8;         // FIR outputs per thread
constexpr int FIR_TAPS = 8;        // taps per register window

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();   // this thread's shared stores before the signal
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int W>
struct TailShape {
  using Sh = FftShape<W>;
  static constexpr int CONSUMERS = 32 * ((Sh::K + 31) / 32);
  static constexpr int THREADS = PRODUCERS + CONSUMERS;
  // floats of one raw span with its halo of Tp - 1 samples, plus one float
  // that the FIR's last register window reads, rounded to 16 bytes
  __host__ __device__ static constexpr int stage_floats(int Tp) {
    return (Sh::SPAN + Tp + 3) / 4 * 4;
  }
};

// span[j] = sum_k taps[k] * xs[j + Tp-1 - k] for s0 + j < S, else 0, with
// the taps zero-padded to Tp, a multiple of FIR_TAPS; summed in tap order.
template <int W>
__device__ __forceinline__ void fir_span(const float* xs, const float* taps,
                                         int Tp, long long S, long long s0,
                                         float* span, int t) {
  using Sh = FftShape<W>;
  for (int it = t; it < Sh::SPAN / FIR_OUT; it += PRODUCERS) {
    const int j0 = it * FIR_OUT;
    float acc[FIR_OUT];
#pragma unroll
    for (int m = 0; m < FIR_OUT; ++m) acc[m] = 0.f;
    for (int k0 = 0; k0 < Tp; k0 += FIR_TAPS) {
      // xv[i] = xs[base + i]; output j0+m, tap k0+u reads xv[m - u + 7]
      const float4* xp = reinterpret_cast<const float4*>(
          xs + j0 + Tp - 1 - k0 - (FIR_TAPS - 1));
      const float4* tp = reinterpret_cast<const float4*>(taps + k0);
      float xv[16], tv[FIR_TAPS];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = xp[q];
        xv[4 * q] = v.x; xv[4 * q + 1] = v.y;
        xv[4 * q + 2] = v.z; xv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v = tp[q];
        tv[4 * q] = v.x; tv[4 * q + 1] = v.y;
        tv[4 * q + 2] = v.z; tv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < FIR_TAPS; ++u)
#pragma unroll
        for (int m = 0; m < FIR_OUT; ++m)
          acc[m] = fmaf(tv[u], xv[m - u + FIR_TAPS - 1], acc[m]);
    }
#pragma unroll
    for (int m = 0; m < FIR_OUT; ++m)
      span[j0 + m] = (s0 + j0 + m < S) ? acc[m] : 0.f;
  }
}

template <int W>
__global__ void __launch_bounds__(TailShape<W>::THREADS)
fused_tail_kernel(const float* __restrict__ wave, const int* __restrict__ idx,
                  const float* __restrict__ tables,
                  const float* __restrict__ taps, float* __restrict__ out,
                  int B, long long S, int Fv, int T, int Tp, int noise_frames,
                  float alpha, float gain_floor) {
  using Sh = FftShape<W>;
  using Ts = TailShape<W>;
  constexpr int ALL = Ts::THREADS;
  extern __shared__ float4 smem4[];
  float* tab_s = reinterpret_cast<float*>(smem4);
  float2* ring = reinterpret_cast<float2*>(tab_s + Sh::TABLE_FLOATS);
  float2* buf_a = ring + 2 * Sh::BUF;
  float2* buf_b = buf_a + Sh::BUF;   // with the high-pass, the FIR's output
  float* taps_s = reinterpret_cast<float*>(buf_b + Sh::BUF);   // T > 0 only
  const int halo = T > 0 ? Tp - 1 : 0;
  const int stage_len = Ts::stage_floats(Tp);
  float* stage = taps_s + Tp;        // two raw spans (+ halo), in flight

  const int t = threadIdx.x;
  const int r = blockIdx.x;
  const int src = idx[r];
  float2* out_r = reinterpret_cast<float2*>(out) +
                  static_cast<long long>(r) * Fv * Sh::K;

  if (src < 0 || src >= B) {  // pad slot: exact zeros, like a fill gather
    for (long long i = t; i < static_cast<long long>(Fv) * Sh::K; i += ALL)
      out_r[i] = make_float2(0.f, 0.f);
    return;
  }

  const int nf = min(noise_frames, Fv);
  const int n_pre = nf > Sh::FRAMES ? (nf + Sh::FRAMES - 1) / Sh::FRAMES : 0;
  const int n_chunks = n_pre + (Fv + Sh::FRAMES - 1) / Sh::FRAMES;
  const float2* tw = reinterpret_cast<const float2*>(tab_s);

  if (t < PRODUCERS) {
    // ------------------------------------------------------------ producers
    const float* xr = wave + static_cast<long long>(src) * S;
    const auto psync = [] { bar_sync(BAR_PRODUCERS, PRODUCERS); };
    const auto chunk_s0 = [&](int c) {
      return static_cast<long long>(c < n_pre ? c : c - n_pre) *
             Sh::FRAMES * Sh::N;
    };
    copy_span_async<PRODUCERS>(xr, S, chunk_s0(0) - halo, Sh::SPAN + halo,
                               stage, t);
    load_tables<W>(tables, tab_s, t, PRODUCERS);
    for (int k = t; k < Tp; k += PRODUCERS) taps_s[k] = k < T ? taps[k] : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      // chunk c+1's samples travel while chunk c is filtered and transformed
      if (c + 1 < n_chunks) {
        copy_span_async<PRODUCERS>(xr, S, chunk_s0(c + 1) - halo,
                                   Sh::SPAN + halo,
                                   stage + ((c + 1) & 1) * stage_len, t);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      const int slot = c & 1;
      if (c >= 2) bar_sync(BAR_EMPTY + slot, ALL);   // chunk c-2 consumed
      psync();
      const float* span = stage + (c & 1) * stage_len;
      if (T > 0) {
        fir_span<W>(span, taps_s, Tp, S, chunk_s0(c),
                    reinterpret_cast<float*>(buf_b), t);
        psync();
        span = reinterpret_cast<const float*>(buf_b);
      }
      // the last pass writes the frames' complex FFTs into the slot
      fft_frames<W, PRODUCERS>(span, tab_s, buf_a, buf_b,
                               ring + slot * Sh::BUF, t, psync);
      bar_arrive(BAR_FULL + slot, ALL);
    }
  } else {
    // ------------------------------------------------------------ consumers
    const int kk = t - PRODUCERS;     // the bin this thread carries, if any
    const bool owns_bin = kk < Sh::K;
    float sum = 0.f, inv_lam = 0.f;
    MmseCarry a2 = mmse_carry_init(alpha);
    for (int c = 0; c < n_chunks; ++c) {
      const int slot = c & 1;
      const int f0 = (c < n_pre ? c : c - n_pre) * Sh::FRAMES;
      bar_sync(BAR_FULL + slot, ALL);
      const float2* Z = ring + slot * Sh::BUF;
      if (owns_bin) {
        if (c < n_pre || (n_pre == 0 && c == 0)) {   // noise frames
          const int n_f = min(Sh::FRAMES, nf - f0);
          for (int f = 0; f < n_f; ++f) {
            const float2 v = rfft_bin<W>(Z + f * Sh::N, tw, kk);
            sum += v.x * v.x + v.y * v.y;
          }
          if (c == max(n_pre - 1, 0)) inv_lam = 1.f / fmaxf(sum / nf, 1e-10f);
        }
        if (c >= n_pre) {
          const int n_f = min(Sh::FRAMES, Fv - f0);
          float2* o = out_r + static_cast<long long>(f0) * Sh::K + kk;
#pragma unroll 4
          for (int f = 0; f < n_f; ++f) {
            const float2 v = rfft_bin<W>(Z + f * Sh::N, tw, kk);
            const float g = fmaxf(
                mmse_step(v.x * v.x + v.y * v.y, inv_lam, alpha, a2),
                gain_floor);
            o[static_cast<long long>(f) * Sh::K] = make_float2(v.x * g,
                                                               v.y * g);
          }
        }
      }
      if (c + 2 < n_chunks) bar_arrive(BAR_EMPTY + slot, ALL);
    }
  }
}

constexpr int TAIL_DFT_THREADS = 256;   // at least K = W/2 + 1 <= 256

// Shared memory, in floats, of fused_tail_dft_kernel at window W with T
// taps (0: no high-pass).
__host__ __device__ constexpr int tail_dft_span(int W) {
  return (DFT_FRAMES - 1) * (W / 2) + W;
}
static size_t tail_dft_floats(int W, int T) {
  const int K = W / 2 + 1;
  return 3 * W + 2 * DFT_FRAMES * K + DFT_FRAMES * dft_stride(W) +
         tail_dft_span(W) + (T > 0 ? T - 1 + tail_dft_span(W) : 0) + T;
}

__global__ void __launch_bounds__(TAIL_DFT_THREADS)
fused_tail_dft_kernel(const float* __restrict__ wave,
                      const int* __restrict__ idx,
                      const float* __restrict__ tables,
                      const float* __restrict__ taps,
                      float* __restrict__ out, int B, long long S, int Fv,
                      int W, int T, int noise_frames, float alpha,
                      float gain_floor) {
  extern __shared__ float4 smem4[];
  const int K = W / 2 + 1, hop = W / 2;
  const int halo = T > 0 ? T - 1 : 0;
  float* tab_s = reinterpret_cast<float*>(smem4);
  const float2* tw = reinterpret_cast<const float2*>(tab_s);
  const float* win = tab_s + 2 * W;
  // 3W floats before it: even, so 8-byte aligned
  float2* spec = reinterpret_cast<float2*>(tab_s + 3 * W);
  float* xw = reinterpret_cast<float*>(spec + DFT_FRAMES * K);
  float* raw = xw + DFT_FRAMES * dft_stride(W);   // span + halo
  float* filt = raw + tail_dft_span(W) + halo;    // T > 0 only
  float* taps_s = filt + (T > 0 ? tail_dft_span(W) : 0);

  const int t = threadIdx.x;
  const int src = idx[blockIdx.x];
  float2* out_r = reinterpret_cast<float2*>(out) +
                  static_cast<long long>(blockIdx.x) * Fv * K;
  if (src < 0 || src >= B) {  // pad slot: exact zeros, like a fill gather
    for (long long i = t; i < static_cast<long long>(Fv) * K;
         i += TAIL_DFT_THREADS)
      out_r[i] = make_float2(0.f, 0.f);
    return;
  }
  for (int i = t; i < 3 * W; i += TAIL_DFT_THREADS) tab_s[i] = tables[i];
  for (int k = t; k < T; k += TAIL_DFT_THREADS) taps_s[k] = taps[k];

  const float* xr = wave + static_cast<long long>(src) * S;
  const int nf = min(noise_frames, Fv);
  const int n_pre =
      nf > DFT_FRAMES ? (nf + DFT_FRAMES - 1) / DFT_FRAMES : 0;
  const int n_chunks = n_pre + (Fv + DFT_FRAMES - 1) / DFT_FRAMES;
  float sum = 0.f, inv_lam = 0.f;
  MmseCarry a2 = mmse_carry_init(alpha);
  for (int c = 0; c < n_chunks; ++c) {
    const int f0 = (c < n_pre ? c : c - n_pre) * DFT_FRAMES;
    const int n_f = min(DFT_FRAMES, Fv - f0);
    const int len = (n_f - 1) * hop + W;
    const long long s0 = static_cast<long long>(f0) * hop - halo;
    __syncthreads();   // the last chunk's spectrum is consumed
    for (int j = t; j < len + halo; j += TAIL_DFT_THREADS) {
      const long long q = s0 + j;
      raw[j] = q >= 0 && q < S ? xr[q] : 0.f;
    }
    __syncthreads();
    const float* frames = raw;
    if (T > 0) {  // causal high-pass: filt[j] = sum_k taps[k] raw[j+T-1-k]
      for (int j = t; j < len; j += TAIL_DFT_THREADS) {
        float acc = 0.f;
        for (int k = 0; k < T; ++k)
          acc = fmaf(taps_s[k], raw[j + halo - k], acc);
        filt[j] = acc;
      }
      __syncthreads();
      frames = filt;
    }
    dft_stage_frames<TAIL_DFT_THREADS>(frames, win, xw, n_f, W, hop, t);
    __syncthreads();
    const int lane = t & 31;
    if (lane < n_f)
      for (int k = t >> 5; k < K; k += TAIL_DFT_THREADS / 32)
        spec[lane * K + k] = dft_bin(xw + lane * dft_stride(W), tw, W, k);
    __syncthreads();
    if (t >= K) continue;
    if (c < n_pre || (n_pre == 0 && c == 0)) {   // noise frames
      const int n_noise = min(n_f, nf - f0);
      for (int f = 0; f < n_noise; ++f) {
        const float2 v = spec[f * K + t];
        sum += v.x * v.x + v.y * v.y;
      }
      if (c == max(n_pre - 1, 0)) inv_lam = 1.f / fmaxf(sum / nf, 1e-10f);
    }
    if (c >= n_pre) {
      float2* o = out_r + static_cast<long long>(f0) * K + t;
      for (int f = 0; f < n_f; ++f) {
        const float2 v = spec[f * K + t];
        const float g = fmaxf(
            mmse_step(v.x * v.x + v.y * v.y, inv_lam, alpha, a2),
            gain_floor);
        o[static_cast<long long>(f) * K] = make_float2(v.x * g, v.y * g);
      }
    }
  }
}

static int launch_fused_tail_dft(const float* wave, const int* idx,
                                 const float* tables, const float* taps,
                                 float* out, int B, long long S, int R,
                                 int Fv, int W, int T, int noise_frames,
                                 float alpha, float gain_floor,
                                 cudaStream_t stream) {
  if (W < 4 || W > 510 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * tail_dft_floats(W, T);
  cudaError_t err = allow_shared_bytes(fused_tail_dft_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_tail_dft_kernel<<<R, TAIL_DFT_THREADS, smem, stream>>>(
      wave, idx, tables, taps, out, B, S, Fv, W, T, noise_frames, alpha,
      gain_floor);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
static int launch_fused_tail(const float* wave, const int* idx,
                             const float* tables, const float* taps,
                             float* out, int B, long long S, int R, int Fv,
                             int T, int noise_frames, float alpha,
                             float gain_floor, cudaStream_t stream) {
  using Sh = FftShape<W>;
  using Ts = TailShape<W>;
  const int Tp = T > 0 ? (T + FIR_TAPS - 1) / FIR_TAPS * FIR_TAPS : 0;
  const size_t floats = Sh::TABLE_FLOATS + 8 * Sh::BUF + Tp +
                        2 * Ts::stage_floats(Tp);
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = allow_shared_bytes(fused_tail_kernel<W>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_tail_kernel<W><<<R, Ts::THREADS, smem, stream>>>(
      wave, idx, tables, taps, out, B, S, Fv, T, Tp, noise_frames, alpha,
      gain_floor);
  return static_cast<int>(cudaGetLastError());
}

// wave: (B, S) f32; idx: (R,) int32; tables: fft_tables.tables(window);
// taps: (T,) f32, or null with T = 0 for no high-pass; out: (R, Fv, K, 2)
// f32, K = window/2 + 1. Contiguous, on the current device; hop = window/2,
// window even, 4 to 512 (128, 256 and 512 by the FFT, the others by the
// DFT), noise_frames >= 1. Returns a cudaError_t code.
extern "C" int fused_tail_forward(const float* wave, const int* idx,
                                  const float* tables, const float* taps,
                                  float* out, int B, long long S, int R,
                                  int Fv, int window, int T, int noise_frames,
                                  float alpha, float gain_floor,
                                  void* stream) {
  if (R <= 0 || Fv <= 0) return 0;
  if (noise_frames < 1 || T < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (window) {
    case 128:
      return launch_fused_tail<128>(wave, idx, tables, taps, out, B, S, R,
                                    Fv, T, noise_frames, alpha, gain_floor,
                                    s);
    case 256:
      return launch_fused_tail<256>(wave, idx, tables, taps, out, B, S, R,
                                    Fv, T, noise_frames, alpha, gain_floor,
                                    s);
    case 512:
      return launch_fused_tail<512>(wave, idx, tables, taps, out, B, S, R,
                                    Fv, T, noise_frames, alpha, gain_floor,
                                    s);
    default:
      return launch_fused_tail_dft(wave, idx, tables, taps, out, B, S, R, Fv,
                                   window, T, noise_frames, alpha,
                                   gain_floor, s);
  }
}
