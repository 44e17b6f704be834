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
// folded 3xTF32 DFT of dft.cuh, tiled by bins. Bins are independent
// recurrences with independent noise PSDs, so the grid is (bin tile,
// survivor row) and a block owns DFT_BINS bins of one row from the first
// frame to the last: 6 x 15 blocks for the 15 real rows at W = 382, where
// one block a row gave 15. What bounds it: the chain of Fv dependent
// mmse_step a bin (576 at W = 382); with the high-pass, the FIR too.
//   - A pad slot writes exact zeros for its bins and exits.
//   - Producer warps (TAIL_DFT_PRODUCERS threads) stage the basis of the
//     block's bins once, then walk the row in chunks of TAIL_DFT_FRAMES
//     frames. A chunk's samples arrive by cp.async as the tile's segments
//     (dft.cuh), into one of two buffers while the other chunk's tile
//     runs; with the high-pass they arrive raw, with their Tp-1 sample
//     halo (more than a hop at W = 200), into a stage buffer, and the FIR
//     (fir_run, as the FFT kernel's) writes its output as the segments.
//     Then the warps run the tile for the block's bins into one of two
//     ring slots.
//   - One consumer warp, one lane per bin, sums the noise frames' power
//     (with prologue chunks when min(noise_frames, Fv) exceeds a chunk,
//     which the main loop then computes again), carries mmse_step through
//     the chunk and writes re*g, im*g: a warp stores 256 consecutive bytes
//     a frame.
//   - The roles hand slots over with the named barriers of the FFT kernel.
// The cost of the split: each bin tile of a row repeats the row's copies
// and its FIR (6 times at W = 382: 110,250 x 129 multiply-adds each).
// Shared memory at W = 382 with the high-pass: 49 KB of basis, 52 KB of
// segments, 17 KB of ring and 26 KB of stage buffer.
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

// store(j, sum_k taps[k] * xs[j + Tp-1 - k]) for s0 + j < S, else
// store(j, 0), for j below len rounded up to FIR_OUT, by P threads (thread
// t), with the taps zero-padded to Tp, a multiple of FIR_TAPS; summed in
// tap order. xs and taps 16-byte aligned; xs holds len + Tp - 1 samples
// and is read up to FIR_OUT + 1 floats beyond, which reach only the
// outputs from len on.
template <int P, typename Store>
__device__ __forceinline__ void fir_run(const float* xs, const float* taps,
                                        int Tp, long long S, long long s0,
                                        int len, int t, Store store) {
  for (int it = t; it < (len + FIR_OUT - 1) / FIR_OUT; it += P) {
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
      store(j0 + m, (s0 + j0 + m < S) ? acc[m] : 0.f);
  }
}

// The FFT kernel's FIR over one chunk's span.
template <int W>
__device__ __forceinline__ void fir_span(const float* xs, const float* taps,
                                         int Tp, long long S, long long s0,
                                         float* span, int t) {
  fir_run<PRODUCERS>(xs, taps, Tp, S, s0, FftShape<W>::SPAN, t,
                     [&](int j, float v) { span[j] = v; });
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

constexpr int TAIL_DFT_FRAMES = 32;       // frames a chunk
constexpr int TAIL_DFT_PRODUCERS = 128;   // 4 warps: 32 frames x 32 bins
constexpr int TAIL_DFT_THREADS = TAIL_DFT_PRODUCERS + 32;   // + consumers
constexpr int TAIL_RING_ROW = DFT_BINS + 1;   // float2 a frame in a slot

// Floats of the high-pass's stage buffer: the longest span with its halo,
// rounded up to FIR_OUT, plus the floats fir_run reads beyond it.
__host__ __device__ constexpr int tail_dft_stage(int W, int Tp) {
  return ((TAIL_DFT_FRAMES - 1) * (W / 2) + W + FIR_OUT - 1) / FIR_OUT *
             FIR_OUT + Tp + FIR_OUT;
}
// Shared memory, in floats, of fused_tail_dft_kernel at window W with Tp
// (padded) taps, 0 for no high-pass: basis tile, the fold's coefficients,
// taps, two ring slots, two chunks' segments and, with the high-pass, the
// stage buffer of raw samples.
__host__ __device__ constexpr int tail_dft_floats(int W, int Tp) {
  return dft_basis_floats(W) + dft_coef_floats(W) + Tp +
         4 * TAIL_DFT_FRAMES * TAIL_RING_ROW +
         2 * dft_span_floats(W, TAIL_DFT_FRAMES) +
         (Tp > 0 ? tail_dft_stage(W, Tp) : 0);
}

__global__ void __launch_bounds__(TAIL_DFT_THREADS)
fused_tail_dft_kernel(const float* __restrict__ wave,
                      const int* __restrict__ idx,
                      const float* __restrict__ tables,
                      const float* __restrict__ taps,
                      float* __restrict__ out, int B, long long S, int Fv,
                      int W, int T, int Tp, int noise_frames, float alpha,
                      float gain_floor) {
  constexpr int FM = TAIL_DFT_FRAMES, P = TAIL_DFT_PRODUCERS;
  constexpr int ALL = TAIL_DFT_THREADS;
  extern __shared__ float4 smem4[];
  const int K = W / 2 + 1, hop = W / 2, R = dft_row(W), SP = dft_seg(W);
  const int halo = T > 0 ? Tp - 1 : 0;
  float* basis_s = reinterpret_cast<float*>(smem4);
  float* coef = basis_s + dft_basis_floats(W);
  float* taps_s = coef + dft_coef_floats(W);
  float2* ring = reinterpret_cast<float2*>(taps_s + Tp);
  float* segs = reinterpret_cast<float*>(ring + 2 * FM * TAIL_RING_ROW);
  float* stage = segs + 2 * dft_span_floats(W, FM);     // T > 0 only

  const int t = threadIdx.x;
  const int b0 = blockIdx.x * DFT_BINS;
  const int src = idx[blockIdx.y];
  float2* out_r = reinterpret_cast<float2*>(out) +
                  static_cast<long long>(blockIdx.y) * Fv * K + b0;
  if (src < 0 || src >= B) {  // pad slot: exact zeros, like a fill gather
    for (long long i = t; i < static_cast<long long>(Fv) * DFT_BINS;
         i += ALL) {
      const int f = static_cast<int>(i / DFT_BINS), n = i % DFT_BINS;
      if (b0 + n < K)
        out_r[static_cast<long long>(f) * K + n] = make_float2(0.f, 0.f);
    }
    return;
  }

  const int nf = min(noise_frames, Fv);
  const int n_pre = nf > FM ? (nf + FM - 1) / FM : 0;
  const int n_chunks = n_pre + (Fv + FM - 1) / FM;
  const auto chunk_f0 = [&](int c) {
    return (c < n_pre ? c : c - n_pre) * FM;
  };

  if (t < P) {
    // ------------------------------------------------------------ producers
    const float* xr = wave + static_cast<long long>(src) * S;
    const auto psync = [] { bar_sync(BAR_PRODUCERS, P); };
    // chunk c's samples: as segments into its buffer, or with the
    // high-pass raw (with the halo) into the stage buffer
    const auto copy_chunk = [&](int c) {
      const int f0 = chunk_f0(c), n_f = min(FM, Fv - f0);
      const long long s0 = static_cast<long long>(f0) * hop;
      if (T > 0)
        copy_span_async<P>(xr, S, s0 - halo, (n_f - 1) * hop + W + halo,
                           stage, t);
      else
        dft_copy_segments<P>(xr, S, s0, n_f + 1, W,
                             segs + (c & 1) * dft_span_floats(W, FM), t);
    };
    // zeros where no copy or FIR writes (segment pads, rows past the last
    // frame, the stage's tail): what the tile and the FIR read is finite
    const int zeros = 2 * dft_span_floats(W, FM) +
                      (T > 0 ? tail_dft_stage(W, Tp) : 0);
    for (int i = t; i < zeros; i += P) segs[i] = 0.f;
    psync();
    dft_load_basis<P>(tables, W, b0, basis_s, t);
    copy_chunk(0);                       // one commit group with the basis
    dft_load_coef<P>(tables, W, coef, t);
    for (int k = t; k < Tp; k += P) taps_s[k] = k < T ? taps[k] : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int f0 = chunk_f0(c), n_f = min(FM, Fv - f0);
      float* seg = segs + (c & 1) * dft_span_floats(W, FM);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      psync();                  // chunk c is in; chunk c-1's tile is done
      if (T > 0) {
        const int len = (n_f - 1) * hop + W;
        fir_run<P>(stage, taps_s, Tp, S, static_cast<long long>(f0) * hop,
                   len, t, [&](int j, float v) {
                     if (j >= len) return;
                     const int q = j / hop, i = j - q * hop;
                     seg[q * SP + i] = v;       // and the one it opens:
                     if (i == 0 && q > 0) seg[q * SP - SP + hop] = v;
                   });
        psync();
      }
      if (c + 1 < n_chunks) copy_chunk(c + 1);
      const int slot = c & 1;
      if (c >= 2) bar_sync(BAR_EMPTY + slot, ALL);   // chunk c-2 consumed
      float2* Z = ring + slot * FM * TAIL_RING_ROW;
      // 16 frames x 16 bins a warp
      const int item = t >> 5;
      dft_warp_tile<1, 2, 2>(seg, coef, basis_s, basis_s + DFT_BINS * R, W,
                             16 * (item >> 1), 16 * (item & 1), t & 31,
                             [&](int f, int n, float re, float im) {
                               Z[f * TAIL_RING_ROW + n] = make_float2(re, im);
                             });
      bar_arrive(BAR_FULL + slot, ALL);
    }
  } else {
    // ------------------------------------------------------------ consumers
    const int lane = t - P;              // bin b0 + lane, if below K
    const bool owns_bin = b0 + lane < K;
    float sum = 0.f, inv_lam = 0.f;
    MmseCarry a2 = mmse_carry_init(alpha);
    for (int c = 0; c < n_chunks; ++c) {
      const int slot = c & 1;
      const int f0 = chunk_f0(c), n_f = min(FM, Fv - f0);
      bar_sync(BAR_FULL + slot, ALL);
      const float2* Z = ring + slot * FM * TAIL_RING_ROW + lane;
      if (owns_bin) {
        if (c < n_pre || (n_pre == 0 && c == 0)) {   // noise frames
          const int n_noise = min(n_f, nf - f0);
          for (int f = 0; f < n_noise; ++f) {
            const float2 v = Z[f * TAIL_RING_ROW];
            sum += v.x * v.x + v.y * v.y;
          }
          if (c == max(n_pre - 1, 0)) inv_lam = 1.f / fmaxf(sum / nf, 1e-10f);
        }
        if (c >= n_pre) {
          float2* o = out_r + static_cast<long long>(f0) * K + lane;
#pragma unroll 4
          for (int f = 0; f < n_f; ++f) {
            const float2 v = Z[f * TAIL_RING_ROW];
            const float g = fmaxf(
                mmse_step(v.x * v.x + v.y * v.y, inv_lam, alpha, a2),
                gain_floor);
            o[static_cast<long long>(f) * K] = make_float2(v.x * g, v.y * g);
          }
        }
      }
      if (c + 2 < n_chunks) bar_arrive(BAR_EMPTY + slot, ALL);
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
  const int Tp = T > 0 ? (T + FIR_TAPS - 1) / FIR_TAPS * FIR_TAPS : 0;
  const size_t smem = sizeof(float) * tail_dft_floats(W, Tp);
  cudaError_t err = allow_shared_bytes(fused_tail_dft_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((W / 2 + DFT_BINS) / DFT_BINS),
                  static_cast<unsigned>(R));
  fused_tail_dft_kernel<<<grid, TAIL_DFT_THREADS, smem, stream>>>(
      wave, idx, tables, taps, out, B, S, Fv, W, T, Tp, noise_frames, alpha,
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

// wave: (B, S) f32; idx: (R,) int32; tables:
// fft_tables.kernel_tables(window); taps: (T,) f32, or null with T = 0 for
// no high-pass; out: (R, Fv, K, 2) f32, K = window/2 + 1. Contiguous, on
// the current device; hop = window/2, window even, 4 to 512 (128, 256 and
// 512 by the FFT, the others by the DFT), noise_frames >= 1. Returns a
// cudaError_t code.
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
