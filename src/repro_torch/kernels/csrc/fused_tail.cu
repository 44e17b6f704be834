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
// What bounds it on an H100: operations, the DFT's 2*256*258 flops per
// frame against 512 bytes read and 1,032 written; with the high-pass, 258
// more flops per sample. The MMSE recurrence adds a latency-bound chain of
// 860 dependent steps per (row, bin).
//
// Design: the TPU kernel keeps a whole row's frames, spectrum, power and
// gains resident (about 5.5 MB per row); an SM has 227 KB. Everything after
// the DFT is per bin, so the grid is (bin tile of DFT_BINS, survivor row)
// and each block streams the row in chunks of DFT_FRAMES frames:
//   - it reads its own index, writes exact zeros for a pad slot and stops;
//   - per chunk it loads one contiguous span of samples (with the high-pass,
//     the raw span plus a T-1 sample halo, filtered in shared memory);
//   - it multiplies the chunk's frames by its bin tile's basis columns
//     (dft.cuh) into a spectrum tile in shared memory;
//   - on the first chunk warp 0 forms the noise mean before the recurrence;
//   - warp 0 (one thread per bin) carries A^2/lambda across chunks in a
//     register and writes re*g, im*g for the valid frames, while the other
//     warps already load the next chunk.
// Shared memory: 115 KB per block, 150 KB with the high-pass. At small R the
// grid fills few of the 132 SMs (5 bin tiles per row).
#include "common.cuh"
#include "dft.cuh"
#include "fir.cuh"
#include "mmse.cuh"

__global__ void __launch_bounds__(DFT_THREADS)
fused_tail_kernel(const float* __restrict__ wave, const int* __restrict__ idx,
                  const float* __restrict__ basis,
                  const float* __restrict__ taps, float* __restrict__ out,
                  int B, long long S, int Fv, int K, int window, int hop,
                  int T, int noise_frames, float alpha, float gain_floor) {
  extern __shared__ float smem[];
  const int span_len = (DFT_FRAMES - 1) * hop + window;
  float* basis_s = smem;
  float* span = basis_s + window * DFT_COLS;
  float* spec_s = span + span_len;
  float* xs = spec_s + DFT_FRAMES * DFT_COLS;  // high-pass input, T > 0 only
  float* taps_s = xs + span_len + T - 1;       // T > 0 only

  const int k0 = blockIdx.x * DFT_BINS;
  const int r = blockIdx.y;
  const int src = idx[r];
  float* out_r = out + static_cast<long long>(r) * Fv * K * 2;

  if (src < 0 || src >= B) {  // pad slot: exact zeros, like a fill gather
    const int ncols = min(DFT_COLS, 2 * (K - k0));
    for (long long i = threadIdx.x; i < static_cast<long long>(Fv) * ncols;
         i += blockDim.x) {
      const long long f = i / ncols;
      const int c = static_cast<int>(i % ncols);
      out_r[f * 2 * K + 2 * k0 + c] = 0.f;
    }
    return;
  }

  const float* xr = wave + static_cast<long long>(src) * S;
  load_basis_tile(basis, window, K, k0, basis_s);
  for (int k = threadIdx.x; k < T; k += blockDim.x) taps_s[k] = taps[k];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kk = threadIdx.x;  // the bin this thread carries, if any
  const bool owns_bin = kk < DFT_BINS && k0 + kk < K;
  float inv_lam = 0.f;
  float a2 = 1.f;

  for (int f0 = 0; f0 < Fv; f0 += DFT_FRAMES) {
    const long long s0 = static_cast<long long>(f0) * hop;
    if (T > 0) {
      for (int j = threadIdx.x; j < span_len + T - 1; j += blockDim.x) {
        const long long q = s0 - (T - 1) + j;
        xs[j] = (q >= 0 && q < S) ? xr[q] : 0.f;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < span_len; j += blockDim.x)
        span[j] = (s0 + j < S) ? fir_point(xs, taps_s, T, j + T - 1) : 0.f;
    } else {
      for (int j = threadIdx.x; j < span_len; j += blockDim.x)
        span[j] = (s0 + j < S) ? xr[s0 + j] : 0.f;
    }
    __syncthreads();

    float acc[DFT_FRAMES_PER_WARP][2];
    dft_tile(span, hop, window, basis_s, acc);
#pragma unroll
    for (int i = 0; i < DFT_FRAMES_PER_WARP; ++i) {
      float* s = spec_s + (warp * DFT_FRAMES_PER_WARP + i) * DFT_COLS;
      s[lane] = acc[i][0];
      s[lane + 32] = acc[i][1];
    }
    __syncthreads();

    // Only warp 0 reads spec_s from here on; the next chunk writes it after
    // two more barriers, so no barrier is needed at the end of the loop.
    if (owns_bin) {
      if (f0 == 0) {
        const int nf = min(noise_frames, Fv);
        float sum = 0.f;
        for (int f = 0; f < nf; ++f) {
          const float re = spec_s[f * DFT_COLS + 2 * kk];
          const float im = spec_s[f * DFT_COLS + 2 * kk + 1];
          sum += re * re + im * im;
        }
        inv_lam = 1.f / fmaxf(sum / nf, 1e-10f);
      }
      const int n_f = min(DFT_FRAMES, Fv - f0);
      for (int f = 0; f < n_f; ++f) {
        const float re = spec_s[f * DFT_COLS + 2 * kk];
        const float im = spec_s[f * DFT_COLS + 2 * kk + 1];
        const float g = fmaxf(mmse_step(re * re + im * im, inv_lam, alpha, a2),
                              gain_floor);
        float* o = out_r + (static_cast<long long>(f0 + f) * K + k0 + kk) * 2;
        o[0] = re * g;
        o[1] = im * g;
      }
    }
  }
}

// wave: (B, S) f32; idx: (R,) int32; basis: (window, 2K) interleaved
// (w*cos, -w*sin) per bin; taps: (T,) f32, or null with T = 0 for no
// high-pass; out: (R, Fv, K, 2) f32. Contiguous, on the current device;
// noise_frames must not exceed DFT_FRAMES. Returns a cudaError_t code.
extern "C" int fused_tail_forward(const float* wave, const int* idx,
                                  const float* basis, const float* taps,
                                  float* out, int B, long long S, int R,
                                  int Fv, int K, int window, int hop, int T,
                                  int noise_frames, float alpha,
                                  float gain_floor, void* stream) {
  if (R <= 0 || Fv <= 0) return 0;
  if (noise_frames < 1 || noise_frames > DFT_FRAMES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int span_len = (DFT_FRAMES - 1) * hop + window;
  size_t floats = window * DFT_COLS + span_len + DFT_FRAMES * DFT_COLS;
  if (T > 0) floats += span_len + T - 1 + T;
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = allow_shared_bytes(fused_tail_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((K + DFT_BINS - 1) / DFT_BINS),
                  static_cast<unsigned>(R));
  fused_tail_kernel<<<grid, DFT_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      wave, idx, basis, taps, out, B, S, Fv, K, window, hop, T, noise_frames,
      alpha, gain_floor);
  return static_cast<int>(cudaGetLastError());
}
