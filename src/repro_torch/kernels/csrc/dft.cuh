// The windowed real DFT of one frame at one bin, for the windows that the
// FFT passes of fft.cuh do not take: every even W from 4 to 510 other than
// 128 and 256. Shared by stft.cu and fused_tail.cu.
//
//   X[k] = sum_n w[n] x[n] tw[(n k) mod W],   k = 0 .. W/2
//
// with tw[t] = e^{-2 pi i t / W} and w the Hamming window, both from the
// host's f32 table (fft_tables.py: W (re, im) pairs, then W window
// values). The index (n k) mod W advances by k each step and wraps once at
// most, since k < W. Accumulated in f32, n in order.
//
// A tile is DFT_FRAMES consecutive frames, one per lane of a warp: the
// windowed frames lie in shared memory DFT_STRIDE(W) = W + 1 floats apart,
// an odd stride, so the 32 lanes reading sample n of their 32 frames hit
// 32 banks, while the twiddle they read is the same (one bin per warp) and
// is broadcast. W is a runtime value: one instance serves every window.
#pragma once

constexpr int DFT_FRAMES = 32;

__host__ __device__ constexpr int dft_stride(int W) { return W + 1; }

// xw[f * (W + 1) + n] = win[n] * src[f * hop + n] for f < n_frames and
// n < W, by P threads (thread t). src may be global or shared memory.
template <int P>
__device__ __forceinline__ void dft_stage_frames(const float* src,
                                                 const float* win, float* xw,
                                                 int n_frames, int W,
                                                 int hop, int t) {
  for (int i = t; i < n_frames * W; i += P) {
    const int f = i / W, n = i - f * W;
    xw[f * dft_stride(W) + n] = win[n] * src[f * hop + n];
  }
}

// Bin k (0 .. W/2) of one windowed frame xw (W floats in shared memory);
// tw: the W twiddles in shared memory.
__device__ __forceinline__ float2 dft_bin(const float* xw, const float2* tw,
                                          int W, int k) {
  float re = 0.f, im = 0.f;
  int t = 0;
#pragma unroll 4
  for (int n = 0; n < W; ++n) {
    const float v = xw[n];
    const float2 c = tw[t];
    re = fmaf(v, c.x, re);
    im = fmaf(v, c.y, im);
    t += k;
    if (t >= W) t -= W;
  }
  return make_float2(re, im);
}
