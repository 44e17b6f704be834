// The windowed real DFT of a tile of overlapping frames, shared by
// stft.cu and fused_tail.cu.
//
// A tile is DFT_FRAMES consecutive frames by DFT_BINS consecutive bins. The
// block's 8 warps each own 8 frames; lane l owns basis columns l and l+32
// of the tile. Columns interleave (w*cos, -w*sin) per bin, so column c is
// bin c/2, part c%2 (0 = real, 1 = imaginary), and a warp's 32 lanes write
// 32 consecutive floats of the (.., K, 2) output.
//
// Inner loop per sample n: two basis loads (consecutive addresses, no bank
// conflict), eight frame loads (one address per warp, a broadcast) and
// sixteen f32 FMAs. Plain f32 on the CUDA cores: TF32 tensor cores would
// not hold the 2e-4 tolerance against the FFT.
#pragma once

constexpr int DFT_THREADS = 256;             // 8 warps
constexpr int DFT_FRAMES_PER_WARP = 8;
constexpr int DFT_FRAMES = 8 * DFT_FRAMES_PER_WARP;  // frames per tile
constexpr int DFT_BINS = 32;                 // bins per tile
constexpr int DFT_COLS = 2 * DFT_BINS;       // basis columns per tile

// Copies the tile's basis columns into shared memory:
// basis_s[n * DFT_COLS + c] = basis[n, 2*k0 + c], zero past the last bin.
// `basis` is (window, 2*K) row-major with the Hamming window folded in.
__device__ __forceinline__ void load_basis_tile(
    const float* __restrict__ basis, int window, int K, int k0,
    float* basis_s) {
  const int ncols = 2 * K;
  const int c0 = 2 * k0;
  for (int i = threadIdx.x; i < window * DFT_COLS; i += blockDim.x) {
    const int n = i / DFT_COLS;
    const int c = i % DFT_COLS;
    basis_s[i] = (c0 + c < ncols) ? basis[n * ncols + c0 + c] : 0.f;
  }
}

// acc[i][j] = sum_n span[(f + i) * hop + n] * basis_s[n * DFT_COLS + c]
// with f = warp * DFT_FRAMES_PER_WARP the warp's first frame in the tile
// and c = lane + 32 * j.
__device__ __forceinline__ void dft_tile(
    const float* span, int hop, int window, const float* basis_s,
    float acc[DFT_FRAMES_PER_WARP][2]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* xf = span + warp * DFT_FRAMES_PER_WARP * hop;
#pragma unroll
  for (int i = 0; i < DFT_FRAMES_PER_WARP; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int n = 0; n < window; ++n) {
    const float b0 = basis_s[n * DFT_COLS + lane];
    const float b1 = basis_s[n * DFT_COLS + 32 + lane];
#pragma unroll
    for (int i = 0; i < DFT_FRAMES_PER_WARP; ++i) {
      const float v = xf[i * hop + n];
      acc[i][0] = fmaf(v, b0, acc[i][0]);
      acc[i][1] = fmaf(v, b1, acc[i][1]);
    }
  }
}
