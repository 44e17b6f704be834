// Decision-directed MMSE-STSA spectral gain: gains (B, F, K) from power
// (B, F, K) and noise PSD (B, K), sequential over frames, independent per
// (row, bin).
//
// Replaces: src/repro/kernels/mmse_stsa/kernel.py, mmse_gain_pallas (body
// _mmse_kernel, i0e_poly / i1e_poly). On the main path it runs in the
// staged survivor tail: (R, 860, 129) power and (R, 129) noise.
//
// What bounds it on an H100: neither bytes nor operations but latency.
// Bytes (8 per step) and flops (about 64 per step) would both take a few
// microseconds, but the recurrence is a chain of F dependent steps of some
// 80 instructions, and there are only R*K independent chains (2,064 at
// R = 16): too few threads to hide that latency.
//
// Design: one thread per (row, bin) walks the frames and carries A^2/lambda
// in a register; blocks of 32 bins spread the rows over as many SMs as
// possible. The layout keeps K contiguous, so a warp's loads and stores of
// one frame coalesce. The TPU kernel padded bins to 128 lanes (zero power,
// noise 1.0); bins here are independent threads, so the padded lanes are
// simply not launched, which gives the same values for the real bins.
#include "common.cuh"
#include "mmse.cuh"

constexpr int MMSE_THREADS = 32;

__global__ void __launch_bounds__(MMSE_THREADS)
mmse_kernel(const float* __restrict__ power, const float* __restrict__ noise,
            float* __restrict__ gain, int F, int K, float alpha,
            float gain_floor) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (k >= K) return;
  const float inv_lam = 1.f / fmaxf(noise[static_cast<long long>(b) * K + k],
                                    1e-10f);
  const long long base = static_cast<long long>(b) * F * K + k;
  const float* p = power + base;
  float* g = gain + base;
  float a2 = 1.f;
#pragma unroll 4
  for (int t = 0; t < F; ++t) {
    const float gt = mmse_step(p[static_cast<long long>(t) * K], inv_lam,
                               alpha, a2);
    g[static_cast<long long>(t) * K] = fmaxf(gt, gain_floor);
  }
}

// power: (B, F, K), noise: (B, K), gain: (B, F, K); f32, contiguous, on
// the current device. Returns a cudaError_t code.
extern "C" int mmse_forward(const float* power, const float* noise,
                            float* gain, int B, int F, int K, float alpha,
                            float gain_floor, void* stream) {
  if (B <= 0 || F <= 0 || K <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((K + MMSE_THREADS - 1) /
                                        MMSE_THREADS),
                  static_cast<unsigned>(B));
  mmse_kernel<<<grid, MMSE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      power, noise, gain, F, K, alpha, gain_floor);
  return static_cast<int>(cudaGetLastError());
}
