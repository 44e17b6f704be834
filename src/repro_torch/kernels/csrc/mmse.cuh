// One frame of the decision-directed MMSE-STSA gain recurrence, shared by
// mmse.cu and fused_tail.cu. Same clip points and the same
// Abramowitz-Stegun 9.8.1-9.8.4 polynomials for the exponentially scaled
// Bessel functions as the TPU kernel (src/repro/kernels/mmse_stsa/
// kernel.py: i0e_poly, i1e_poly, _mmse_kernel.frame_step).
#pragma once

constexpr float MMSE_XI_MIN = 0.0031622776601683794f;  // 10^(-25/10)
constexpr float MMSE_GAMMA_MAX = 10000.f;               // 10^(40/10)
constexpr float MMSE_SQRTPI_2 = 0.886226925452758f;     // sqrt(pi)/2

__device__ __forceinline__ float mmse_poly7(const float c[7], float t) {
  float acc = c[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) acc = acc * t + c[i];
  return acc;
}

__device__ __forceinline__ float mmse_poly9(const float c[9], float t) {
  float acc = c[8];
#pragma unroll
  for (int i = 7; i >= 0; --i) acc = acc * t + c[i];
  return acc;
}

// exp(-x) * I0(x), x >= 0 (A&S 9.8.1 / 9.8.2).
__device__ __forceinline__ float i0e_poly(float x) {
  const float small_c[7] = {1.0f, 3.5156229f, 3.0899424f, 1.2067492f,
                            0.2659732f, 0.0360768f, 0.0045813f};
  const float large_c[9] = {0.39894228f, 0.01328592f, 0.00225319f,
                            -0.00157565f, 0.00916281f, -0.02057706f,
                            0.02635537f, -0.01647633f, 0.00392377f};
  if (x <= 3.75f) {
    const float t = x / 3.75f;
    return mmse_poly7(small_c, t * t) * expf(-x);
  }
  return mmse_poly9(large_c, 3.75f / x) / sqrtf(x);
}

// exp(-x) * I1(x), x >= 0 (A&S 9.8.3 / 9.8.4).
__device__ __forceinline__ float i1e_poly(float x) {
  const float small_c[7] = {0.5f, 0.87890594f, 0.51498869f, 0.15084934f,
                            0.02658733f, 0.00301532f, 0.00032411f};
  const float large_c[9] = {0.39894228f, -0.03988024f, -0.00362018f,
                            0.00163801f, -0.01031555f, 0.02282967f,
                            -0.02895312f, 0.01787654f, -0.00420059f};
  if (x <= 3.75f) {
    const float t = x / 3.75f;
    return x * mmse_poly7(small_c, t * t) * expf(-x);
  }
  return mmse_poly9(large_c, 3.75f / x) / sqrtf(x);
}

// Gain for power p of one (frame, bin), given 1/lambda of the bin's noise;
// `a2` carries A^2/lambda from the previous frame (1 before the first).
// Returns the gain before the floor, as the recurrence needs it.
__device__ __forceinline__ float mmse_step(float p, float inv_lam,
                                           float alpha, float& a2) {
  const float gamma = fminf(fmaxf(p * inv_lam, 1e-8f), MMSE_GAMMA_MAX);
  float xi = alpha * a2 + (1.f - alpha) * fmaxf(gamma - 1.f, 0.f);
  xi = fmaxf(xi, MMSE_XI_MIN);
  const float v = fmaxf(xi * gamma / (1.f + xi), 1e-8f);
  const float h = 0.5f * v;
  float g = MMSE_SQRTPI_2 * sqrtf(v) / gamma *
            ((1.f + v) * i0e_poly(h) + v * i1e_poly(h));
  g = fminf(fmaxf(g, 0.f), 10.f);
  a2 = (g * g) * gamma;
  return g;
}
