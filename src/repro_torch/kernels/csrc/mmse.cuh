// One frame of the decision-directed MMSE-STSA gain recurrence, shared by
// mmse.cu and fused_tail.cu. Same clip points and the same
// Abramowitz-Stegun 9.8.1-9.8.4 polynomials for the exponentially scaled
// Bessel functions as the TPU kernel (src/repro/kernels/mmse_stsa/
// kernel.py: i0e_poly, i1e_poly, _mmse_kernel.frame_step), evaluated in
// another order (below).
#pragma once

constexpr float MMSE_XI_MIN = 0.0031622776601683794f;  // 10^(-25/10)
constexpr float MMSE_GAMMA_MAX = 10000.f;               // 10^(40/10)
constexpr float MMSE_SQRTPI_2 = 0.886226925452758f;     // sqrt(pi)/2
constexpr float MMSE_SQRT2 = 1.4142135623730951f;       // sqrt(2)

// One MUFU instruction each, flushing subnormals: no range fix-ups on the
// chain. Every argument here is a normal number or, for the exponential,
// one whose result may flush to 0.
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp_ftz(float x) {   // e^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

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

// Gain for power p of one (frame, bin), given 1/lambda of the bin's noise;
// `a2` carries A^2/lambda from the previous frame (1 before the first).
// Returns the gain before the floor, as the recurrence needs it.
//
// The steps form a chain through `a2`, and the chain's latency is what
// bounds both kernels that run it, so the step is laid out for it:
//   - gamma, 1/gamma and (1-alpha) max(gamma-1, 0) depend only on p and are
//     off the chain (with the loop unrolled they run ahead of it, which an
//     IEEE division's branch to its slow path would prevent);
//   - exp(-h) I0(h) and exp(-h) I1(h) evaluate both A&S branches (h <= 3.75
//     and above) side by side and select, so a warp whose bins straddle
//     3.75 does not run the two one after the other;
//   - sqrt(v) / sqrt(h) = sqrt(2) since h = v/2, so the large branch needs
//     no square root of its own, and sqrt(v) = sqrt(2) h rsqrt(h);
//   - reciprocals, the reciprocal square root and the exponential are one
//     MUFU instruction each (rcp/rsqrt/ex2.approx.ftz: about 1-2 ulp, and
//     a few ulp for the exponential at the |h| <= 3.75 where it is used),
//     with no branch and no subnormal fix-up. The card's check holds the kernels within 2e-4
//     of the plain version (torch.special.i0e / i1e).
__device__ __forceinline__ float mmse_step(float p, float inv_lam,
                                           float alpha, float& a2) {
  const float small0[7] = {1.0f, 3.5156229f, 3.0899424f, 1.2067492f,
                           0.2659732f, 0.0360768f, 0.0045813f};
  const float large0[9] = {0.39894228f, 0.01328592f, 0.00225319f,
                           -0.00157565f, 0.00916281f, -0.02057706f,
                           0.02635537f, -0.01647633f, 0.00392377f};
  const float small1[7] = {0.5f, 0.87890594f, 0.51498869f, 0.15084934f,
                           0.02658733f, 0.00301532f, 0.00032411f};
  const float large1[9] = {0.39894228f, -0.03988024f, -0.00362018f,
                           0.00163801f, -0.01031555f, 0.02282967f,
                           -0.02895312f, 0.01787654f, -0.00420059f};
  // off the chain
  const float gamma = fminf(fmaxf(p * inv_lam, 1e-8f), MMSE_GAMMA_MAX);
  const float inv_gamma = rcp_ftz(gamma);
  const float prior = (1.f - alpha) * fmaxf(gamma - 1.f, 0.f);
  // the chain
  const float xi = fmaxf(alpha * a2 + prior, MMSE_XI_MIN);
  const float v = fmaxf(xi * gamma * rcp_ftz(1.f + xi), 1e-8f);
  const float h = 0.5f * v;
  const float r = rsqrt_ftz(h);
  const float t = h * (1.f / 3.75f);
  const float e = exp_ftz(-h);
  const float u = 3.75f * rcp_ftz(h);
  // exp(-h) I0(h), exp(-h) I1(h), each times sqrt(v); the branch not taken
  // may overflow and is dropped by the select
  const float tt = t * t;
  const float sv = MMSE_SQRT2 * h * r;
  const float s0 = mmse_poly7(small0, tt) * e * sv;
  const float s1 = h * mmse_poly7(small1, tt) * e * sv;
  const float l0 = mmse_poly9(large0, u) * MMSE_SQRT2;
  const float l1 = mmse_poly9(large1, u) * MMSE_SQRT2;
  const bool small = h <= 3.75f;
  const float i0 = small ? s0 : l0;
  const float i1 = small ? s1 : l1;
  float g = MMSE_SQRTPI_2 * inv_gamma * ((1.f + v) * i0 + v * i1);
  g = fminf(fmaxf(g, 0.f), 10.f);
  a2 = (g * g) * gamma;
  return g;
}
