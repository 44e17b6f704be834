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
constexpr float MMSE_LOG2E = 1.4426950408889634f;       // log2(e)

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
__device__ __forceinline__ float ex2_ftz(float x) {   // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tables the step evaluates, from the TPU kernel's A&S coefficients
// (written out below, in double) rounded once to f32: the small branches
// as polynomials in h^2 (c_i / 3.75^(2i)), the large ones in 1/h
// (c_i * 3.75^i), and for the large branch also I0 + I1 summed coefficient
// by coefficient.
__host__ __device__ constexpr double mmse_pow(double x, int n) {
  return n == 0 ? 1.0 : x * mmse_pow(x, n - 1);
}
__host__ __device__ constexpr float mmse_small(double c, int i) {
  return static_cast<float>(c / mmse_pow(3.75 * 3.75, i));
}
__host__ __device__ constexpr float mmse_large(double c, int i) {
  return static_cast<float>(c * mmse_pow(3.75, i));
}
__host__ __device__ constexpr float mmse_large_sum(double c0, double c1,
                                                   int i) {
  return static_cast<float>((c0 + c1) * mmse_pow(3.75, i));
}

// Split Horner: the even and the odd coefficients as two Horner chains in
// x2 = x^2, joined by one FMA. As many FMAs as Horner (6 for 7
// coefficients, 8 for 9) plus the x^2 that both polynomials of one
// argument share, and 4 or 5 FMAs deep after x^2 instead of 6 or 8.
// Estrin's scheme is shallower still (3 and 4) but needs x^4 as well and
// more instructions; with one warp per scheduler the step is bound by
// its instruction count nearly as much as by its depth. On an H100 the
// three orders of the MMSE kernel lie within a few percent of each other,
// and which one leads moves with the compiler's schedule: split Horner
// ran 9-10% faster than either in one build, plain Horner 1.6% faster
// than split Horner in a later one (scripts/mmse_variants.py, variants
// `horner` and `estrin`).
__device__ __forceinline__ float mmse_split7(const float c[7], float x,
                                             float x2) {
  const float ev = fmaf(fmaf(fmaf(c[6], x2, c[4]), x2, c[2]), x2, c[0]);
  const float od = fmaf(fmaf(c[5], x2, c[3]), x2, c[1]);
  return fmaf(x, od, ev);
}
__device__ __forceinline__ float mmse_split9(const float c[9], float x,
                                             float x2) {
  const float ev =
      fmaf(fmaf(fmaf(fmaf(c[8], x2, c[6]), x2, c[4]), x2, c[2]), x2, c[0]);
  const float od = fmaf(fmaf(fmaf(c[7], x2, c[5]), x2, c[3]), x2, c[1]);
  return fmaf(x, od, ev);
}

// What a frame's step needs from its power alone: computed off the chain,
// ahead of the step (no IEEE division, whose branch to its slow path would
// keep the compiler from moving it ahead).
struct MmseFrame {
  float hg;      // gamma / 2
  float prior;   // (1 - alpha) max(gamma - 1, 0)
  float ag;      // alpha gamma: the next frame's weight of g^2
  float c;       // sqrt(pi)/2 / gamma
};

// Carried from frame to frame: alpha A^2/lambda of the previous frame is
// g2 * ag (A^2/lambda = g^2 gamma). Before the first frame A^2/lambda = 1:
// g2 = 1, ag = alpha.
struct MmseCarry {
  float g2;
  float ag;
};

__device__ __forceinline__ MmseCarry mmse_carry_init(float alpha) {
  return MmseCarry{1.f, alpha};
}

__device__ __forceinline__ MmseFrame mmse_frame(float p, float inv_lam,
                                                float alpha) {
  const float gamma = fminf(fmaxf(p * inv_lam, 1e-8f), MMSE_GAMMA_MAX);
  return MmseFrame{0.5f * gamma, (1.f - alpha) * fmaxf(gamma - 1.f, 0.f),
                   alpha * gamma, MMSE_SQRTPI_2 * rcp_ftz(gamma)};
}

// The gain of one (frame, bin), clipped to at most 10, as the recurrence
// needs it; the caller applies the gain floor. Advances `s`.
//
// The steps form a chain through `s.g2`, and the chain's latency is what
// bounds both kernels that run it, so the step is laid out for it:
//   - xi = max(g2 * ag + prior, XI_MIN) is one FMA and a max after g2;
//   - h = v/2 comes straight from xi * (gamma/2) / (1 + xi): halving is
//     exact, so h equals v/2 of the plain order bit for bit, and the clip
//     v >= 1e-8 becomes h >= 1e-8/2;
//   - exp(-h) I0(h), exp(-h) I1(h) evaluate both A&S branches (h <= 3.75
//     and above) side by side and select, so a warp whose bins straddle
//     3.75 does not run the two one after the other; the branch not taken
//     may overflow (inf, or NaN from inf - inf) and is dropped by the
//     select, never combined;
//   - the polynomials take h^2 and 1/h directly (scaled coefficients), by
//     split Horner (above); 1/h is rsqrt(h)^2, so the step has three MUFU
//     instructions on the chain (rcp, rsqrt, ex2) and none of them waits
//     for another;
//   - with v = 2h, (1+v) I0 + v I1 = A0 + v (A0 + A1), where the large
//     branch sums its two polynomials' coefficients;
//   - sqrt(v) / sqrt(h) = sqrt(2) since h = v/2, so the large branch needs
//     no square root, and sqrt(v) = sqrt(2) h rsqrt(h) in the small one;
//   - sqrt(pi)/2 / gamma comes with the frame;
//   - g^2 = min(g, 10)^2 = min(g * g, 100) exactly (g >= 0, rounding is
//     monotone, 10 * 10 is exact), so the chain squares before it clips
//     and the clipped gain is formed beside it.
// Dropped from the plain order: max(g, 0). Every value here is finite and
// g >= 0 whatever the power: gamma is clipped into [1e-8, 1e4] (a NaN
// power clips to 1e-8 through fmaxf, as before), so xi, h and 1/h are
// finite and positive; in the selected branch the polynomials are
// positive (the small ones have positive coefficients, the large ones at
// 1/h < 1/3.75 are above 0.36), as are exp(-h), rsqrt(h) and c. So g is
// finite and non-negative, and max(g, 0) returned g.
// The reciprocals, the reciprocal square root and the exponential are
// MUFU instructions (rcp/rsqrt/ex2.approx.ftz: about 1-2 ulp, a few for
// the exponential at the h <= 3.75 where it is used). The card's checks
// hold the kernels within 1e-4 (mmse.cu) and 2e-4 (fused_tail.cu) of the
// plain version (torch.special.i0e / i1e).
__device__ __forceinline__ float mmse_step(const MmseFrame& fr,
                                           MmseCarry& s) {
  // I0 small (A&S 9.8.1), I1 small (9.8.3), I0 large (9.8.2), and the
  // sum of I0 large and I1 large (9.8.4)
  constexpr float S0[7] = {
      mmse_small(1.0, 0), mmse_small(3.5156229, 1),
      mmse_small(3.0899424, 2), mmse_small(1.2067492, 3),
      mmse_small(0.2659732, 4), mmse_small(0.0360768, 5),
      mmse_small(0.0045813, 6)};
  constexpr float S1[7] = {
      mmse_small(0.5, 0), mmse_small(0.87890594, 1),
      mmse_small(0.51498869, 2), mmse_small(0.15084934, 3),
      mmse_small(0.02658733, 4), mmse_small(0.00301532, 5),
      mmse_small(0.00032411, 6)};
  constexpr float L0[9] = {
      mmse_large(0.39894228, 0), mmse_large(0.01328592, 1),
      mmse_large(0.00225319, 2), mmse_large(-0.00157565, 3),
      mmse_large(0.00916281, 4), mmse_large(-0.02057706, 5),
      mmse_large(0.02635537, 6), mmse_large(-0.01647633, 7),
      mmse_large(0.00392377, 8)};
  constexpr float L01[9] = {
      mmse_large_sum(0.39894228, 0.39894228, 0),
      mmse_large_sum(0.01328592, -0.03988024, 1),
      mmse_large_sum(0.00225319, -0.00362018, 2),
      mmse_large_sum(-0.00157565, 0.00163801, 3),
      mmse_large_sum(0.00916281, -0.01031555, 4),
      mmse_large_sum(-0.02057706, 0.02282967, 5),
      mmse_large_sum(0.02635537, -0.02895312, 6),
      mmse_large_sum(-0.01647633, 0.01787654, 7),
      mmse_large_sum(0.00392377, -0.00420059, 8)};
  // the chain: g2 -> xi -> h
  const float xi = fmaxf(fmaf(s.g2, s.ag, fr.prior), MMSE_XI_MIN);
  const float h = fmaxf(xi * fr.hg * rcp_ftz(1.f + xi), 0.5f * 1e-8f);
  // three MUFU instructions side by side, and the polynomials
  const float r = rsqrt_ftz(h);
  const float e = ex2_ftz(h * -MMSE_LOG2E);
  const float x = h * h, x2 = x * x;
  const float p0 = mmse_split7(S0, x, x2), p1 = mmse_split7(S1, x, x2);
  const float w = r * r, w2 = w * w;
  const float q0 = mmse_split9(L0, w, w2), q01 = mmse_split9(L01, w, w2);
  const bool small = h <= 3.75f;
  const float a0 = small ? p0 : q0;
  const float a01 = small ? fmaf(h, p1, p0) : q01;
  const float m = small ? e * (MMSE_SQRT2 * h) * r : MMSE_SQRT2;
  const float g = (fr.c * m) * fmaf(h + h, a01, a0);
  s.g2 = fminf(g * g, 100.f);
  s.ag = fr.ag;
  return fminf(g, 10.f);
}

// The step from a frame's power, for callers that compute nothing ahead.
__device__ __forceinline__ float mmse_step(float p, float inv_lam,
                                           float alpha, MmseCarry& s) {
  return mmse_step(mmse_frame(p, inv_lam, alpha), s);
}
