"""The plain PyTorch version of the MMSE-STSA gain (Ephraim & Malah 1984).

Uses `torch.special.i0e`/`i1e` (the kernel uses Abramowitz-Stegun
polynomials instead, so comparing the two is a real cross-check).

Per frame t, bin k (decision-directed a-priori SNR):
  gamma = |Y|^2 / lambda_noise                    (a-posteriori SNR)
  xi    = alpha * A^2_{t-1}/lambda + (1-alpha) * max(gamma-1, 0)
  v     = xi * gamma / (1 + xi)
  G     = (sqrt(pi)/2) * (sqrt(v)/gamma) * [(1+v) i0e(v/2) + v i1e(v/2)]
  A     = G * |Y|
"""
from __future__ import annotations

import torch

XI_MIN = 10.0 ** (-25.0 / 10.0)       # a-priori SNR floor (-25 dB)
GAMMA_MAX = 10.0 ** (40.0 / 10.0)     # a-posteriori SNR ceiling (40 dB)
SQRTPI_2 = 0.8862269254527580         # sqrt(pi)/2


def gain_fn(v, gamma):
    """MMSE-STSA gain from v and gamma (elementwise, f32)."""
    v = torch.clamp_min(v, 1e-8)
    g = (SQRTPI_2 * torch.sqrt(v) / gamma
         * ((1.0 + v) * torch.special.i0e(v / 2.0)
            + v * torch.special.i1e(v / 2.0)))
    return torch.clamp(g, 0.0, 10.0)


def mmse_stsa_gain_ref(power, noise_psd, alpha=0.98, gain_floor=0.1):
    """power: (B, F, K) |Y|^2; noise_psd: (B, K) -> gains (B, F, K) f32.
    A Python loop over frames: one small launch per operation and frame on
    the card, which is why this version is not the one the pipeline runs
    there."""
    power = power.float()
    lam = torch.clamp_min(noise_psd.float(), 1e-10)[:, None, :]
    gamma = torch.clamp(power / lam, 1e-8, GAMMA_MAX)
    a2 = torch.ones_like(gamma[:, 0, :])
    gains = torch.empty_like(gamma)
    for t in range(gamma.shape[1]):
        g_t = gamma[:, t]
        xi = alpha * a2 + (1.0 - alpha) * torch.clamp_min(g_t - 1.0, 0.0)
        xi = torch.clamp_min(xi, XI_MIN)
        g = gain_fn(xi * g_t / (1.0 + xi), g_t)
        a2 = (g * g) * g_t              # A^2/lambda for the next frame
        gains[:, t] = torch.clamp_min(g, gain_floor)
    return gains


def estimate_noise_psd(power, n_frames=16):
    """Initial-segment noise PSD estimate: mean of the first n_frames."""
    return power[:, :n_frames, :].mean(dim=1)


def denoise_power_ref(power, alpha=0.98, gain_floor=0.1, noise_frames=16):
    """The MMSE-STSA gains of `power` against its initial-segment noise
    estimate."""
    noise = estimate_noise_psd(power, noise_frames)
    return mmse_stsa_gain_ref(power, noise, alpha, gain_floor)
