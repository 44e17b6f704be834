"""The plain PyTorch version of the fused survivor tail, composed from the
per-stage plain versions the staged tail runs:

    fill gather -> fir_ref high-pass (optional) -> stft_ref (the Fv valid
    frames) -> |.|^2 -> estimate_noise_psd -> mmse_stsa_gain_ref
    -> spec * gain -> istft_ref
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fir_hpf import ref as FR
from repro_torch.kernels.mmse_stsa import ref as MR
from repro_torch.kernels.stft_dft import ref as SR


def gather_rows(wave, idx):
    """The survivor gather with the scheduler's pad convention: rows
    `wave[idx]`, where an index outside [0, B) (the scheduler pads with
    B) gives an all-zero row. Unlike `jnp.take`, a negative index is a pad
    slot too rather than counting from the end; the scheduler never
    makes one."""
    B = wave.shape[0]
    idx = idx.to(device=wave.device, dtype=torch.long)
    valid = (idx >= 0) & (idx < B)
    rows = wave[idx.clamp(0, B - 1)]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def fused_tail_spectrum_ref(wave, idx, cfg, hpf=False):
    """wave: (B, S) pre-denoise batch; idx: (R,) padded survivor indices.
    Returns the gain-filtered spectrum, complex (R, Fv, K)."""
    batch = gather_rows(wave.float(), idx)
    if hpf:
        taps = FR.highpass_taps(cfg.hpf_cutoff_hz, cfg.target_rate_hz,
                                cfg.hpf_taps)
        batch = FR.fir_ref(batch, taps, 1)
    # on the unpadded row, rfft framing gives exactly the Fv valid frames
    spec = SR.stft_ref(batch, cfg.stft_window, cfg.stft_hop)
    power = spec.real ** 2 + spec.imag ** 2
    noise = MR.estimate_noise_psd(power, cfg.noise_est_frames)
    gain = MR.mmse_stsa_gain_ref(power, noise, cfg.mmse_alpha,
                                 cfg.mmse_gain_floor)
    return spec * gain


def fused_tail_ref(wave, idx, cfg, hpf=False):
    """Cleaned survivors (R, S) f32."""
    return SR.istft_ref(fused_tail_spectrum_ref(wave, idx, cfg, hpf),
                        wave.shape[1], cfg.stft_window, cfg.stft_hop)
