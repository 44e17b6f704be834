"""Pipeline stage library (batched tensor functions).

Stage order and chunk geometry follow the paper: 60 s long chunks (band-
pass FIR at long splits) -> 15 s detect chunks (most accurate for rain and
cicada) -> 5 s final chunks (silence resolution) -> MMSE-STSA last
(dominant cost, skipped for removed audio). The FIR, STFT and MMSE steps
run through the kernel wrappers; everything else is plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fir_hpf import ops as fir
from repro_torch.kernels.mmse_stsa import ops as mmse_ops
from repro_torch.kernels.mmse_stsa import ref as mmse_ref
from repro_torch.kernels.stft_dft import ops as stft_ops


def to_mono(x):
    """(B, C, S) -> (B, S). Averaging the channels keeps SNR slightly
    better than dropping one, at identical cost."""
    return x.mean(dim=1)


def compress(x_mono, cfg):
    """Fused downsample (44.1 -> 22.05 kHz) + 1 kHz high-pass: one
    band-pass FIR with stride-2 decimation."""
    return fir.bandpass_decimate(
        x_mono, f_lo_hz=cfg.hpf_cutoff_hz,
        f_hi_hz=cfg.target_rate_hz / 2.0, rate_hz=cfg.source_rate_hz,
        factor=cfg.source_rate_hz // cfg.target_rate_hz, n_taps=cfg.hpf_taps)


def split(x, n_sub):
    """(B, S) -> (B * n_sub, S // n_sub)."""
    B, S = x.shape
    return x.reshape(B * n_sub, S // n_sub)


def valid_frames(n_samples, window, hop):
    return (n_samples - window) // hop + 1


def stft_chunks(x, cfg):
    """(B, S) -> (spec complex (B, Fv, K), power (B, Fv, K)), the Fv frames
    that lie inside the chunk. The STFT is computed once per chunk and
    shared by every acoustic index."""
    spec = stft_ops.stft(x, cfg.stft_window, cfg.stft_hop)
    return spec, spec.real ** 2 + spec.imag ** 2


def remove_cicada_band(spec, peak_bin, mask, cfg):
    """Band-stop around the detected chorus peak, applied only where mask.
    spec: (B, F, K) complex; peak_bin / mask: (B,)."""
    K = spec.shape[-1]
    width_bins = int(round(cfg.cicada_stop_width_hz
                           / (cfg.target_rate_hz / cfg.stft_window)))
    k = torch.arange(K, device=spec.device)[None, :]
    stop = (k - peak_bin[:, None]).abs() <= (width_bins // 2)
    stop = stop & mask[:, None]
    return torch.where(stop[:, None, :],
                       torch.zeros((), dtype=spec.dtype, device=spec.device),
                       spec)


def istft_chunks(spec, n_samples, cfg):
    return stft_ops.istft(spec, n_samples, cfg.stft_window, cfg.stft_hop)


def group_frames(power, n_groups, chunk_samples, cfg):
    """Regroup a chunk's frames into n_groups sub-chunks (15 s spectra ->
    3 x 5 s frame groups, reusing the single STFT). Returns
    (B * n_groups, Fg, K). The starts use Python's round, as the
    reference does."""
    B, F, K = power.shape
    sub = chunk_samples // n_groups
    Fg = valid_frames(sub, cfg.stft_window, cfg.stft_hop)
    starts = [min(int(round(i * sub / cfg.stft_hop)), F - Fg)
              for i in range(n_groups)]
    groups = torch.stack([power[:, s:s + Fg] for s in starts], dim=1)
    return groups.reshape(B * n_groups, Fg, K)


def tail_highpass(wave, cfg):
    """Stride-1 FIR high-pass at the target rate, for the survivor tail.
    wave: (B, S5) -> (B, S5)."""
    return fir.highpass(wave, cfg.hpf_cutoff_hz, cfg.target_rate_hz,
                        cfg.hpf_taps)


def mmse_denoise(wave, cfg):
    """The dominant stage: STFT -> MMSE-STSA gain -> iSTFT.
    wave: (B, S5) -> cleaned (B, S5)."""
    spec, power = stft_chunks(wave, cfg)
    noise = mmse_ref.estimate_noise_psd(power, cfg.noise_est_frames)
    gain = mmse_ops.mmse_gain(power, noise, alpha=cfg.mmse_alpha,
                              gain_floor=cfg.mmse_gain_floor)
    return istft_chunks(spec * gain, wave.shape[1], cfg)
