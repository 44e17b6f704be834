"""Acoustic indices over STFT power spectra (Bedoya et al. 2017 style).

All functions take `power`: (B, F, K) f32 (F frames, K bins) and return
per-chunk (B,) indices. `freqs(k) = k * rate / window`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

EPS = 1e-10


def bin_freqs(window=256, rate_hz=22_050):
    return np.arange(window // 2 + 1) * rate_hz / window


@functools.lru_cache(maxsize=32)
def _band(device, dtype, lo_hz, hi_hz, window, rate_hz):
    f = bin_freqs(window, rate_hz)
    return torch.as_tensor((f >= lo_hz) & (f <= hi_hz), device=device,
                           dtype=dtype)


def psd_mean(power):
    """Broadband mean power spectral density (log-compressed)."""
    return torch.log1p(power.mean(dim=(1, 2)))


def frame_energy(power):
    """Per-frame energy envelope: (B, F)."""
    return power.sum(dim=-1)


def snr_est(power):
    """Estimated SNR in [0, 1): 1 - mean(envelope) / peak(envelope) (the
    paper's 'peak volume to average volume'). Silence and steady rain have
    flat envelopes (-> ~0); bird calls are peaky (-> ~1)."""
    env = frame_energy(power)
    return torch.clamp(1.0 - env.mean(dim=1) / (env.amax(dim=1) + EPS),
                       0.0, 1.0)


def spectral_flatness(power):
    """Wiener entropy averaged over frames: geometric / arithmetic mean.
    White-ish noise (rain) -> ~1; tonal signals -> ~0."""
    p = power + EPS
    geo = torch.exp(torch.log(p).mean(dim=-1))
    return (geo / p.mean(dim=-1)).mean(dim=1)


def band_energy_ratio(power, lo_hz, hi_hz, window=256, rate_hz=22_050):
    """Fraction of total energy inside [lo_hz, hi_hz]."""
    band = _band(power.device, power.dtype, lo_hz, hi_hz, window, rate_hz)
    total = power.sum(dim=(1, 2)) + EPS
    return (power * band).sum(dim=(1, 2)) / total


def band_peakiness(power, lo_hz, hi_hz, window=256, rate_hz=22_050):
    """Peak-bin to median-bin mean-PSD ratio within a band, plus the peak
    bin (the first one on ties, as `jnp.argmax`)."""
    f = bin_freqs(window, rate_hz)
    sel = (f >= lo_hz) & (f <= hi_hz)
    lo_bin = int(np.argmax(sel))
    n_sel = int(sel.sum())
    psd = power.mean(dim=1)                              # (B, K)
    band_psd = psd[:, lo_bin:lo_bin + n_sel]             # sel is contiguous
    peak = band_psd.amax(dim=1)
    # `jnp.median`: the mean of the two middle elements of the sorted bins
    # ((a + b) * 0.5), one and the same element for an odd bin count
    # (K = window/2 + 1 is odd for a window of 4m, even for 4m + 2, such
    # as 382). `torch.median` would return the lower one.
    K = psd.shape[1]
    srt = torch.sort(psd, dim=1).values
    med = (srt[:, (K - 1) // 2] + srt[:, K // 2]) * 0.5 + EPS
    peak_bin = torch.argmax(band_psd, dim=1) + lo_bin
    return peak / med, peak_bin


def temporal_persistence(power, lo_hz, hi_hz, window=256, rate_hz=22_050,
                         frac=0.5):
    """Fraction of frames whose band energy exceeds frac * broadband energy
    (separates sustained choruses from transient calls)."""
    band = _band(power.device, power.dtype, lo_hz, hi_hz, window, rate_hz)
    be = (power * band).sum(dim=-1)                      # (B, F)
    te = power.sum(dim=-1) + EPS
    return ((be / te) > frac).float().mean(dim=1)


def spectral_flux(power):
    """Onset strength via half-wave-rectified spectral flux: the chunk's
    peak per-frame sum of positive power rises, relative to its mean
    envelope energy."""
    rise = torch.clamp_min(power[:, 1:] - power[:, :-1], 0.0)
    peak = rise.sum(dim=-1).amax(dim=1)
    return peak / (frame_energy(power).mean(dim=1) + EPS)


def all_indices(power, cfg):
    """The index vector used by the rule classifiers."""
    pk, peak_bin = band_peakiness(power, *cfg.cicada_band_hz,
                                  cfg.stft_window, cfg.target_rate_hz)
    return {
        "psd": psd_mean(power),
        "snr": snr_est(power),
        "flux": spectral_flux(power),
        "flatness": spectral_flatness(power),
        "rain_band": band_energy_ratio(power, *cfg.rain_low_band_hz,
                                       cfg.stft_window, cfg.target_rate_hz),
        "cicada_band": band_energy_ratio(power, *cfg.cicada_band_hz,
                                         cfg.stft_window, cfg.target_rate_hz),
        "cicada_peakiness": pk,
        "cicada_peak_bin": peak_bin,
        "cicada_persistence": temporal_persistence(
            power, *cfg.cicada_band_hz, cfg.stft_window, cfg.target_rate_hz),
    }
