"""Tap design and the plain PyTorch version of the FIR kernel.

Tap design: windowed sinc, computed in numpy exactly as the reference does
(`repro/kernels/fir_hpf/ref.py`), so both sides filter with identical f32
taps. The pipeline's "downsample then high-pass" pair is one band-pass FIR
applied at the source rate with stride-2 decimation:
h = lowpass(f_nyq_target) - lowpass(f_hp).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _lowpass_taps(cutoff_norm, n_taps):
    """Windowed-sinc lowpass; cutoff_norm = f_c / f_s (0..0.5)."""
    m = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = 2.0 * cutoff_norm * np.sinc(2.0 * cutoff_norm * m)
    h *= np.hamming(n_taps)
    return h / h.sum()


def highpass_taps(cutoff_hz, rate_hz, n_taps=129):
    """Spectral-inversion highpass (delta - lowpass)."""
    h = -_lowpass_taps(cutoff_hz / rate_hz, n_taps)
    h[(n_taps - 1) // 2] += 1.0
    return np.asarray(h, np.float32)


def bandpass_decimate_taps(f_lo_hz, f_hi_hz, rate_hz, n_taps=129):
    """Band-pass taps for fused HPF + anti-alias decimation (at source rate)."""
    h = _lowpass_taps(f_hi_hz / rate_hz, n_taps) - _lowpass_taps(
        f_lo_hz / rate_hz, n_taps)
    return np.asarray(h, np.float32)


def fir_ref(x, taps, stride=1):
    """Causal FIR + decimation. x: (B, S) -> (B, S // stride),
    y[n] = sum_k h[k] * x[n*stride - k] (x zero-padded on the left).

    On a CUDA tensor `conv1d` goes through cuDNN, which runs f32 in TF32
    unless `torch.backends.cudnn.allow_tf32` is False; set it False before
    comparing against this version on the card."""
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    T = taps.shape[0]
    xp = F.pad(x.float()[:, None, :], (T - 1, 0))
    out = F.conv1d(xp, taps.flip(0)[None, None, :], stride=stride)
    return out[:, 0, :x.shape[1] // stride]
