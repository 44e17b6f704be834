"""Constants and the plain PyTorch versions of the STFT kernel
(framing + Hamming window + real DFT) and of the inverse STFT.

`stft_ref` uses `torch.fft.rfft`, not the kernel's own FFT passes, so
comparing the two is a real cross-check. The window is built in numpy
exactly as the reference builds it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def hamming(n):
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))


def num_frames(n_samples, window, hop):
    return (n_samples - window) // hop + 1


def frame(x, window, hop):
    """x: (..., S) -> (..., F, window), a strided view (frame f starts at
    sample f*hop)."""
    return x.unfold(-1, window, hop)


@functools.lru_cache(maxsize=16)
def _window_on(device, window):
    return torch.as_tensor(hamming(window), dtype=torch.float32,
                           device=device)


def stft_ref(x, window=256, hop=128):
    """x: (B, S) f32 -> (B, F, window//2+1) complex64."""
    frames = frame(x.float(), window, hop) * _window_on(x.device, window)
    return torch.fft.rfft(frames, dim=-1)


def stft_ref_packed(x, window=256, hop=128):
    """Packed real output (B, F, 2*(window//2+1)): [re | im]."""
    z = stft_ref(x, window, hop)
    return torch.cat([z.real, z.imag], dim=-1)


def power_spectrum(x, window=256, hop=128):
    return stft_ref(x, window, hop).abs() ** 2


@functools.lru_cache(maxsize=16)
def _ola_norm(device, window, hop, n_frames, n_samples):
    """1 / max(sum of window^2 over the overlapping frames, 1e-8) per output
    sample, built in numpy as the reference builds it."""
    n_even = (n_frames + 1) // 2
    n_odd = n_frames - n_even
    L = n_even * window + hop
    wn = (hamming(window) ** 2).astype(np.float32)
    norm = np.zeros(L, np.float32)
    norm[:n_even * window] += np.tile(wn, n_even)
    norm[hop:hop + n_odd * window] += np.tile(wn, n_odd)
    norm = norm[:n_samples]
    if L < n_samples:
        norm = np.pad(norm, (0, n_samples - L))
    return torch.as_tensor(np.maximum(norm, np.float32(1e-8)), device=device)


def istft_ref(z, n_samples, window=256, hop=128):
    """Inverse STFT by windowed overlap-add with window-squared
    normalisation (50% overlap: even and odd frames each tile the timeline
    contiguously, so the overlap-add is two reshapes and one shifted add).
    z: (B, F, K) complex -> (B, n_samples) f32."""
    if 2 * hop != window:
        raise ValueError("istft_ref implements the 50%-overlap case")
    frames = torch.fft.irfft(z, n=window, dim=-1) * _window_on(z.device,
                                                               window)
    B, F, _ = frames.shape
    n_even = (F + 1) // 2
    n_odd = F - n_even
    L = n_even * window + hop
    out = torch.zeros((B, L), dtype=torch.float32, device=z.device)
    out[:, :n_even * window] = frames[:, 0::2].reshape(B, -1)
    out[:, hop:hop + n_odd * window] += frames[:, 1::2].reshape(B, -1)
    out = out[:, :n_samples]
    if L < n_samples:
        out = torch.nn.functional.pad(out, (0, n_samples - L))
    return out / _ola_norm(z.device, window, hop, F, n_samples)[None, :]
