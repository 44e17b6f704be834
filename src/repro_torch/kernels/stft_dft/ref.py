"""Constants and the plain PyTorch versions of the STFT kernel
(framing + Hamming window + real DFT) and of the inverse STFT, and their
matmul-DFT forms.

`stft_ref` uses `torch.fft.rfft`, not the kernel's own FFT passes, so
comparing the two is a real cross-check. The window is built in numpy
exactly as the reference builds it.

`stft_matmul` / `istft_matmul` are the reference's forms of the same
functions for backend mode "matmul" (`kernels/backend.py`): the DFT as a
matmul with the windowed basis, its operands rounded to `MATMUL_DTYPE`
(bf16) and their exact products summed in f32, the result left in f32.
The forward form runs on the STFT kernel's tile-padded row
(`pad_for_stft`), as the reference's does, so that the dry-run counts the
reference's computation shape.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


FRAME_TILE = 128        # the reference's STFT kernel tile, in frames
PAD_OUT = 384           # the reference's packed basis width: 2 * 129 -> 384
MATMUL_DTYPE = torch.bfloat16


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


def pad_for_stft(x, window=256, hop=128):
    """Right-pad (B, S) with zeros so its frame count is a multiple of
    `FRAME_TILE` (the reference's `stft_dft.ops.pad_for_stft`)."""
    S = x.shape[-1]
    tile_span = FRAME_TILE * hop
    tail = window - hop
    n_tiles = max(1, -(-(S - tail) // tile_span))
    target = n_tiles * tile_span + tail
    if target > S:
        x = torch.nn.functional.pad(x, (0, target - S))
    return x


@functools.lru_cache(maxsize=16)
def _fwd_basis(device, window, dtype):
    """The reference's packed windowed real-DFT basis (window, PAD_OUT):
    [cos | -sin | zeros], rows scaled by the Hamming window, built in
    numpy f32 as the reference builds it, then rounded to `dtype` (held
    in f32)."""
    bins = window // 2 + 1
    n = np.arange(window)[:, None]
    k = np.arange(bins)[None, :]
    ang = 2.0 * np.pi * n * k / window
    basis = np.zeros((window, max(PAD_OUT, 2 * bins)), np.float32)
    basis[:, :bins] = np.cos(ang)
    basis[:, bins:2 * bins] = -np.sin(ang)
    basis *= hamming(window)[:, None]
    return torch.as_tensor(basis, device=device).to(dtype).float()


@functools.lru_cache(maxsize=16)
def _inv_basis(device, window, dtype):
    """(2 * bins, window): the irfft of each unit bin, real then
    imaginary, as the reference builds it, rounded to `dtype` (held in
    f32)."""
    bins = window // 2 + 1
    m_re = np.fft.irfft(np.eye(bins), n=window)
    m_im = np.fft.irfft(1j * np.eye(bins), n=window)
    ib = np.concatenate([m_re, m_im], 0).astype(np.float32)
    return torch.as_tensor(ib, device=device).to(dtype).float()


def _matmul_f32(a, basis):
    """a @ basis with `a` rounded to `MATMUL_DTYPE` (the basis is already)
    and their exact products summed in f32: the reference's einsum with
    `preferred_element_type=float32`. The result is f32, not rounded."""
    return torch.matmul(a.to(MATMUL_DTYPE).float(), basis)


def stft_matmul(x, window=256, hop=128):
    """Frame + windowed DFT as one matmul: x (B, S) -> complex (B, F,
    window//2+1) with F = num_frames(S); S as the caller gives it (the
    dispatching `ops.stft` pads it to the tile first)."""
    bins = window // 2 + 1
    basis = _fwd_basis(x.device, window, MATMUL_DTYPE)
    packed = _matmul_f32(frame(x.float(), window, hop), basis)
    return torch.complex(packed[..., :bins], packed[..., bins:2 * bins])


def istft_matmul(z, n_samples, window=256, hop=128):
    """Overlap-add inverse with the inverse DFT as a matmul (no irfft).
    z: (B, F, K) complex -> (B, n_samples) f32."""
    if 2 * hop != window:
        raise ValueError("istft_matmul implements the 50%-overlap case")
    packed = torch.cat([z.real, z.imag], dim=-1)
    frames = _matmul_f32(packed, _inv_basis(z.device, window, MATMUL_DTYPE))
    return _overlap_add(frames * _window_on(z.device, window), n_samples,
                        window, hop)


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
    return _overlap_add(frames, n_samples, window, hop)


def _overlap_add(frames, n_samples, window, hop):
    """Windowed frames (B, F, window) -> (B, n_samples), normalised by the
    summed window squares."""
    B, F, _ = frames.shape
    n_even = (F + 1) // 2
    n_odd = F - n_even
    L = n_even * window + hop
    out = torch.zeros((B, L), dtype=torch.float32, device=frames.device)
    out[:, :n_even * window] = frames[:, 0::2].reshape(B, -1)
    out[:, hop:hop + n_odd * window] += frames[:, 1::2].reshape(B, -1)
    out = out[:, :n_samples]
    if L < n_samples:
        out = torch.nn.functional.pad(out, (0, n_samples - L))
    return out / _ola_norm(frames.device, window, hop, F,
                           n_samples)[None, :]
