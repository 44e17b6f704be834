"""Public wrappers for the STFT kernel.

Dispatch goes by the tensor's device: a CPU tensor runs `ref.stft_ref`
(`torch.fft.rfft`), a CUDA tensor launches `csrc/stft.cu`. The kernel
reads overlapping frames straight from the row, so it needs no padding;
it takes hop = window/2 with an even window of 4 to 512 samples
(`fft_tables.check_geometry`) and raises `ValueError` on anything else.
Windows of 128, 256 and 512 run the FFT (`KERNEL`), the others the direct
DFT on the tensor cores (`DFT_KERNEL`): one entry point, two launch
counts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import MAX_GRID_Y, CudaKernel, require_cuda
from repro_torch.kernels.stft_dft import fft_tables as FT
from repro_torch.kernels.stft_dft import ref as R

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
KERNEL = CudaKernel("stft", "stft_forward", _ARGTYPES)
DFT_KERNEL = CudaKernel("stft", "stft_forward", _ARGTYPES)


@functools.lru_cache(maxsize=16)
def tables_on(device, window):
    """The kernels' table at `window` (`fft_tables.kernel_tables`: the FFT's
    twiddles and window, or the DFT's basis and window) on `device`."""
    return torch.as_tensor(FT.kernel_tables(window), device=device)


def stft_cuda(x, window=256, hop=128):
    """The hand kernel: x (B, S) f32 CUDA -> complex64 (B, F, K),
    F = (S - window) // hop + 1."""
    FT.check_geometry(window, hop)
    x = x.float().contiguous()
    tables = tables_on(x.device, window)
    dev = require_cuda(x, tables)
    B, S = x.shape
    K = window // 2 + 1
    F = R.num_frames(S, window, hop)
    if B < 1 or F < 1:
        raise ValueError(f"stft_cuda: unsupported B={B}, S={S}")
    out = torch.empty((B, F, K, 2), dtype=torch.float32, device=dev)
    kernel = KERNEL if FT.uses_fft(window) else DFT_KERNEL
    # the FFT kernel's rows go on the grid's y axis: one launch per block of
    # MAX_GRID_Y rows
    for r0 in range(0, B, MAX_GRID_Y):
        kernel(dev, x[r0].data_ptr(), tables.data_ptr(), out[r0].data_ptr(),
               min(MAX_GRID_Y, B - r0), S, F, window)
    return torch.view_as_complex(out)


def stft(x, window=256, hop=128):
    """x: (B, S) -> complex (B, F, window//2+1), by the tensor's device."""
    if x.device.type == "cpu":
        return R.stft_ref(x, window, hop)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return stft_cuda(x, window, hop)


def stft_power(x, window=256, hop=128):
    """x: (B, S) -> power spectrum (B, F, bins) f32."""
    z = stft(x, window, hop)
    return z.real ** 2 + z.imag ** 2


def istft(z, n_samples, window=256, hop=128):
    """Inverse STFT (irfft overlap-add; cuFFT on the card)."""
    return R.istft_ref(z, n_samples, window, hop)
