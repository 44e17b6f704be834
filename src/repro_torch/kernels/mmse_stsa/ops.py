"""Public wrapper for the MMSE-STSA gain kernel.

Dispatch goes by the tensor's device: a CPU tensor runs
`ref.mmse_stsa_gain_ref`, a CUDA tensor launches `csrc/mmse.cu`, a meta
tensor runs the plain version for its shape (in every backend mode).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels._build import MAX_GRID_Y, CudaKernel, require_cuda
from repro_torch.kernels.mmse_stsa import ref as R

KERNEL = CudaKernel("mmse", "mmse_forward", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float])


def mmse_gain_cuda(power, noise_psd, alpha=0.98, gain_floor=0.1):
    """The hand kernel: power (B, F, K) and noise (B, K), f32 CUDA ->
    gains (B, F, K)."""
    power = power.float().contiguous()
    noise = noise_psd.float().contiguous()
    dev = require_cuda(power, noise)
    B, F, K = power.shape
    if noise.shape != (B, K) or B < 1:
        raise ValueError(f"mmse_gain_cuda: power {tuple(power.shape)} and "
                         f"noise {tuple(noise.shape)} do not match")
    gains = torch.empty_like(power)
    # rows go on the grid's y axis: one launch per block of MAX_GRID_Y rows
    for b0 in range(0, B, MAX_GRID_Y):
        KERNEL(dev, power[b0].data_ptr(), noise[b0].data_ptr(),
               gains[b0].data_ptr(), min(MAX_GRID_Y, B - b0), F, K,
               float(alpha), float(gain_floor))
    return gains


def mmse_gain(power, noise_psd, alpha=0.98, gain_floor=0.1):
    """power: (B, F, K) |Y|^2; noise_psd: (B, K) -> gains (B, F, K)."""
    if backend.plain_on(power.device):
        return R.mmse_stsa_gain_ref(power, noise_psd, alpha, gain_floor)
    return mmse_gain_cuda(power, noise_psd, alpha, gain_floor)


def denoise_spectrum(spec, alpha=0.98, gain_floor=0.1, noise_frames=16):
    """spec: complex (B, F, K) STFT -> gain-filtered complex spectrum."""
    power = spec.real ** 2 + spec.imag ** 2
    noise = R.estimate_noise_psd(power, noise_frames)
    return spec * mmse_gain(power, noise, alpha, gain_floor)
