"""Public wrappers for the FIR kernel: high-pass and fused band-pass +
decimate (the pipeline's downsample + HPF stage).

Dispatch goes by the tensor's device: a CPU tensor runs `ref.fir_ref`, a
CUDA tensor launches `csrc/fir.cu`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda
from repro_torch.kernels.fir_hpf import ref as R

KERNEL = CudaKernel("fir", "fir_forward", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong])


@functools.lru_cache(maxsize=16)
def taps_on(device, design_fn, design):
    return torch.as_tensor(design_fn(*design), device=device)


def fir_cuda(x, taps, stride=1):
    """The hand kernel: x (B, S) f32 CUDA, taps (T,) f32 on the same
    device -> (B, S // stride)."""
    x = x.float().contiguous()
    dev = require_cuda(x, taps)
    B, S = x.shape
    T = taps.shape[0]
    if not 1 <= B <= 65535 or stride < 1 or T < 1:
        raise ValueError(f"fir_cuda: unsupported B={B}, stride={stride}, "
                         f"T={T}")
    out_len = S // stride
    y = torch.empty((B, out_len), dtype=torch.float32, device=dev)
    KERNEL(dev, x.data_ptr(), taps.data_ptr(), y.data_ptr(), B, S, T,
           stride, out_len)
    return y


def _filter(x, design_fn, design, stride):
    if x.device.type == "cpu":
        return R.fir_ref(x, design_fn(*design), stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return fir_cuda(x, taps_on(x.device, design_fn, design), stride)


def highpass(x, cutoff_hz=1000.0, rate_hz=22_050, n_taps=129):
    """1 kHz high-pass at the working rate. x: (B, S) -> (B, S)."""
    return _filter(x, R.highpass_taps, (cutoff_hz, rate_hz, n_taps), 1)


def bandpass_decimate(x, f_lo_hz=1000.0, f_hi_hz=11_025.0, rate_hz=44_100,
                      factor=2, n_taps=129):
    """Fused anti-alias + high-pass + decimate. x: (B, S) @rate ->
    (B, S // factor) @rate/factor, band-limited to [f_lo, f_hi]."""
    return _filter(x, R.bandpass_decimate_taps,
                   (f_lo_hz, f_hi_hz, rate_hz, n_taps), factor)
