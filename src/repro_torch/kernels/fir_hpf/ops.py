"""Public wrappers for the FIR kernel: high-pass and fused band-pass +
decimate (the pipeline's downsample + HPF stage).

Dispatch goes by the tensor's device: a CPU tensor runs `ref.fir_ref`, a
CUDA tensor launches `csrc/fir.cu`. The taps stay on the host: the kernel
takes them in its launch parameters as the polyphase table of
`tiling.phase_taps`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel, require_cuda
from repro_torch.kernels.fir_hpf import ref as R
from repro_torch.kernels.fir_hpf import tiling

KERNEL = CudaKernel("fir", "fir_forward", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int])


@functools.lru_cache(maxsize=16)
def taps_on(device, design_fn, design):
    return torch.as_tensor(design_fn(*design), device=device)


@functools.lru_cache(maxsize=32)
def _tap_table(h_bytes, stride):
    """(layout, read-only polyphase table) of f32 taps given as bytes."""
    h = np.frombuffer(h_bytes, np.float32)
    table = tiling.phase_taps(h, stride)
    table.flags.writeable = False
    return tiling.layout(h.shape[0], stride), table


def fir_cuda(x, taps, stride=1):
    """The hand kernel: x (B, S) f32 CUDA, taps (T,) f32 on the host (a
    numpy array or a CPU tensor) -> (B, S // stride) on x's device."""
    x = x.float().contiguous()
    dev = require_cuda(x)
    if torch.is_tensor(taps):
        if taps.device.type != "cpu":
            raise ValueError(f"fir_cuda: taps go in the launch parameters "
                             f"and must be on the host, got {taps.device}")
        taps = taps.numpy()
    h = np.asarray(taps)
    B, S = x.shape
    if h.dtype != np.float32 or h.ndim != 1 or B < 1 or stride < 1 \
            or h.shape[0] < 1:
        raise ValueError(f"fir_cuda: unsupported B={B}, stride={stride}, "
                         f"taps {h.dtype} {h.shape}")
    lay, table = _tap_table(h.tobytes(), stride)
    # a table too long for the parameters is read from device memory
    table_dev = (None if lay.taps_in_params
                 else torch.as_tensor(table, device=dev))
    out_len = S // stride
    y = torch.empty((B, out_len), dtype=torch.float32, device=dev)
    KERNEL(dev, x.data_ptr(), y.data_ptr(), table.ctypes.data,
           None if table_dev is None else table_dev.data_ptr(), B, S,
           out_len, stride, lay.L, lay.P, lay.A)
    return y


def _filter(x, design_fn, design, stride):
    if x.device.type == "cpu":
        return R.fir_ref(x, design_fn(*design), stride)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return fir_cuda(x, taps_on(torch.device("cpu"), design_fn, design),
                    stride)


def highpass(x, cutoff_hz=1000.0, rate_hz=22_050, n_taps=129):
    """1 kHz high-pass at the working rate. x: (B, S) -> (B, S)."""
    return _filter(x, R.highpass_taps, (cutoff_hz, rate_hz, n_taps), 1)


def bandpass_decimate(x, f_lo_hz=1000.0, f_hi_hz=11_025.0, rate_hz=44_100,
                      factor=2, n_taps=129):
    """Fused anti-alias + high-pass + decimate. x: (B, S) @rate ->
    (B, S // factor) @rate/factor, band-limited to [f_lo, f_hi]."""
    return _filter(x, R.bandpass_decimate_taps,
                   (f_lo_hz, f_hi_hz, rate_hz, n_taps), factor)
