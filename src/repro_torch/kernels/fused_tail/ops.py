"""Public wrappers for the fused survivor tail.

`fused_tail_spectrum` dispatches by the device of `wave`: a CPU tensor runs
`ref.fused_tail_spectrum_ref`, a CUDA tensor launches `csrc/fused_tail.cu`
(gather + optional high-pass + STFT + noise PSD + MMSE gain in one pass).
It takes the STFT kernel's framing (`fft_tables.check_geometry`): windows
of 128, 256 and 512 run the warp-specialised FFT kernel (`KERNEL`), the
other even windows up to 510 the direct-DFT kernel tiled by bins
(`DFT_KERNEL`), one entry point with two launch counts. `finish` is the irfft overlap-add
outside the kernel, as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, require_cuda
from repro_torch.kernels.fir_hpf import ref as FR
from repro_torch.kernels.fir_hpf.ops import taps_on
from repro_torch.kernels.fused_tail import ref as R
from repro_torch.kernels.stft_dft import fft_tables as FT
from repro_torch.kernels.stft_dft import ref as SR
from repro_torch.kernels.stft_dft.ops import tables_on

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float]
KERNEL = CudaKernel("fused_tail", "fused_tail_forward", _ARGTYPES)
DFT_KERNEL = CudaKernel("fused_tail", "fused_tail_forward", _ARGTYPES)


def fused_tail_spectrum_cuda(wave, idx, cfg, hpf=False):
    """The hand kernel: wave (B, S) f32 CUDA, idx (R,) int32 on the same
    device -> gain-filtered spectrum, complex64 (R, Fv, K)."""
    wave = wave.float().contiguous()
    window, hop = cfg.stft_window, cfg.stft_hop
    FT.check_geometry(window, hop)
    tables = tables_on(wave.device, window)
    dev = require_cuda(wave, tables)
    idx = idx.contiguous()
    require_cuda(idx, dtype=torch.int32)
    B, S = wave.shape
    rows = idx.shape[0]
    K = window // 2 + 1
    Fv = SR.num_frames(S, window, hop)
    if cfg.noise_est_frames < 1:
        raise ValueError("noise_est_frames must be at least 1")
    if idx.device != dev or Fv < 1:
        raise ValueError(f"fused_tail_spectrum_cuda: unsupported wave "
                         f"{tuple(wave.shape)} / idx {tuple(idx.shape)} on "
                         f"{idx.device}")
    taps, T = None, 0
    if hpf:
        taps = taps_on(dev, FR.highpass_taps,
                       (cfg.hpf_cutoff_hz, cfg.target_rate_hz, cfg.hpf_taps))
        T = taps.shape[0]
    out = torch.empty((rows, Fv, K, 2), dtype=torch.float32, device=dev)
    kernel = KERNEL if FT.uses_fft(window) else DFT_KERNEL
    kernel(dev, wave.data_ptr(), idx.data_ptr(), tables.data_ptr(),
           None if taps is None else taps.data_ptr(), out.data_ptr(), B, S,
           rows, Fv, window, T, cfg.noise_est_frames,
           float(cfg.mmse_alpha), float(cfg.mmse_gain_floor))
    return torch.view_as_complex(out)


def fused_tail_spectrum(wave, idx, cfg, hpf=False):
    """(B, S) batch + (R,) padded survivor indices -> gain-filtered
    spectrum, complex (R, Fv, K), by the device of `wave`."""
    if wave.device.type == "cpu":
        return R.fused_tail_spectrum_ref(wave, idx, cfg, hpf)
    if wave.device.type != "cuda":
        raise ValueError(f"unsupported device {wave.device}")
    return fused_tail_spectrum_cuda(wave, idx, cfg, hpf)


def finish(spec, S, cfg):
    """Inverse-DFT overlap-add of the filtered spectrum (R, Fv, K) ->
    (R, S), the same `istft_ref` the staged tail runs."""
    return SR.istft_ref(spec, S, cfg.stft_window, cfg.stft_hop)


def fused_tail(wave, idx, cfg, hpf=False):
    """The fused survivor tail: (B, S) batch + (R,) padded survivor index
    vector -> cleaned (R, S)."""
    return finish(fused_tail_spectrum(wave, idx, cfg, hpf), wave.shape[1],
                  cfg)
