"""Hand-written Hopper kernels (CUDA C++ under `csrc/`) and, beside each,
its plain PyTorch version (`ref.py`). Each `ops.py` wrapper dispatches by
the device of its tensor: plain version on the CPU, kernel on the card.

`KERNELS` maps each kernel's module name to its launcher, whose
`launches` count shows which kernels a run went through.
"""
from repro_torch.kernels.fir_hpf import ops as _fir
from repro_torch.kernels.fused_tail import ops as _fused
from repro_torch.kernels.mmse_stsa import ops as _mmse
from repro_torch.kernels.stft_dft import ops as _stft

KERNELS = {
    "fir_hpf": _fir.KERNEL,
    "stft_dft": _stft.KERNEL,
    "mmse_stsa": _mmse.KERNEL,
    "fused_tail": _fused.KERNEL,
    # the same two entry points at the windows that take the direct DFT
    "stft_dft_generic": _stft.DFT_KERNEL,
    "fused_tail_generic": _fused.DFT_KERNEL,
}


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
