"""Kernel mode selection (the port's copy of the reference's
`kernels/backend.py`).

Modes:
  auto    — dispatch by the tensor's device: a CPU tensor runs the plain
            PyTorch version, a CUDA tensor launches the hand kernel (or the
            wrapper raises), a meta tensor runs the plain version, which
            only computes shapes there. The default.
  matmul  — the STFT, the iSTFT and the fused survivor tail take their
            matmul-DFT forms (`stft_dft/ref.py: stft_matmul, istft_matmul`,
            `fused_tail/ref.py: fused_tail_matmul`): bf16 operands, f32
            products, on every device. The FIR and the MMSE gain still
            dispatch by device. The dry-run counts this mode, as the
            reference lowers it (`launch/dryrun.py`).

The reference's `pallas`, `interpret` and `ref` modes choose between a
Pallas kernel and its jnp oracle; the port makes that choice by the
tensor's device, so they have no counterpart here.

The mode is one process-wide value, as in the reference: a worker process
of a plan takes its master's mode in its setup. Whatever caches results
keys on it (`framework_tag`).
"""
from __future__ import annotations

import contextlib

_VALID = ("auto", "matmul")
_MODE = "auto"


def set_mode(mode: str):
    global _MODE
    if mode not in _VALID:
        raise ValueError(f"mode {mode!r} not in {_VALID}")
    _MODE = mode


def get_mode() -> str:
    return _MODE


@contextlib.contextmanager
def use(mode: str):
    prev = _MODE
    set_mode(mode)
    try:
        yield
    finally:
        set_mode(prev)


def matmul_dft() -> bool:
    """True when the STFT, iSTFT and fused tail take their matmul-DFT
    forms (mode "matmul")."""
    return _MODE == "matmul"


def plain_on(device) -> bool:
    """True when a wrapper runs its plain version on `device` (cpu, and
    meta for shapes only); False for cuda, where it launches its kernel.
    Any other device raises."""
    kind = device.type
    if kind in ("cpu", "meta"):
        return True
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    return False


def framework_tag(device) -> str:
    """The content key's framework field for results computed on
    `device` under the current mode: `torch-<device type>`, and
    `torch-<device type>-matmul` under "matmul", so that a cached entry
    written under one mode never serves the other."""
    tag = f"torch-{device.type}"
    return tag + "-matmul" if _MODE == "matmul" else tag
