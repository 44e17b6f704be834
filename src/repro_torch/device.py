"""Device resolution for the port's entry points.

The card is the default. Without one, an entry point raises unless the
caller asked for the CPU explicitly: a run that silently fell back to the
CPU would report CPU numbers under the card's name.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device (raises when there is none);
    anything else -> `torch.device(device)`, which must be cpu or cuda."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected cpu or cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev
