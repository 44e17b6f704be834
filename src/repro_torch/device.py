"""Device resolution for the port's entry points.

The card is the default. Without one, an entry point raises unless the
caller asked for the CPU explicitly: a run that silently fell back to the
CPU would report CPU numbers under the card's name.
"""
from __future__ import annotations

import os

import numpy as np
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


def to_host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array (a tensor on
    the card is copied back; numpy's `asarray` would raise on it)."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def visible_cards() -> list:
    """This process's cards as `CUDA_VISIBLE_DEVICES` names them, in its
    own order (their indices where it is unset): position i is card i of
    this process."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return (visible.split(",") if visible else
            [str(i) for i in range(torch.cuda.device_count())])


def worker_env(device: torch.device, shard: int) -> dict:
    """Environment additions for worker process `shard` of a master on
    `device`: with more than one card visible, the one card it is pinned
    to (card shard mod count); with one card or on the CPU, nothing (every
    worker shares the card, each its own CUDA context)."""
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return {}
    ids = visible_cards()
    return {"CUDA_VISIBLE_DEVICES": ids[shard % len(ids)]}


def card_record(device: torch.device, master_cards=()) -> dict:
    """The card this process runs on, as the master that spawned it sees
    it: {"index", "name", "memory_peak_bytes"}. `index` is the card's
    position in `master_cards` (the master's `visible_cards()`), found by
    the id this process sees it under, or this process's own index where
    the master's list does not name it (a worker that shares the master's
    cards); the peak is `max_memory_allocated` since the last reset. On
    the CPU: index None, name "cpu", peak 0."""
    if device.type != "cuda":
        return {"index": None, "name": "cpu", "memory_peak_bytes": 0}
    here = device.index if device.index is not None else \
        torch.cuda.current_device()
    own = visible_cards()[here]
    cards = [str(c) for c in master_cards]
    return {"index": cards.index(own) if own in cards else here,
            "name": torch.cuda.get_device_name(here),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(here))}
