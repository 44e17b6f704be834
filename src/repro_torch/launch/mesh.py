"""Mesh construction (the port's copy of the reference's `launch/mesh.py`)
over torch `DeviceMesh`es.

Functions, not module-level constants: importing this module touches no
process group. A mesh spans the ranks of the default process group, one
device a rank:

  * `make_local_mesh(model_parallel)` — ("data", "model") over every rank
    of the group, the model axis halved until it divides the world size.
    With no group initialised it starts a one-rank group itself (gloo on
    the CPU, nccl on the card) over an in-memory `HashStore`: no
    environment variables, no network.
  * `make_production_mesh(multi_pod)` — the reference's (16, 16)
    ("data", "model") or (2, 16, 16) ("pod", "data", "model") mesh. It
    needs a group of 256 or 512 ranks, which in a test is a fake one
    (`torch.testing._internal.distributed.fake_pg.FakeStore`, backend
    "fake").
  * `mesh_from_plan(plan)` — the mesh of an `ft.failure.MeshPlan` (the
    elastic restart path).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

_BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def _device_type(device):
    """The mesh's device type: the group's backend decides when a group
    exists and no device is named; else `resolve_device(device)`."""
    if device is None and dist.is_initialized():
        backend = dist.get_backend()
        if backend in ("gloo", "fake"):
            return "cpu"
        return "cuda"
    return resolve_device(device).type


def _ensure_group(device_type):
    """Start a one-rank group when none exists: the process alone is the
    whole world."""
    if dist.is_initialized():
        return
    # no device bound: nccl sets its communicator up at the first
    # collective, so a run that keeps plain tensors never starts one
    dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(),
                            rank=0, world_size=1)


def _make_mesh(shape, axes, device_type):
    """A mesh of `shape` named `axes` over ranks 0 .. prod(shape) - 1 of
    the default group."""
    n = 1
    for d in shape:
        n *= d
    ranks = torch.arange(n, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """`device_type` None: the group's (a fake group's is "cpu"); the
    dry-run asks for "meta", the device of its tensors, so that DTensor
    redistributes as on a card mesh (a CPU mesh gathers where a card mesh
    exchanges all to all)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type or _device_type(None))


def make_local_mesh(model_parallel=1, device=None):
    """("data", "model") over every rank of the default group (a new
    one-rank group when there is none); `device` None: the group's device
    type, or the card when the group is started here."""
    device_type = _device_type(device)
    _ensure_group(device_type)
    n = dist.get_world_size()
    mp = max(1, int(model_parallel))
    while n % mp:
        mp //= 2
    return _make_mesh((n // mp, mp), ("data", "model"), device_type)


def mesh_from_plan(plan):
    """The mesh of an ft.failure.MeshPlan (elastic restart path), on the
    group's device type."""
    return _make_mesh(plan.shape, plan.axes, _device_type(None))
