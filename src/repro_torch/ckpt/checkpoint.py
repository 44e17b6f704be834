"""Atomic, optionally asynchronous checkpoints of torch tensors and numpy
arrays, in the reference's on-disk layout (`repro/ckpt/checkpoint.py`), so
either framework restores what the other saved:

    <dir>/step_<N>/
        manifest.json   {"meta": ..., "step": N, "leaves": {leaf_path:
                         {file, shape, dtype, crc32}}}
        <leaf>.npy      raw array bytes (bfloat16 stored as uint16)
    <dir>/step_<N>.tmp-*   while writing (renamed into place when done)

A tree is nested dicts, lists and tuples whose leaves are tensors or
arrays (None is an empty subtree). A leaf's path joins its dict keys and
sequence indices with "/" (dict keys in sorted order, as JAX flattens
them), and its file name joins them with "__": `{"a": [x]}` saves `a/0`
as `a__0.npy`.

A DTensor leaf is saved whole: `save` gathers it (`full_tensor()`, a
collective every rank joins) and rank 0 alone writes. `restore(...,
shardings=)` places each leaf by its DTensor placements (a `Placements`
from `ShardingRules.sharding`, which carries its mesh), which is how an
elastic restart re-shards a checkpoint onto another mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import is_dtensor, tree_map

_SEP = "/"


def _leaves(tree, path=()):
    """(leaf path, leaf) pairs of `tree`, in the order JAX flattens it."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield _SEP.join(path), tree


def _rebuild(like, load, path=()):
    """`like` with each leaf replaced by `load(leaf path, leaf)`."""
    if isinstance(like, dict):
        return {k: _rebuild(v, load, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, load, path + (str(i),))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return load(_SEP.join(path), like)


def _to_host(leaf) -> np.ndarray:
    """A copy of the leaf in host memory: a later in-place update of the
    caller's tensor cannot reach an asynchronous save. A DTensor is
    gathered whole first."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf, copy=True)
    if str(arr.dtype) == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory, step, tree, meta=None, async_save=False):
    """Checkpoint `tree` at `directory/step_<step>`. Returns a handle with
    .wait() (a no-op for a synchronous save).

    In a process group of more than one rank every rank calls it (the
    DTensor leaves are gathered on all of them), rank 0 alone writes, and
    the ranks meet at a barrier once the files are in place: at the end of
    a synchronous save, in `wait()` of an asynchronous one."""
    directory = os.fspath(directory)
    final = os.path.join(directory, f"step_{step}")
    # copy to the host before going asynchronous
    host = [(name, *_to_host(v)) for name, v in _leaves(tree)]
    group = dist.is_initialized() and dist.get_world_size() > 1
    if group and dist.get_rank() != 0:
        if not async_save:
            dist.barrier()
        return _Handle(None, barrier=group)
    os.makedirs(directory, exist_ok=True)

    def _write():
        tmp = tempfile.mkdtemp(prefix=f"step_{step}.tmp-", dir=directory)
        manifest = {"meta": meta or {}, "step": step, "leaves": {}}
        for name, stored, logical in host:
            fname = name.replace(_SEP, "__") + ".npy"
            fpath = os.path.join(tmp, fname)
            np.save(fpath, stored, allow_pickle=False)
            with open(fpath, "rb") as f:
                crc = zlib.crc32(f.read())
            manifest["leaves"][name] = {
                "file": fname, "shape": list(stored.shape),
                "dtype": logical, "crc32": crc,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return _Handle(t, barrier=group)
    _write()
    if group:
        dist.barrier()
    return _Handle(None)


class _Handle:
    def __init__(self, thread, barrier=False):
        self._thread = thread
        self._barrier = barrier

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        if self._barrier:
            self._barrier = False
            dist.barrier()


def _steps(directory):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_", 1)[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and ".tmp" not in d)


def latest_step(directory):
    steps = _steps(os.fspath(directory))
    return steps[-1] if steps else None


def restore(directory, step, like=None, shardings=None, verify_crc=True):
    """Restore a checkpoint: (tree, meta).

    like: a tree giving the structure; each leaf comes back as a tensor on
    the device of its `like` leaf (a numpy `like` leaf gives a numpy
    array), in the dtype it was saved with. like=None returns a flat
    {leaf_path: CPU tensor} dict.
    shardings: None, or a tree matching `like` whose entries are
    `Placements` (None or a 0-d leaf: a plain tensor): each leaf becomes a
    DTensor with them, on their mesh, each rank keeping its block. This is
    how a restore re-shards onto another mesh (elastic restart)."""
    path = os.path.join(os.fspath(directory), f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load_leaf(name):
        ent = manifest["leaves"][name]
        fpath = os.path.join(path, ent["file"])
        if verify_crc:
            with open(fpath, "rb") as f:
                crc = zlib.crc32(f.read())
            if crc != ent["crc32"]:
                raise IOError(f"checkpoint corruption in {name}: crc mismatch")
        arr = np.load(fpath, allow_pickle=False).reshape(ent["shape"])
        return _to_tensor(arr, ent["dtype"])

    if like is None:
        return ({n: load_leaf(n) for n in manifest["leaves"]},
                manifest["meta"])
    missing = [n for n, _ in _leaves(like) if n not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")

    def place(name, leaf):
        t = load_leaf(name)
        if torch.is_tensor(leaf):
            return t.to(leaf.device)
        return t.numpy()

    tree = _rebuild(like, place)
    if shardings is not None:
        tree = tree_map(lambda t, sh: t if sh is None or t.ndim == 0
                        else sh.place(t), tree, shardings)
    return tree, manifest["meta"]


def prune_old(directory, keep=3):
    directory = os.fspath(directory)
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
