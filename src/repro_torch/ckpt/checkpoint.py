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
as `a__0.npy`. The reference's restore-time resharding (`shardings=`)
comes with the port's device-mesh slice.
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
    caller's tensor cannot reach an asynchronous save."""
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
    .wait() (a no-op for a synchronous save)."""
    directory = os.fspath(directory)
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(directory, exist_ok=True)
    # copy to the host before going asynchronous
    host = [(name, *_to_host(v)) for name, v in _leaves(tree)]

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
        return _Handle(t)
    _write()
    return _Handle(None)


class _Handle:
    def __init__(self, thread):
        self._thread = thread

    def wait(self):
        if self._thread is not None:
            self._thread.join()


def _steps(directory):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_", 1)[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and ".tmp" not in d)


def latest_step(directory):
    steps = _steps(os.fspath(directory))
    return steps[-1] if steps else None


def restore(directory, step, like=None, verify_crc=True):
    """Restore a checkpoint: (tree, meta).

    like: a tree giving the structure; each leaf comes back as a tensor on
    the device of its `like` leaf (a numpy `like` leaf gives a numpy
    array), in the dtype it was saved with. like=None returns a flat
    {leaf_path: CPU tensor} dict."""
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

    return _rebuild(like, place), manifest["meta"]


def prune_old(directory, keep=3):
    directory = os.fspath(directory)
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
