"""Survivor bookkeeping between the two phases: the host reads only the
keep mask and answers with a padded index vector; the survivor tail
gathers the rows on the device. Also the paper's load-balance metrics
(files per slave, Figs 14-16): `shard_load` and `balance_stats`."""
from __future__ import annotations

import numpy as np
import torch


def compact(chunks, keep):
    """Pack surviving chunks to the front, in their order (a stable sort
    on ~keep). chunks: (N, ...); keep: (N,) bool. Returns (packed chunks,
    packed keep, survivor count)."""
    order = torch.argsort((~keep).to(torch.uint8), stable=True)
    return chunks[order], keep[order], keep.sum()


def shard_load(keep, n_shards):
    """Surviving chunks per shard when N chunks are cut into `n_shards`
    equal slices; an N that `n_shards` does not divide is padded with
    removed chunks, so the last shard holds fewer real ones."""
    pad = (-keep.shape[0]) % n_shards
    if pad:
        keep = torch.cat([keep, torch.zeros(pad, dtype=keep.dtype,
                                            device=keep.device)])
    return keep.reshape(n_shards, -1).sum(dim=1)


def balance_stats(keep, n_shards):
    """Load balance over `n_shards`: 'imbalance' (max / mean survivors per
    shard) where detection left them, and 'imbalance_after_compact' when
    the survivors are packed and re-sliced ceil(n / n_shards) a shard."""
    loads = shard_load(keep, n_shards)
    mean = loads.float().mean()
    imb = loads.max() / torch.clamp_min(mean, 1e-9)
    n = keep.sum()
    per_shard_after = torch.ceil(n / n_shards)
    imb_after = per_shard_after / torch.clamp_min(n / n_shards, 1e-9)
    return {"loads": loads, "imbalance": imb,
            "imbalance_after_compact": imb_after}


def quantize_survivors(n, cap, pad_multiple=1, bucket="pow2"):
    """Padded tail-batch size for `n` survivors out of a `cap`-row batch.

    'linear' rounds up to the next multiple of pad_multiple; 'pow2' rounds
    up to the next pad_multiple-aligned power of two (clipped at the padded
    cap), so a B-row batch meets O(log B) tail shapes."""
    n = int(n)
    m = max(1, int(pad_multiple))
    lin = -(-n // m) * m
    if bucket == "linear":
        return lin
    if bucket != "pow2":
        raise ValueError(f"unknown bucket mode {bucket!r} "
                         "(expected 'pow2' or 'linear')")
    hi = max(lin, -(-int(cap) // m) * m)
    size = m
    while size < n:
        size *= 2
    return min(size, hi)


def survivor_indices(keep_np, pad_multiple=1, bucket="pow2"):
    """The padded int32 gather-index vector for a keep mask. Pad slots hold
    the out-of-range index `len(keep_np)`, which the gather turns into
    all-zero rows, never a repeat of real audio. Returns (idx, n_real);
    idx is None when nothing survived."""
    idx = np.flatnonzero(keep_np)
    n = len(idx)
    if n == 0:
        return None, 0
    size = quantize_survivors(n, keep_np.size, pad_multiple, bucket)
    out = np.full(size, keep_np.size, np.int32)
    out[:n] = idx
    return out, n


def survivor_batch(chunks_np, keep_np, pad_multiple):
    """Host-side re-batching of the survivors, padded with zero rows to a
    multiple of `pad_multiple`. Returns (batch, n_real); (None, 0) when
    nothing survived."""
    idx = np.nonzero(keep_np)[0]
    if len(idx) == 0:
        return None, 0
    return pad_batch(chunks_np[idx], pad_multiple)


def pad_batch(rows_np, pad_multiple):
    """Pad an already-packed survivor batch up to a multiple of
    pad_multiple with zero rows. Returns (batch, n_real)."""
    n = rows_np.shape[0]
    if n == 0:
        return None, 0
    n_pad = -(-n // pad_multiple) * pad_multiple
    if n_pad == n:
        return rows_np, n
    pad = np.zeros((n_pad - n,) + rows_np.shape[1:], rows_np.dtype)
    return np.concatenate([rows_np, pad]), n
