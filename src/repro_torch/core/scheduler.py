"""Survivor bookkeeping between the two phases: the host reads only the
keep mask and answers with a padded index vector; the survivor tail
gathers the rows on the device. Also the paper's load-balance metrics
(files per slave, Figs 14-16): `shard_load` and `balance_stats`; and the
`Rebalancer` that re-slices the survivors of a multi-shard round across
the shards between detection and the tail (`ShardedPlan`).
"""
from __future__ import annotations

from dataclasses import dataclass

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


def pad_batch(rows, pad_multiple):
    """Pad an already-packed survivor batch up to a multiple of
    pad_multiple with zero rows. `rows` is a numpy array or a tensor; a
    tensor is padded where it lies, with no readback. Returns (batch,
    n_real)."""
    n = rows.shape[0]
    if n == 0:
        return None, 0
    n_pad = -(-n // pad_multiple) * pad_multiple
    if n_pad == n:
        return rows, n
    if torch.is_tensor(rows):
        return torch.cat([rows, rows.new_zeros((n_pad - n,)
                                               + tuple(rows.shape[1:]))]), n
    pad = np.zeros((n_pad - n,) + rows.shape[1:], rows.dtype)
    return np.concatenate([rows, pad]), n


# ------------------------------------------------------------- rebalancing

@dataclass
class ShardAssignment:
    """One detection -> tail handoff: how the packed survivor order (the
    source shards' survivors concatenated in slot order) is re-sliced
    across the destination shards."""
    counts_before: np.ndarray   # survivors detected per source shard
    counts_after: np.ndarray    # survivors assigned per destination shard
    bounds: np.ndarray          # (k+1,) prefix offsets into the packed order
    moved: int                  # survivors whose shard changed

    @staticmethod
    def _ratio(counts):
        """max/min shard load; an empty or fully starved shard counts as
        load 1, so that the ratio stays finite."""
        if counts.size == 0 or counts.max() == 0:
            return 1.0
        return float(counts.max()) / float(max(counts.min(), 1))

    def stats(self):
        """Loads and max/min load ratios before and after the re-shard
        (the paper's Figs 14-16: 'each slave processes almost the same
        number of files'), and the survivors moved."""
        return {
            "loads_before": self.counts_before,
            "loads_after": self.counts_after,
            "max_min_before": self._ratio(self.counts_before),
            "max_min_after": self._ratio(self.counts_after),
            "moved": self.moved,
        }


class Rebalancer:
    """The survivor re-shard between detection and the tail.

    Each source shard reports its keep masks (host arrays: the only
    readback of a round), survivors are packed in (shard, item) order, and
    the packed run is cut into near-even contiguous spans, floor(n/k) or
    floor(n/k)+1 per destination shard: the residual imbalance is the +-1
    of integer division, never the noise skew of the input."""

    def __init__(self, n_shards, pad_multiple=1):
        self.n_shards = int(n_shards)
        self.pad_multiple = max(1, int(pad_multiple))

    def assign(self, keeps, out_shards=None) -> ShardAssignment:
        """keeps: one 1-D bool mask per source shard (its detected items'
        masks, concatenated). out_shards: destination shard count
        (defaults to n_shards; fewer when shards died mid-round)."""
        k = self.n_shards if out_shards is None else int(out_shards)
        if k < 1:
            raise ValueError("rebalance needs at least one live shard")
        counts_before = np.array([int(np.sum(m)) for m in keeps], np.int64)
        n = int(counts_before.sum())
        counts_after = n // k + (np.arange(k) < n % k).astype(np.int64)
        bounds = np.concatenate([[0], np.cumsum(counts_after)])
        src = np.repeat(np.arange(len(keeps)), counts_before)
        dst = np.repeat(np.arange(k), counts_after)
        moved = int(np.sum(src != dst))
        return ShardAssignment(counts_before, counts_after, bounds, moved)

    def split(self, survivors, asg: ShardAssignment):
        """Cut the packed (n, S) survivors (a numpy array, or a tensor on
        any device, sliced and padded where it lies) per the assignment
        into padded tail batches. Yields (shard_slot, batch, n_real) for
        the non-empty slots only."""
        for j in range(len(asg.counts_after)):
            lo, hi = int(asg.bounds[j]), int(asg.bounds[j + 1])
            if hi == lo:
                continue
            batch, n_real = pad_batch(survivors[lo:hi], self.pad_multiple)
            yield j, batch, n_real
