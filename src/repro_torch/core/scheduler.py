"""Survivor bookkeeping between the two phases: the host reads only the
keep mask and answers with a padded index vector; the survivor tail
gathers the rows on the device."""
from __future__ import annotations

import numpy as np


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
