"""Host-side geometry of the FIR kernel (`csrc/fir.cu`): the polyphase tap
table it reads and the constants its index maps are built from.

The kernel computes y[b, n] = sum_k h[k] x[b, n*s - k] in polyphase form.
A tile of TILE outputs n0 .. n0+TILE-1 reads the span that starts L samples
before x[n0*s] (L = T-1 rounded up to a multiple of 4); with the taps
reversed and zero padded, h''[m] = h[L - m], and m = a*s + p split by phase,

    y[n0 + i] = sum_p sum_a G[p, a] * x[(n0 + i + a)*s + p - L]

so every phase p is a stride-1 correlation of its own samples with its row
G[p] of the table. Only the P = min(s, L+1) phases with a nonzero tap are
read. Each row has A taps, a multiple of 4, and is walked in blocks of at
most TAP_BLOCK taps; one (tile, phase, tap block) is one stage of the
kernel's shared-memory ring.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

THREADS = 256          # threads of a block
R = 16                 # consecutive outputs per thread (register tile)
TILE = THREADS * R     # outputs per tile
CHUNK = 16             # taps per unrolled chunk (then chunks of 4)
TAP_BLOCK = 256        # taps of one phase per ring stage
PARAM_TAPS = 512       # table entries that fit the launch's parameters


def round_up(n, m):
    return -(-n // m) * m


def skew(q):
    """Shared-memory slot of sample q of a stage: 4 pad words after every
    16. Group g of 4 words then sits at 5g/4 groups, so the float4 loads of
    a quarter-warp (8 lanes, R = 16 words apart, at any common offset)
    fall on 8 distinct groups of 4 banks: one wavefront."""
    return q + 4 * (q >> 4)


def skewed_len(n):
    return n + 4 * ((n + 15) // 16)


@dataclass(frozen=True)
class Layout:
    L: int      # halo: the span starts L samples before x[n0*s]
    P: int      # phases with a nonzero tap
    A: int      # taps per phase, zero padded to a multiple of 4
    NB: int     # tap blocks per phase

    @property
    def stage_samples(self):
        """Samples of one phase that a stage holds: the tile's plus the
        reach of one tap block."""
        return TILE + min(self.A, TAP_BLOCK)

    @property
    def taps_in_params(self):
        return self.P * self.A <= PARAM_TAPS


def layout(T, stride):
    if T < 1 or stride < 1:
        raise ValueError(f"FIR layout: T={T}, stride={stride}")
    L = round_up(T - 1, 4)
    A = round_up(-(-(L + 1) // stride), 4)
    return Layout(L=L, P=min(stride, L + 1), A=A, NB=-(-A // TAP_BLOCK))


def phase_taps(h, stride):
    """(P, A) f32 table: G[p, a] = h[L - (a*s + p)] where that tap exists,
    else 0."""
    h = np.asarray(h, np.float32)
    T = h.shape[0]
    lay = layout(T, stride)
    G = np.zeros((lay.P, lay.A), np.float32)
    m = np.arange(lay.L + 1)
    k = lay.L - m
    live = k < T
    G[m[live] % stride, m[live] // stride] = h[k[live]]
    return G
