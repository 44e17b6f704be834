"""Host-side geometry of the MMSE-STSA kernel (`csrc/mmse.cu`): its blocks,
its chunks of frames and the copies that bring each chunk into the ring.

A block, one warp, carries one row b and a tile of up to BINS bins
k0 .. k0+nb; it walks the frames in chunks of Fc. Chunk c's power,
power[b, c*Fc : c*Fc+nf, k0 : k0+nb], is one contiguous run of
(nf-1)*K + nb floats. Addresses are counted in floats from the 16-byte
boundary at or below the tensor's first float, which sits at `base`
(0 .. 3); the tensor is [base, base + B*F*K).

A run [s, e) lands in ring slot c % STAGES, which mirrors memory from the
16-byte boundary at or below s: float i goes to slot offset i - (s & ~3).
One bulk copy moves the 16-byte blocks [bs, be) that cover the run and lie
inside the tensor; the floats of the run outside them (at most 3 at each
end, or all of a run too short for a whole block) go by 4-byte copies.
"""
from __future__ import annotations

from dataclasses import dataclass

STAGES = 3               # ring slots
CHUNK = 64               # frames of a chunk, at most
BINS = 32                # bins a block: one warp
RING_BYTES = 112 * 1024  # the ring, at most


def stage_floats(fc, K, nb):
    """Floats of a slot for runs of fc frames of nb bins: the run plus up
    to 3 lead-in floats, rounded up to 16 bytes."""
    return (3 + (fc - 1) * K + nb + 3) // 4 * 4


@dataclass(frozen=True)
class Layout:
    tiles: int          # blocks a row
    fc: int             # frames a chunk
    stage_floats: int   # floats of one ring slot


def layout(F, K):
    if F < 1 or K < 1:
        raise ValueError(f"MMSE layout: F={F}, K={K}")
    nb = min(BINS, K)
    fc = 1
    while (fc < min(CHUNK, F)
           and STAGES * 4 * stage_floats(fc + 1, K, nb) <= RING_BYTES):
        fc += 1
    return Layout(tiles=-(-K // BINS), fc=fc,
                  stage_floats=stage_floats(fc, K, nb))


def n_chunks(lay, F):
    return -(-F // lay.fc)


@dataclass(frozen=True)
class Copy:
    slot: int
    s: int              # the run [s, e)
    e: int
    bulk: tuple | None  # (bs, be): one bulk copy, 16-byte blocks
    singles: tuple      # floats copied 4 bytes at a time

    @property
    def origin(self):
        """The float that slot offset 0 mirrors."""
        return self.s & ~3

    @property
    def lead(self):
        return self.s - self.origin


def chunk_copy(lay, base, B, F, K, b, tile, c):
    """The copies of chunk c of block (row b, tile): mmse_run + mmse_issue."""
    k0 = tile * BINS
    nb = min(BINS, K - k0)
    t0 = c * lay.fc
    nf = min(lay.fc, F - t0)
    s = base + (b * F + t0) * K + k0
    e = s + (nf - 1) * K + nb
    end = base + B * F * K
    a = s & ~3
    bs = a if a >= base else (s + 3) & ~3
    be = (e + 3) & ~3 if (e + 3) & ~3 <= end else e & ~3
    if be <= bs:
        bs = be = e
    singles = tuple(range(s, bs)) + tuple(range(be, e))
    return Copy(slot=c % STAGES, s=s, e=e,
                bulk=(bs, be) if be > bs else None, singles=singles)


def issue_order(n):
    """Chunks in the order the block copies and consumes them: before the
    loop chunks 0 .. STAGES-2 are copied; step c copies chunk c+STAGES-1
    (into the slot chunk c-1 used), then waits for chunk c and consumes it.
    Yields ("copy", c) and ("consume", c)."""
    for c in range(min(STAGES - 1, n)):
        yield "copy", c
    for c in range(n):
        if c + STAGES - 1 < n:
            yield "copy", c + STAGES - 1
        yield "consume", c
