"""The FIR kernel's index maps (`csrc/fir.cu`), emulated on the CPU: the
same host tap table (`fir_hpf/tiling.py`), persistent walk over (tile,
phase, tap block) items, zero-filled stage copies, skewed shared-memory
slots, register windows, tap chunks and masked output stores, in f32,
against `fir_ref`. A CUDA kernel has no CPU mode, so this is how an index
fault shows before the kernel meets the card; the kernel itself is held
against its plain version on the card (tests/test_torch_cuda.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.fir_hpf import ref as FR
from repro_torch.kernels.fir_hpf import tiling as FT

CSRC = Path(FT.__file__).resolve().parents[1] / "csrc" / "fir.cu"
BIG_T = 600                      # P*A > PARAM_TAPS: taps in shared memory


def _chunks(ab):
    """(a0, C) of the unrolled tap chunks over one tap block of ab taps."""
    out, a0 = [], 0
    while a0 + FT.CHUNK <= ab:
        out.append((a0, FT.CHUNK))
        a0 += FT.CHUNK
    while a0 < ab:
        out.append((a0, 4))
        a0 += 4
    return out


def emulate_fir(x, h, stride, blocks=3):
    """x (B, S) f32, h (T,) -> (B, S // stride), computed as the kernel
    computes it with a grid of `blocks` persistent blocks."""
    B, S = x.shape
    lay = FT.layout(h.shape[0], stride)
    G = torch.from_numpy(FT.phase_taps(h, stride)).reshape(-1)
    out_len = S // stride
    y = torch.full((B, out_len), float("nan"))
    if out_len == 0:
        return y
    tpr = -(-out_len // FT.TILE)
    n_tiles = B * tpr
    Q = lay.stage_samples
    q = torch.arange(Q)
    i0 = FT.R * torch.arange(FT.THREADS)[:, None]         # (threads, 1)
    for blk in range(min(blocks, n_tiles)):
        acc = torch.zeros(FT.THREADS, FT.R)
        t, p, b = blk, 0, 0                      # the block's first item
        while t < n_tiles:
            row, n0 = t // tpr, (t % tpr) * FT.TILE
            # the stage: slots [q_lo, q_hi) copied, the rest zero-filled
            g0 = (n0 + b * FT.TAP_BLOCK) * stride - lay.L + p
            q_lo = 0 if g0 >= 0 else (stride - 1 - g0) // stride
            rem = S - g0
            q_hi = (Q if rem >= Q * stride else 0 if rem <= 0
                    else (rem + stride - 1) // stride)
            gi = g0 + q * stride
            ok = (q >= q_lo) & (q < q_hi)
            assert torch.equal(ok, (gi >= 0) & (gi < S))
            stage = torch.full((FT.skewed_len(Q),), float("nan"))
            stage[FT.skew(q)] = torch.where(ok, x[row, gi.clamp(0, S - 1)],
                                            torch.zeros(()))
            ab = min(FT.TAP_BLOCK, lay.A - b * FT.TAP_BLOCK)
            taps = G[p * lay.A + b * FT.TAP_BLOCK:][:ab]
            for a0, C in _chunks(ab):
                W = FT.round_up(FT.R + C - 1, 4)
                u = torch.arange(W)
                # float4 loads: word e of the group at i0 + a0 + 4v
                start = i0 + a0 + 4 * (u // 4)
                w = stage[FT.skew(start) + u % 4]            # (threads, W)
                for j in range(C):
                    acc = acc + taps[a0 + j] * w[:, j:j + FT.R]
            if p == lay.P - 1 and b == lay.NB - 1:           # tile summed
                outs = stage                         # the stage just summed
                outs[FT.skew(i0 + torch.arange(FT.R))] = acc
                n_out = min(FT.TILE, out_len - n0)
                y[row, n0:n0 + n_out] = outs[FT.skew(torch.arange(n_out))]
                acc = torch.zeros(FT.THREADS, FT.R)
            b += 1                                   # FirItem::advance
            if b == lay.NB:
                b, p = 0, p + 1
                if p == lay.P:
                    p, t = 0, t + blocks
    return y


def _case_sizes():
    cases = []
    for stride in (1, 2, 3):
        for T in (1, 33, 65, 129, BIG_T):
            # S < T (S = 1 where T = 1), and an odd S that is not a multiple
            # of the tile's span
            for S in (max(1, T // 2), FT.TILE * stride + 75):
                cases.append((stride, T, S))
    return cases


@pytest.mark.parametrize("stride,T,S", _case_sizes())
def test_emulated_kernel_matches_fir_ref(stride, T, S):
    rng = np.random.RandomState(stride * 1000 + T + S % 89)
    x = torch.from_numpy(rng.randn(2, S).astype(np.float32))
    h = rng.randn(T).astype(np.float32) / np.sqrt(T)
    got = emulate_fir(x, h, stride)
    want = FR.fir_ref(x, h, stride)
    assert got.shape == want.shape == (2, S // stride)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,stride,taps_in_params", [
    (129, 2, True), (129, 1, True), (1, 3, True), (BIG_T, 1, False),
    (BIG_T, 2, False), (257, 2, True)])
def test_layout_of_the_tap_table(T, stride, taps_in_params):
    """Every tap lands once, in its phase row; the rest is zero padding."""
    h = np.arange(1, T + 1, dtype=np.float32)
    lay = FT.layout(T, stride)
    G = FT.phase_taps(h, stride)
    assert G.shape == (lay.P, lay.A) and lay.A % 4 == 0
    assert lay.taps_in_params == taps_in_params
    assert sorted(G[G != 0].tolist()) == h.tolist()
    p, a = np.nonzero(G)
    np.testing.assert_array_equal(G[p, a], h[lay.L - (a * stride + p)])


@pytest.mark.parametrize("offset", range(0, 32, 4))
def test_window_loads_are_bank_conflict_free(offset):
    """A float4 load of a quarter-warp (8 lanes) is one wavefront when its
    8 groups of 4 words fall on 8 distinct 4-bank groups. The window loads
    read sample i0 + offset (i0 = R * lane) and the tile's stores write
    i0 + 4v: every quarter-warp hits distinct bank groups. Sixteen samples
    more move every lane by the same 20 words, so offsets 0 .. 28 cover
    all."""
    for quarter in range(FT.THREADS // 8):
        lanes = np.arange(8 * quarter, 8 * quarter + 8)
        banks = (FT.skew(FT.R * lanes + offset) % 32) // 4
        assert len(set(banks.tolist())) == 8


def test_kernel_source_uses_the_same_constants():
    src = CSRC.read_text()
    for name, value in [("FIR_THREADS", FT.THREADS), ("FIR_R", FT.R),
                        ("FIR_CHUNK", FT.CHUNK),
                        ("FIR_TAP_BLOCK", FT.TAP_BLOCK),
                        ("FIR_PARAM_TAPS", FT.PARAM_TAPS)]:
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
