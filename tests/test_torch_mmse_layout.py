"""The MMSE kernel's copy schedule (`csrc/mmse.cu`), emulated on the CPU
through its host mirror (`mmse_stsa/tiling.py`): blocks, chunk runs,
aligned-down bulk copies, lead-in offsets, 4-byte head and tail copies and
ring slots. A CUDA kernel has no CPU mode, so this is how a fault in the
schedule shows before the kernel meets the card; the kernel itself is held
against its plain version on the card (tests/test_torch_cuda.py)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_mmse_step import ATOL, RTOL, emulate_gain

from repro_torch.kernels.mmse_stsa import ref as MR
from repro_torch.kernels.mmse_stsa import tiling as MT

CSRC = Path(MT.__file__).resolve().parents[1] / "csrc" / "mmse.cu"


def test_constants_match_the_kernel():
    src = CSRC.read_text()
    for name, value in [("STAGES", MT.STAGES), ("CHUNK", MT.CHUNK),
                        ("BINS", MT.BINS), ("RING_BYTES", MT.RING_BYTES)]:
        m = re.search(rf"constexpr int MMSE_{name} = ([0-9* ]+);", src)
        assert m, name
        assert eval(m.group(1)) == value, name     # digits and '*' only


def test_main_path_layout():
    """(R, 860, 129): one warp a block, 5 blocks per row, chunks of 64
    frames, 3 slots of 8,164 floats (32.7 KB): two blocks fit an SM."""
    lay = MT.layout(860, 129)
    assert (lay.tiles, lay.fc, lay.stage_floats) == (5, 64, 8164)
    assert 2 * MT.STAGES * 4 * lay.stage_floats <= 227 * 1024


def emulate_schedule(B, F, K, base):
    """Run every block's copies and reads in the kernel's order over a
    memory whose float i holds i. Returns (reads, values): how often the
    consumers read each (row, frame, bin), and what they read there."""
    lay = MT.layout(F, K)
    end = base + B * F * K
    reads = np.zeros(B * F * K, np.int64)
    values = np.full(B * F * K, -1, np.int64)
    for b in range(B):
        for tile in range(lay.tiles):
            k0 = tile * MT.BINS
            nb = min(MT.BINS, K - k0)
            ring = np.full((MT.STAGES, lay.stage_floats), -1, np.int64)
            holds = [None] * MT.STAGES       # chunk in a slot, not consumed
            copies = {}
            for what, c in MT.issue_order(MT.n_chunks(lay, F)):
                if what == "copy":
                    cp = MT.chunk_copy(lay, base, B, F, K, b, tile, c)
                    assert holds[cp.slot] is None, "slot overwritten unread"
                    holds[cp.slot] = c
                    copies[c] = cp
                    got = np.asarray(cp.singles, np.int64)
                    if cp.bulk:
                        bs, be = cp.bulk
                        # 16-byte source and destination, 16-byte size
                        assert bs % 4 == 0 and be % 4 == 0
                        assert (bs - cp.origin) % 4 == 0
                        assert base <= bs < be <= end
                        assert len(cp.singles) <= 6
                        got = np.concatenate([np.arange(bs, be), got])
                    # inside the tensor, each float once, the run covered,
                    # nothing beyond the run's 16-byte blocks
                    assert got.min() >= base and got.max() < end
                    assert got.min() >= cp.origin
                    assert got.max() < (cp.e + 3) & ~3
                    off = got - cp.origin
                    assert off.max() < lay.stage_floats
                    hit = np.bincount(off, minlength=lay.stage_floats)
                    assert hit.max() == 1
                    assert hit[cp.lead:cp.lead + cp.e - cp.s].all()
                    ring[cp.slot] = -1                      # stale: poison
                    ring[cp.slot, off] = got
                else:
                    cp = copies.pop(c)
                    assert holds[cp.slot] == c
                    holds[cp.slot] = None
                    nf = min(lay.fc, F - c * lay.fc)
                    f = np.arange(nf)[:, None]
                    kk = np.arange(nb)[None, :]
                    got = ring[cp.slot, cp.lead + f * K + kk]
                    want = cp.s + f * K + kk
                    np.testing.assert_array_equal(got, want)
                    np.add.at(reads, (want - base).ravel(), 1)
                    values[(want - base).ravel()] = got.ravel()
            assert not copies and holds == [None] * MT.STAGES
    return reads, values


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("B", [1, 19, 35])
@pytest.mark.parametrize("K", [1, 128, 129, 256])
@pytest.mark.parametrize("F", [1, 3, 4, 860, 861])
def test_every_float_read_once_from_where_it_landed(F, K, B, base):
    reads, values = emulate_schedule(B, F, K, base)
    assert (reads == 1).all()
    np.testing.assert_array_equal(values, base + np.arange(B * F * K))


@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_gather_through_the_schedule_matches_the_plain_version(base):
    """Power at an odd float offset in a buffer, gathered as the kernel's
    consumers read it, then through the kernel's recurrence step
    (test_torch_mmse_step.emulate_gain): within half the kernel's
    tolerance of the plain version on the tensor itself."""
    B, F, K = 3, 70, 129
    rng = np.random.RandomState(9 + base)
    p = rng.exponential(1.0, (B, F, K)).astype(np.float32)
    p[:, F // 4:F // 2, :K // 3] += 40.0
    buf = np.full(base + B * F * K + 3, np.nan, np.float32)
    buf[base:base + B * F * K] = p.ravel()
    lay = MT.layout(F, K)
    gathered = np.full((B, F, K), np.nan, np.float32)
    for b in range(B):
        for tile in range(lay.tiles):
            k0 = tile * MT.BINS
            nb = min(MT.BINS, K - k0)
            for c in range(MT.n_chunks(lay, F)):
                cp = MT.chunk_copy(lay, base, B, F, K, b, tile, c)
                slot = np.full(lay.stage_floats, np.nan, np.float32)
                idx = list(range(*cp.bulk)) if cp.bulk else []
                idx += cp.singles
                slot[np.asarray(idx) - cp.origin] = buf[idx]
                nf = min(lay.fc, F - c * lay.fc)
                t0 = c * lay.fc
                gathered[b, t0:t0 + nf, k0:k0 + nb] = slot[
                    cp.lead + np.arange(nf)[:, None] * K
                    + np.arange(nb)[None, :]]
    np.testing.assert_array_equal(gathered, p)
    power = torch.from_numpy(p)
    noise = MR.estimate_noise_psd(power, 16)
    np.testing.assert_allclose(
        emulate_gain(gathered, noise.numpy()),
        MR.mmse_stsa_gain_ref(power, noise).numpy(), rtol=RTOL, atol=ATOL)
