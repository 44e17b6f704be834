"""The port's no-early-exit path on the CPU: `FusedPlan` and
`Preprocessor.detect` against the JAX package (backend mode "ref"), fused
against the port's own two_phase, the all-removed batch under every plan,
the scheduler's compaction and load-balance functions against the JAX
ones, and two_phase at a 382-sample window (an even bin count).

The JAX side runs in two module-scoped fixtures, each on batch 1 of the
seed-25 stream (one 60 s stereo long chunk, 12 five-second chunks, 7
kept): the fused plan on the paper's graph and on that graph without its
removal point, and the detection phase; and two_phase at window 382."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core import scheduler as JSCHED  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.kernels import backend  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core import scheduler as SCHED  # noqa: E402
from repro_torch.core.graph import GraphValidationError  # noqa: E402
from repro_torch.core.plans import (  # noqa: E402
    PLANS, FusedPlan, Preprocessor)
from repro_torch.data.loader import audio_batch_maker  # noqa: E402

_MASKS = ("keep", "rain", "silence", "cicada15")
_NO_REMOVAL = tuple(s for s in cfg.stages if s != "removal_point")


def _batch(wid=1):
    return audio_batch_maker(seed=25, batch_long_chunks=1)(wid)[0]


def _stream(n_batches=3):
    make = audio_batch_maker(seed=25, batch_long_chunks=1)
    return [(w, (make(w)[0], None)) for w in range(n_batches)]


@pytest.fixture(scope="module")
def jax_runs():
    x = _batch()
    with backend.use("ref"):
        return {
            "fused": JPreprocessor(JCFG, plan="fused")(x),
            "no_removal": JPreprocessor(JCFG, plan="fused",
                                        stages=_NO_REMOVAL)(x),
            "detect": JPreprocessor(JCFG).detect(x),
        }


def _assert_masks_equal(got_det, want_det):
    for m in _MASKS:
        np.testing.assert_array_equal(getattr(got_det, m).numpy(),
                                      np.asarray(getattr(want_det, m)), m)


@pytest.mark.parametrize("stages", [None, _NO_REMOVAL],
                         ids=["paper_graph", "no_removal_point"])
def test_fused_plan_matches_reference(jax_runs, stages):
    want = jax_runs["fused" if stages is None else "no_removal"]
    pre = Preprocessor(cfg, plan="fused", stages=stages, device="cpu")
    assert isinstance(pre.plan, FusedPlan)
    got = pre(_batch())
    _assert_masks_equal(got.det, want.det)
    assert got.n_kept == want.n_kept == 7
    assert got.cleaned.shape == want.cleaned.shape
    np.testing.assert_allclose(got.cleaned, want.cleaned, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.det.wave5.numpy(),
                               np.asarray(want.det.wave5), rtol=2e-4,
                               atol=2e-4)
    assert got.src_bytes == want.src_bytes
    keep = got.det.keep.numpy()
    assert not got.det.wave5.numpy()[~keep].any()     # removed rows zero


def test_detect_matches_reference(jax_runs):
    want = jax_runs["detect"]
    got = Preprocessor(cfg, device="cpu").detect(_batch())
    _assert_masks_equal(got, want)
    np.testing.assert_allclose(got.wave5.numpy(), np.asarray(want.wave5),
                               rtol=2e-4, atol=2e-4)
    for k, v in want.stats.items():
        assert float(got.stats[k]) == pytest.approx(float(v), abs=1e-6), k


def test_two_phase_refuses_a_graph_without_a_removal_point():
    with pytest.raises(GraphValidationError, match="fused plan"):
        Preprocessor(cfg, plan="two_phase", stages=_NO_REMOVAL, device="cpu")


@pytest.fixture(scope="module")
def fused_stream():
    return list(Preprocessor(cfg, plan="fused", device="cpu")
                .run(_stream()))


@pytest.mark.parametrize("pad_multiple", [1, 2, 8])
def test_fused_matches_two_phase(fused_stream, pad_multiple):
    """The reference's own plan-equivalence tolerance (rtol 1e-4, atol
    1e-5): the same stages on the same rows, run over 12 rows or over the
    survivors."""
    two = list(Preprocessor(cfg, plan="two_phase", pad_multiple=pad_multiple,
                            device="cpu").run(_stream()))
    assert [r.wid for r in two] == [r.wid for r in fused_stream] == [0, 1, 2]
    assert sum(r.n_kept for r in two) == 13
    for f, t in zip(fused_stream, two):
        _assert_masks_equal(f.det, t.det)
        assert f.n_kept == t.n_kept
        assert f.cleaned.shape == t.cleaned.shape
        np.testing.assert_allclose(f.cleaned, t.cleaned, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_all_removed_batch_under_every_plan(plan, tmp_path):
    all_silent = dataclasses.replace(cfg, silence_snr_threshold=2.0)
    kw = {"store": tmp_path} if plan == "cached" else {}
    pre = Preprocessor(all_silent, plan=plan, pad_multiple=4, device="cpu",
                       **kw)
    results = list(pre.run([_batch(0)]))
    assert len(results) == 1
    res = results[0]
    assert res.n_kept == 0
    assert res.cleaned.shape == (0, cfg.final_split_samples)
    assert not res.det.keep.any()


# ------------------------------------------------------------ scheduler

def _masks():
    rng = np.random.RandomState(17)
    return [rng.rand(n) < p for n, p in
            [(12, 0.5), (10, 0.3), (13, 0.9), (7, 0.0), (9, 1.0)]]


@pytest.mark.parametrize("case", range(5))
def test_compact_matches_reference(case):
    keep = _masks()[case]
    chunks = np.arange(keep.size * 3, dtype=np.float32).reshape(-1, 3)
    got = SCHED.compact(torch.from_numpy(chunks), torch.from_numpy(keep))
    want = JSCHED.compact(jnp.asarray(chunks), jnp.asarray(keep))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("case", range(5))
def test_balance_matches_reference(case, n_shards):
    """N not divisible by n_shards among them (12, 10, 13, 7, 9 chunks over
    3 and 4 shards), and an all-removed mask."""
    keep = _masks()[case]
    np.testing.assert_array_equal(
        SCHED.shard_load(torch.from_numpy(keep), n_shards).numpy(),
        np.asarray(JSCHED.shard_load(jnp.asarray(keep), n_shards)))
    got = SCHED.balance_stats(torch.from_numpy(keep), n_shards)
    want = JSCHED.balance_stats(jnp.asarray(keep), n_shards)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["loads"].numpy(),
                                  np.asarray(want["loads"]))
    for k in ("imbalance", "imbalance_after_compact"):
        assert np.isfinite(float(got[k]))
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


@pytest.mark.parametrize("pad_multiple", [1, 4])
@pytest.mark.parametrize("case", range(5))
def test_survivor_batch_matches_reference(case, pad_multiple):
    keep = _masks()[case]
    chunks = np.random.RandomState(case).randn(keep.size, 5).astype(
        np.float32)
    got, n = SCHED.survivor_batch(chunks, keep, pad_multiple)
    want, n_want = JSCHED.survivor_batch(chunks, keep, pad_multiple)
    assert n == n_want
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------- a window of 4m + 2 samples

W382 = dict(stft_window=382, stft_hop=191)


@pytest.fixture(scope="module")
def jax_w382():
    with backend.use("ref"):
        return JPreprocessor(dataclasses.replace(JCFG, **W382))(_batch())


def test_two_phase_at_window_382_matches_reference(jax_w382):
    """K = 192 bins, an even count: the cicada rule's median bin is the
    mean of the two middle bins, as `jnp.median` takes it."""
    got = Preprocessor(dataclasses.replace(cfg, **W382), device="cpu")(
        _batch())
    _assert_masks_equal(got.det, jax_w382.det)
    assert got.n_kept == jax_w382.n_kept
    np.testing.assert_allclose(got.cleaned, jax_w382.cleaned, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("window", [256, 382])
def test_band_peakiness_median_matches_reference(window):
    from repro.core import indices as JI

    from repro_torch.core import indices as I
    K = window // 2 + 1
    power = np.random.RandomState(K).exponential(
        1.0, (3, 20, K)).astype(np.float32)
    got = I.band_peakiness(torch.from_numpy(power), *cfg.cicada_band_hz,
                           window=window)
    want = JI.band_peakiness(jnp.asarray(power), *cfg.cicada_band_hz,
                             window=window)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
