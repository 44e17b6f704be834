"""The port's asynchronous plans (`async`, `streaming`) on the CPU: against
the JAX package's AsyncPlan / StreamingPlan (backend mode "ref"), bitwise
against the port's own two_phase at keep rates 0%, ~37% and 100%,
input-order exactly-once emission at any depth, the per-batch timing
records, zero pad rows, and the facade's `source_channels` and tensor
batches.

The JAX side runs three times in this file, each a module-scoped fixture:
AsyncPlan(depth=2) on the seed-25 stream, StreamingPlan on the same stream
widened to four channels (so that one run holds both the streaming plan and
a 4-channel source), and two_phase on its mono mix with a stage list
without `to_mono`."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.kernels import backend  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core import scheduler as SCHED  # noqa: E402
from repro_torch.core.plans import (  # noqa: E402
    PLANS, TIMINGS_CAP, AsyncPlan, CachedPlan, FusedPlan, Preprocessor,
    ShardedPlan, StreamingPlan, TwoPhasePlan)
from repro_torch.data.loader import audio_batch_maker  # noqa: E402

_MASKS = ("keep", "rain", "silence", "cicada15")
_MONO_STAGES = tuple(s for s in cfg.stages if s != "to_mono")
S5 = cfg.final_split_samples


def _stream(seed, n_batches, widen=None):
    """[(wid, (chunks, None))] of `batch_long_chunks=1` batches; `widen`
    maps the (B, 2, S) stereo chunks to another channel layout."""
    make = audio_batch_maker(seed=seed, batch_long_chunks=1)
    out = []
    for w in range(n_batches):
        chunks = make(w)[0]
        out.append((w, (chunks if widen is None else widen(chunks), None)))
    return out


def _four(chunks):
    """(B, 2, S) -> (B, 4, S): L, R, R, L."""
    return np.ascontiguousarray(chunks[:, [0, 1, 1, 0]])


def _mono(chunks):
    return np.ascontiguousarray(chunks.mean(axis=1, dtype=np.float32))


@pytest.fixture(scope="module")
def jax_async():
    with backend.use("ref"):
        return list(JPreprocessor(JCFG, plan="async", depth=2).run(
            _stream(25, 3)))


@pytest.fixture(scope="module")
def jax_streaming4():
    with backend.use("ref"):
        return list(JPreprocessor(JCFG, plan="streaming", source_channels=4)
                    .run(_stream(25, 3, _four)))


@pytest.fixture(scope="module")
def jax_mono():
    with backend.use("ref"):
        return list(JPreprocessor(JCFG, plan="two_phase",
                                  stages=_MONO_STAGES, source_channels=1)
                    .run(_stream(25, 3, _mono)))


def _assert_matches_reference(got, want, same_keys=True):
    assert [r.wid for r in got] == [r.wid for r in want] == [0, 1, 2]
    assert sum(r.n_kept for r in got) == sum(r.n_kept for r in want) == 13
    for r, w in zip(got, want):
        for m in _MASKS:
            np.testing.assert_array_equal(getattr(r.det, m).numpy(),
                                          np.asarray(getattr(w.det, m)),
                                          err_msg=m)
        assert r.cleaned.shape == w.cleaned.shape
        np.testing.assert_allclose(r.cleaned, w.cleaned, rtol=2e-4,
                                   atol=2e-4)
        if same_keys:
            assert set(r.timings) == set(w.timings)


# ------------------------------------------------------- against the JAX

@pytest.mark.parametrize("plan", ["async", "streaming"])
def test_async_plans_match_reference(jax_async, jax_streaming4, plan):
    """Both plans keep the same 13 of 36 chunks of the seed-25 stream as
    the JAX AsyncPlan, with equal masks, cleaned audio within 2e-4 and the
    reference's timing keys (those of its own plan)."""
    pre = Preprocessor(cfg, plan=plan, device="cpu")
    got = list(pre.run(_stream(25, 3)))
    _assert_matches_reference(got, jax_async)
    keys = {"async": jax_async, "streaming": jax_streaming4}[plan]
    assert all(set(r.timings) == set(keys[0].timings) for r in got)


def test_four_channel_source_matches_reference(jax_streaming4):
    """`source_channels=4` reaches the graph: the port's streaming plan on
    the 4-channel stream against the reference's."""
    pre = Preprocessor(cfg, plan="streaming", source_channels=4,
                       device="cpu")
    assert pre.graph.source_geom.channels == 4
    _assert_matches_reference(list(pre.run(_stream(25, 3, _four))),
                              jax_streaming4)


@pytest.mark.parametrize("plan", ["two_phase", "async"])
def test_mono_source_matches_reference(jax_mono, plan):
    """A mono source with a stage list without `to_mono` (the reference
    ran two_phase, whose timings lack the window's two keys)."""
    pre = Preprocessor(cfg, plan=plan, stages=_MONO_STAGES,
                       source_channels=1, device="cpu")
    _assert_matches_reference(list(pre.run(_stream(25, 3, _mono))),
                              jax_mono, same_keys=plan == "two_phase")


# ------------------------------------------------ against the port's own

# keep ~0%: every chunk reads as silence; keep 100%: a graph with no
# removal detectors ahead of the removal point keeps everything; the
# default config sits in between on the synthetic stream.
_ALL_KEPT_STAGES = ("to_mono", "compress", "split_detect", "stft",
                    "cicada_bandstop", "istft", "split_final",
                    "removal_point", "mmse")


@pytest.mark.parametrize("rate, mk", [
    ("0%", lambda: (dataclasses.replace(cfg, silence_snr_threshold=2.0),
                    None)),
    ("~37%", lambda: (cfg, None)),    # seed 25: 13/36 chunks survive
    ("100%", lambda: (cfg, _ALL_KEPT_STAGES)),
])
def test_async_bit_identical_to_two_phase(rate, mk):
    """Masks and cleaned audio bitwise equal to the port's two_phase at
    every keep-rate regime, through pow2-padded tails."""
    c, stages = mk()
    stream = _stream(25 if rate == "~37%" else 21, 3)
    ref = list(Preprocessor(c, plan="two_phase", stages=stages,
                            device="cpu").run(stream))
    got = list(Preprocessor(c, plan="async", stages=stages, depth=4,
                            device="cpu").run(stream))
    assert [r.wid for r in got] == [0, 1, 2]
    frac = np.concatenate([r.det.keep.numpy() for r in ref]).mean()
    if rate == "0%":
        assert frac == 0.0
    elif rate == "100%":
        assert frac == 1.0
    else:
        assert 0.3 < frac < 0.45          # ~37%, incl. one all-removed batch
    for r, w in zip(got, ref):
        for m in _MASKS:
            np.testing.assert_array_equal(getattr(r.det, m).numpy(),
                                          getattr(w.det, m).numpy())
        np.testing.assert_array_equal(r.cleaned, w.cleaned)
        assert r.cleaned.shape[0] == r.n_kept == w.n_kept


@pytest.fixture(scope="module")
def two_phase_22():
    stream = _stream(22, 5)
    return stream, list(Preprocessor(cfg, device="cpu").run(stream))


@pytest.mark.parametrize("depth", [1, 3, 5, 9])
def test_async_in_order_exactly_once_any_depth(two_phase_22, depth):
    """Emission is input order, each batch once, for depths below, at and
    beyond the stream length, with the values of two_phase."""
    stream, ref = two_phase_22
    res = list(Preprocessor(cfg, plan="async", depth=depth,
                            device="cpu").run(stream))
    assert [r.wid for r in res] == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(np.concatenate([r.cleaned for r in res]),
                                  np.concatenate([r.cleaned for r in ref]))


def test_plans_registered_with_reference_defaults():
    assert PLANS == {"fused": FusedPlan, "two_phase": TwoPhasePlan,
                     "streaming": StreamingPlan, "async": AsyncPlan,
                     "sharded": ShardedPlan, "cached": CachedPlan}
    stream_plan = Preprocessor(cfg, plan="streaming", device="cpu").plan
    assert (stream_plan.depth, stream_plan.emit_buffer, stream_plan.bucket,
            stream_plan.donate) == (1, 0, "linear", False)
    async_plan = Preprocessor(cfg, plan="async", device="cpu").plan
    assert (async_plan.depth, async_plan.emit_buffer, async_plan.bucket,
            async_plan.donate) == (2, 1, "pow2", False)   # None: off on CPU
    assert async_plan.last_timings.maxlen == TIMINGS_CAP
    two = Preprocessor(cfg, device="cpu").plan
    assert (two.pad_multiple, two.bucket, two.donate) == (1, "linear", False)
    # no staging on the CPU: the plan's logic runs without it
    assert async_plan.staging is None and stream_plan.staging is None
    chunks = _stream(23, 1)[0][1][0]
    one = Preprocessor(cfg, plan="async", device="cpu")(chunks)
    np.testing.assert_array_equal(
        one.cleaned, Preprocessor(cfg, device="cpu")(chunks).cleaned)
    assert one.timings["n_real"] == one.n_kept


# ------------------------------------------------------ timings + padding

def test_timings_record_pipeline_and_boundary_bytes():
    stream = _stream(26, 4)
    pre = Preprocessor(cfg, plan="async", depth=4, device="cpu")
    res = list(pre.run(stream))
    t = pre.plan.last_timings
    assert len(t) == 4 and [x["in_flight"] for x in t] == [1, 2, 3, 4]
    assert any(x["n_real"] for x in t)
    for x, r in zip(t, res):
        for k in ("dispatch_s", "readback_s", "compact_s", "tail_s",
                  "emit_s"):
            assert x[k] >= 0.0
        assert x is r.timings
        cap = r.det.keep.numel()
        # the port's host-boundary accounting: the B-bool mask and the
        # n_real cleaned rows down (not the padded batch), the int32
        # index vector up
        assert x["d2h_bytes"] == cap + x["n_real"] * S5 * 4
        assert x["h2d_bytes"] == 4 * x["tail_rows"]
        assert x["tail_rows"] == (SCHED.quantize_survivors(
            x["n_real"], cap, 1, "pow2") if x["n_real"] else 0)
        assert x["wave5_bytes"] == cap * S5 * 4
        lin = SCHED.quantize_survivors(x["n_real"], cap, 1, "linear")
        assert x["old_boundary_bytes"] == (x["wave5_bytes"] + cap
                                           + 2 * lin * S5 * 4)
        assert x["d2h_bytes"] + x["h2d_bytes"] < x["old_boundary_bytes"]


@pytest.mark.parametrize("plan", ["two_phase", "async"])
def test_padded_rows_never_reach_cleaned(plan):
    """With pad_multiple=8 the tail runs pad rows: none reaches `cleaned`,
    the real rows equal the unpadded run bitwise, the old-boundary
    counterfactual counts the linear-padded batch, and the pad rows of
    both tails are zero."""
    chunks = _stream(21, 1)[0][1][0]
    pre = Preprocessor(cfg, plan=plan, pad_multiple=8, device="cpu")
    res = pre(chunks)
    assert 0 < res.n_kept == res.cleaned.shape[0]
    assert res.timings["tail_rows"] % 8 == 0
    assert res.timings["tail_rows"] > res.n_kept
    lin = SCHED.quantize_survivors(res.n_kept, 12, 8, "linear")
    assert res.timings["old_boundary_bytes"] == (
        res.timings["wave5_bytes"] + 12 + 2 * lin * S5 * 4)
    np.testing.assert_array_equal(
        res.cleaned, Preprocessor(cfg, device="cpu")(chunks).cleaned)
    det = pre.plan.detect(chunks)
    idx, n_real = SCHED.survivor_indices(det.keep.numpy(), 8, "pow2")
    assert len(idx) > n_real > 0
    for tail in (pre.graph.tail_indexed, pre.graph.tail_indexed_fused):
        out = tail(det.wave5, torch.from_numpy(idx))
        assert not out[n_real:].any()


# ------------------------------------------------------- facade + batches

@pytest.mark.parametrize("plan", ["two_phase", "async"])
def test_tensor_batch_matches_numpy_batch(plan):
    """A batch given as a CPU tensor (f32, or f64 converted on the way in)
    gives the masks and cleaned audio of the numpy batch."""
    chunks = _stream(25, 2)[1][1][0]
    pre = Preprocessor(cfg, plan=plan, device="cpu")
    want = pre(chunks)
    for batch in (torch.from_numpy(chunks),
                  torch.from_numpy(chunks.astype(np.float64))):
        got = pre(batch)
        for m in _MASKS:
            np.testing.assert_array_equal(getattr(got.det, m).numpy(),
                                          getattr(want.det, m).numpy())
        np.testing.assert_array_equal(got.cleaned, want.cleaned)
        assert got.src_bytes == want.src_bytes == chunks.nbytes


# -------------------------------------------------------------- launcher

def test_launcher_runs_every_plan_on_the_cpu(capsys):
    """`--plan`, `--depth` and `--bucket` with the reference's meaning:
    every plan keeps the same chunks, the window plans report their
    pipeline, and `--depth` is refused for a plan without a window."""
    from repro_torch.launch import preprocess
    args = ["--device", "cpu", "--minutes", "2", "--batch-long-chunks", "1",
            "--seed", "25"]
    kept = [preprocess.main(args + ["--plan", "two_phase"]),
            preprocess.main(args + ["--plan", "streaming",
                                    "--bucket", "pow2"]),
            preprocess.main(args + ["--plan", "async", "--depth", "4"])]
    assert kept[0] > 0 and len(set(kept)) == 1
    out = capsys.readouterr().out
    assert out.count("overlapped dispatches") == 2
    with pytest.raises(SystemExit):
        preprocess.main(args + ["--plan", "two_phase", "--depth", "2"])


def test_launcher_async_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    from repro_torch.launch import preprocess
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preprocess.main(["--plan", "async", "--depth", "4"])
