"""The port's pipeline against the JAX package on the CPU: acoustic indices
and detector masks on labelled segments, build-time graph validation, and
the two-phase slice end to end on the seed-25 stream (JAX side in backend
mode "ref", the port with device="cpu")."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core import detect as JD  # noqa: E402
from repro.core import stages as JS  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.data.loader import audio_batch_maker  # noqa: E402
from repro.data.synthetic import generate_labelled  # noqa: E402
from repro.kernels import backend  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core import detect as D  # noqa: E402
from repro_torch.core import stages as S  # noqa: E402
from repro_torch.core.graph import (  # noqa: E402
    STAGES, GraphValidationError, PipelineGraph)
from repro_torch.core.plans import Preprocessor  # noqa: E402

_MASKS = ("keep", "rain", "silence", "cicada15")


def _power_both(mono44k):
    """compress + STFT power of (N, S) 44.1 kHz mono on both sides."""
    with backend.use("ref"):
        jw = JS.compress(jnp.asarray(mono44k), JCFG)
        _, jp = JS.stft_chunks(jw, JCFG)
    w = S.compress(torch.from_numpy(mono44k), cfg)
    _, p = S.stft_chunks(w, cfg)
    return np.asarray(jp), p


def test_indices_and_masks_match_reference():
    """All nine indices within f32 noise and the rain / cicada / silence
    masks exactly equal, on 5 s labelled segments of every class."""
    audio, labels = generate_labelled(1, 24, segment_s=5.0,
                                      persistence=0.0)
    assert len(set(labels.tolist())) == 4
    jp, p = _power_both(audio.mean(axis=1))
    np.testing.assert_allclose(p.numpy(), jp, rtol=2e-4, atol=1e-6)
    want = JD.classify_chunks(jnp.asarray(jp), JCFG)
    got = D.classify_chunks(p, cfg)
    for k, v in want["indices"].items():
        if k == "cicada_peak_bin":
            np.testing.assert_array_equal(got["indices"][k].numpy(),
                                          np.asarray(v))
        else:
            np.testing.assert_allclose(got["indices"][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    for m in ("rain", "cicada", "silence"):
        np.testing.assert_array_equal(got[m].numpy(), np.asarray(want[m]),
                                      err_msg=m)
    assert all(got[m].any() for m in ("rain", "cicada", "silence"))


def test_stage_registry_matches_reference():
    from repro.core.graph import STAGES as JSTAGES
    assert set(STAGES) == set(JSTAGES) and len(STAGES) == 13
    graph = PipelineGraph(cfg)
    assert graph.names == cfg.stages and graph.has_removal_point
    assert graph.out_geom.split_s == cfg.final_split_s
    assert graph.fused_tail_spec == {"hpf": False}


@pytest.mark.parametrize("bad, match", [
    (("to_mono", "compress", "split_final", "split_detect"),
     "cannot split"),                       # 5 s chunks into 15 s chunks
    (("compress",), "mono"),                # stereo into the FIR
    (("to_mono", "compress", "cicada_bandstop"), "spec"),   # no STFT ran
])
def test_graph_validation_rejects_bad_orders(bad, match):
    with pytest.raises(GraphValidationError, match=match):
        PipelineGraph(cfg, bad)


# -------------------------------------------------------------- end to end

def _stream():
    make = audio_batch_maker(seed=25, batch_long_chunks=1)
    return [(w, (make(w)[0], None)) for w in range(3)]


@pytest.fixture(scope="module")
def jax_run():
    with backend.use("ref"):
        return list(JPreprocessor(JCFG, plan="two_phase").run(_stream()))


@pytest.mark.parametrize("fuse_tail", [None, False])
def test_two_phase_slice_matches_reference(jax_run, fuse_tail):
    """Both packages keep the same 13 of 36 chunks of the seed-25 stream,
    with equal masks and cleaned audio within 2e-4, through the fused and
    the staged survivor tail."""
    pre = Preprocessor(cfg, plan="two_phase", device="cpu",
                       fuse_tail=fuse_tail)
    assert pre.plan.fuse_tail is (fuse_tail is None)
    got = list(pre.run(_stream()))
    assert [r.wid for r in got] == [0, 1, 2]
    assert sum(r.n_kept for r in got) == sum(r.n_kept for r in jax_run) == 13
    assert sum(r.det.keep.numel() for r in got) == 36
    for r, w in zip(got, jax_run):
        for m in _MASKS:
            np.testing.assert_array_equal(getattr(r.det, m).numpy(),
                                          np.asarray(getattr(w.det, m)),
                                          err_msg=m)
        assert r.cleaned.shape == w.cleaned.shape
        np.testing.assert_allclose(r.cleaned, w.cleaned, rtol=2e-4,
                                   atol=2e-4)
        assert set(r.timings) == set(w.timings)


def test_scheduler_matches_reference():
    from repro.core import scheduler as JSCHED

    from repro_torch.core import scheduler as SCHED
    rng = np.random.RandomState(4)
    for n, cap, m, bucket in [(0, 48, 1, "pow2"), (5, 48, 1, "pow2"),
                              (19, 48, 1, "linear"), (33, 48, 4, "pow2"),
                              (48, 48, 8, "pow2"), (7, 12, 3, "linear")]:
        assert (SCHED.quantize_survivors(n, cap, m, bucket)
                == JSCHED.quantize_survivors(n, cap, m, bucket))
        keep = np.zeros(cap, bool)
        keep[rng.choice(cap, n, replace=False)] = True
        got, got_n = SCHED.survivor_indices(keep, m, bucket)
        want, want_n = JSCHED.survivor_indices(keep, m, bucket)
        assert got_n == want_n
        assert (got is None and want is None) or np.array_equal(got, want)
        rows = rng.randn(n, 3).astype(np.float32)
        got_b, got_r = SCHED.pad_batch(rows, max(m, 1))
        want_b, want_r = JSCHED.pad_batch(rows, max(m, 1))
        assert got_r == want_r
        assert (got_b is None and want_b is None) or np.array_equal(got_b,
                                                                    want_b)


_HPF_TAIL = cfg.stages[:-1] + ("hpf", "mmse")


@pytest.fixture(scope="module")
def jax_hpf_batch():
    with backend.use("ref"):
        return JPreprocessor(JCFG, plan="two_phase",
                             stages=_HPF_TAIL)(_stream()[1][1][0])


@pytest.mark.parametrize("fuse_tail", [None, False])
def test_highpass_tail_matches_reference(jax_hpf_batch, fuse_tail):
    """The [hpf ->] mmse survivor chain: the fused tail with its high-pass
    and the staged hpf + mmse stages, on a batch with 7 survivors."""
    pre = Preprocessor(cfg, stages=_HPF_TAIL, device="cpu",
                       fuse_tail=fuse_tail)
    assert pre.graph.fused_tail_spec == {"hpf": True}
    got = pre(_stream()[1][1][0])
    want = jax_hpf_batch
    assert got.n_kept == want.n_kept == 7
    np.testing.assert_array_equal(got.det.keep.numpy(),
                                  np.asarray(want.det.keep))
    np.testing.assert_allclose(got.cleaned, want.cleaned, rtol=2e-4,
                               atol=2e-4)
