"""The port's sharded plan in-process, its Rebalancer and its fault
primitives on the CPU: the Rebalancer against the JAX package's on skewed,
empty, non-divisible and fewer-live-shards masks (and on device tensors,
sliced where they lie); the in-process `ShardedPlan` with 2 and 3 shards,
its serve path and a skewed stream against the JAX ShardedPlan in backend
mode "ref" (masks exactly, cleaned audio within rtol = atol = 2e-4, the
re-shard stats equal); against the port's own two_phase within the
reference's plan-equivalence bound (rtol 1e-4, atol 1e-5); crash and
lease-expiry recovery with exactly-once emission; `CachedPlan` around the
sharded plan cold and warm; the leased loaders; and `CrashInjector`,
`HeartbeatMonitor` and `StragglerDetector`.

Each JAX run is one module-scoped fixture on `batch_long_chunks=1`
batches of the seed-25 stream (one 60 s stereo long chunk each)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core import scheduler as JSCHED  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.kernels import backend  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core import scheduler as SCHED  # noqa: E402
from repro_torch.core.plans import (  # noqa: E402
    PLANS, CachedPlan, Preprocessor, ShardedPlan)
from repro_torch.data.loader import (  # noqa: E402
    AudioChunkLoader, ShardedLoader, audio_batch_maker, audio_shard_pool,
    make_shard_pool)
from repro_torch.data.queue import SettableClock, WorkQueue  # noqa: E402
from repro_torch.ft.failure import (  # noqa: E402
    CrashInjector, HeartbeatMonitor, StragglerDetector)

_MASKS = ("keep", "rain", "silence", "cicada15")


def _stream(n_batches=3, seed=25):
    make = audio_batch_maker(seed=seed, batch_long_chunks=1)
    return [(w, (make(w)[0], None)) for w in range(n_batches)]


def _skewed():
    """Two batches: the seed-25 stream's batch 1 (7 of 12 kept) and a
    near-silent batch (none kept), so one shard detects every survivor."""
    base = _stream(2)[1][1][0]
    quiet = (1e-4 * np.random.RandomState(0).randn(*base.shape)).astype(
        np.float32)
    return [(0, (base, None)), (1, (quiet, None))]


def _assert_masks_equal(got_det, want_det):
    for m in _MASKS:
        np.testing.assert_array_equal(np.asarray(getattr(got_det, m)),
                                      np.asarray(getattr(want_det, m)), m)


def _assert_stats_equal(got, want):
    assert got.keys() == want.keys()
    for k in ("loads_before", "loads_after"):
        np.testing.assert_array_equal(got[k], want[k], k)
    for k in ("max_min_before", "max_min_after", "moved"):
        assert got[k] == want[k], k


# ------------------------------------------------------------ Rebalancer

_MASK_CASES = {
    # one shard all survivors, one all removed, one half
    "skewed": ([np.ones(12, bool), np.zeros(12, bool),
                np.array([True, False] * 6)], None, 1),
    # 11 survivors over the 2 shards still alive of 3
    "non_divisible_fewer_live": ([np.ones(7, bool), np.ones(4, bool),
                                  np.zeros(5, bool)], 2, 1),
    "pads_batches": ([np.ones(3, bool), np.ones(2, bool)], None, 4),
    "empty": ([np.zeros(4, bool), np.zeros(4, bool)], None, 1),
}


@pytest.mark.parametrize("case", sorted(_MASK_CASES))
def test_rebalancer_matches_reference(case):
    keeps, out_shards, pad = _MASK_CASES[case]
    n_shards = len(keeps) if case != "pads_batches" else 2
    got = SCHED.Rebalancer(n_shards, pad).assign(keeps, out_shards)
    want = JSCHED.Rebalancer(n_shards, pad).assign(keeps, out_shards)
    _assert_stats_equal(got.stats(), want.stats())
    np.testing.assert_array_equal(got.bounds, want.bounds)
    n = int(got.counts_after.sum())
    surv = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got_parts = list(SCHED.Rebalancer(n_shards, pad).split(surv, got))
    want_parts = list(JSCHED.Rebalancer(n_shards, pad).split(surv, want))
    assert [(j, b.shape, r) for j, b, r in got_parts] == \
        [(j, b.shape, r) for j, b, r in want_parts]
    for (_, b, _), (_, wb, _) in zip(got_parts, want_parts):
        np.testing.assert_array_equal(b, wb)


def test_rebalancer_known_values():
    """The reference test's own numbers: the skew evens out within the
    +-1 of integer division, pad rows are zero rows."""
    asg = SCHED.Rebalancer(3).assign(_MASK_CASES["skewed"][0])
    st = asg.stats()
    assert st["loads_before"].tolist() == [12, 0, 6]
    assert st["max_min_before"] == 12.0
    assert st["loads_after"].tolist() == [6, 6, 6]
    assert st["moved"] == 6
    assert asg.bounds.tolist() == [0, 6, 12, 18]
    reb = SCHED.Rebalancer(2, pad_multiple=4)
    surv = np.arange(10, dtype=np.float32).reshape(5, 2)
    parts = list(reb.split(surv, reb.assign([np.ones(3, bool),
                                              np.ones(2, bool)])))
    assert [(j, b.shape[0], n) for j, b, n in parts] == [(0, 4, 3),
                                                         (1, 4, 2)]
    np.testing.assert_array_equal(parts[0][1][3], 0.0)
    empty = SCHED.Rebalancer(2).assign([np.zeros(4, bool)] * 2)
    assert list(SCHED.Rebalancer(2).split(torch.zeros(0, 8), empty)) == []
    with pytest.raises(ValueError, match="live shard"):
        SCHED.Rebalancer(2).assign([np.ones(2, bool)], out_shards=0)


def test_rebalancer_splits_tensors_where_they_lie():
    """A survivor tensor is cut and padded as tensors: an unpadded slot is
    a view of the input (nothing copied, nothing read back), a padded one
    gains exact zero rows on the same device."""
    surv = torch.arange(7 * 4, dtype=torch.float32).reshape(7, 4)
    reb = SCHED.Rebalancer(2, pad_multiple=4)
    parts = list(reb.split(surv, reb.assign([np.ones(7, bool)],
                                            out_shards=2)))
    assert [(j, tuple(b.shape), n) for j, b, n in parts] == [
        (0, (4, 4), 4), (1, (4, 4), 3)]
    b0, b1 = parts[0][1], parts[1][1]
    assert torch.is_tensor(b0) and torch.is_tensor(b1)
    assert b0.data_ptr() == surv.data_ptr()            # a view
    assert torch.equal(b1[:3], surv[4:])
    assert not b1[3].any() and b1.device == surv.device
    batch, n = SCHED.pad_batch(surv[:2], 3)
    assert tuple(batch.shape) == (3, 4) and n == 2 and not batch[2].any()


# ---------------------------------------------- against the JAX package

@pytest.fixture(scope="module")
def jax_runs():
    stream = _stream()
    x = np.concatenate([c for _, (c, _) in stream])
    out = {}
    with backend.use("ref"):
        for shards, lease in ((2, 1), (3, 1), (2, 2)):
            pre = JPreprocessor(JCFG, plan="sharded", shards=shards,
                                lease_items=lease)
            out[(shards, lease)] = (list(pre.run(stream)),
                                    pre.plan.last_assignment.stats())
        pre = JPreprocessor(JCFG, plan="sharded", shards=3)
        out["call"] = (pre(x), pre.plan.last_assignment.stats())
        pre = JPreprocessor(JCFG, plan="sharded", shards=2)
        out["skewed"] = (list(pre.run(_skewed())),
                         pre.plan.last_assignment.stats())
    return out


def _assert_results_match(got, want):
    assert [r.wid for r in got] == [r.wid for r in want]
    for g, w in zip(got, want):
        _assert_masks_equal(g.det, w.det)
        assert g.n_kept == w.n_kept
        assert g.cleaned.shape == w.cleaned.shape
        np.testing.assert_allclose(g.cleaned, w.cleaned, rtol=2e-4,
                                   atol=2e-4)
        assert g.src_bytes == w.src_bytes


@pytest.mark.parametrize("shards,lease_items", [(2, 1), (3, 1), (2, 2)])
def test_inproc_sharded_matches_reference(jax_runs, shards, lease_items):
    want, want_stats = jax_runs[(shards, lease_items)]
    pre = Preprocessor(cfg, plan="sharded", shards=shards,
                       lease_items=lease_items, device="cpu")
    assert isinstance(pre.plan, ShardedPlan)
    got = list(pre.run(_stream()))
    _assert_results_match(got, want)
    _assert_stats_equal(pre.plan.last_assignment.stats(), want_stats)
    assert pre.plan.redeliveries == 0
    assert sum(st.chunks_done for st in pre.plan.worker_stats) == 3


def test_serve_path_call_matches_reference(jax_runs):
    """`__call__`: rows split across 3 shards, survivors rebalanced, the
    batch reassembled; the merged stats weighted by chunk count."""
    want, want_stats = jax_runs["call"]
    x = np.concatenate([c for _, (c, _) in _stream()])
    pre = Preprocessor(cfg, plan="sharded", shards=3, device="cpu")
    got = pre(x)
    _assert_masks_equal(got.det, want.det)
    assert got.n_kept == want.n_kept
    np.testing.assert_allclose(got.cleaned, want.cleaned, rtol=2e-4,
                               atol=2e-4)
    assert got.det.stats["n_chunks5"] == want.det.stats["n_chunks5"] == 36
    for k, v in want.det.stats.items():
        assert float(got.det.stats[k]) == pytest.approx(float(v), abs=1e-6)
    _assert_stats_equal(pre.plan.last_assignment.stats(), want_stats)
    assert want_stats["moved"] > 0            # the re-shard moved rows


def test_skewed_stream_rebalanced_like_reference(jax_runs):
    """One shard detects every survivor, the other none: the re-shard
    evens them out (max/min <= 1.5) exactly as the reference's does."""
    want, want_stats = jax_runs["skewed"]
    pre = Preprocessor(cfg, plan="sharded", shards=2, device="cpu")
    got = list(pre.run(_skewed()))
    _assert_results_match(got, want)
    st = pre.plan.last_assignment.stats()
    _assert_stats_equal(st, want_stats)
    assert int(st["loads_before"].min()) == 0
    assert st["max_min_after"] <= 1.5
    assert int(st["loads_after"].sum()) == sum(r.n_kept for r in got)


# ------------------------------------------------------- within the port

@pytest.mark.parametrize("shards", [2, 3])
def test_inproc_sharded_matches_two_phase(shards):
    """Masks exactly, cleaned audio within the reference's plan bound:
    the rebalanced staged tail against two_phase's fused tail."""
    stream = _stream()
    ref = {r.wid: r for r in Preprocessor(cfg, device="cpu").run(stream)}
    got = list(Preprocessor(cfg, plan="sharded", shards=shards,
                            pad_multiple=2, device="cpu").run(stream))
    assert [r.wid for r in got] == [0, 1, 2]
    for r in got:
        _assert_masks_equal(r.det, ref[r.wid].det)
        assert r.n_kept == ref[r.wid].n_kept
        np.testing.assert_allclose(r.cleaned, ref[r.wid].cleaned,
                                   rtol=1e-4, atol=1e-5)


def test_sharded_crash_recovery_exactly_once():
    """A shard killed mid-stream: every id emitted once, redelivered."""
    make = audio_batch_maker(seed=2, batch_long_chunks=1)
    pool = make_shard_pool(make, 5, 3)
    inj = CrashInjector()
    inj.kill(1, after_items=1)
    pre = Preprocessor(cfg, plan="sharded", shards=3, injector=inj,
                       device="cpu")
    results = list(pre.run(pool))
    assert sorted(r.wid for r in results) == list(range(5))
    assert pre.plan.redeliveries >= 1
    assert not inj.alive(1)
    ref = Preprocessor(cfg, device="cpu")
    for r in results:
        _assert_masks_equal(r.det, ref(make(r.wid)[0]).det)


def test_sharded_forced_lease_expiry_redelivers():
    """A lease orphaned before the run (its deadline already past) is
    reaped on the first pull and the work completes on a live shard."""
    clock = SettableClock()
    queue = WorkQueue(3, lease_timeout_s=5.0, clock=clock)
    assert queue.lease("ghost", 1) == [0]
    clock.t = 6.0
    make = audio_batch_maker(seed=4, batch_long_chunks=1)
    pool = make_shard_pool(make, 3, 2, queue=queue)
    pre = Preprocessor(cfg, plan="sharded", shards=2, device="cpu")
    assert sorted(r.wid for r in pre.run(pool)) == [0, 1, 2]
    assert pre.plan.redeliveries >= 1


def test_sharded_all_shards_dead_raises():
    make = audio_batch_maker(seed=1, batch_long_chunks=1)
    pool = make_shard_pool(make, 4, 2)
    inj = CrashInjector()
    inj.kill(0, after_items=0)
    inj.kill(1, after_items=0)
    pre = Preprocessor(cfg, plan="sharded", shards=2, injector=inj,
                       device="cpu")
    with pytest.raises(RuntimeError, match="stalled"):
        list(pre.run(pool))


def test_sharded_plan_validation():
    assert PLANS["sharded"] is ShardedPlan
    with pytest.raises(ValueError, match="transport"):
        Preprocessor(cfg, plan="sharded", transport="carrier-pigeon",
                     device="cpu")
    with pytest.raises(ValueError, match="data_plane"):
        Preprocessor(cfg, plan="sharded", data_plane="/nonexistent",
                     device="cpu")
    make = audio_batch_maker(seed=0, batch_long_chunks=1)
    with pytest.raises(ValueError, match="out of range"):
        list(Preprocessor(cfg, plan="sharded", shards=2, device="cpu").run(
            make_shard_pool(make, 2, 3)))


def test_cached_around_sharded_cold_then_warm(tmp_path):
    """CachedPlan(inner="sharded"): the cold pass runs the sharded plan
    and fills the store; the warm pass is all hits, masks and cleaned
    audio bitwise equal to the cold pass."""
    stream = _stream()
    cold = Preprocessor(cfg, plan="cached", inner="sharded", shards=2,
                        store=tmp_path / "st", device="cpu")
    assert isinstance(cold.plan.inner, ShardedPlan)
    a = list(cold.run(stream))
    assert cold.plan.stats.misses == 3 and cold.plan.stats.writes == 3
    warm = Preprocessor(cfg, plan="cached", inner="sharded", shards=2,
                        store=tmp_path / "st", device="cpu")
    b = list(warm.run(stream))
    assert warm.plan.stats.hits == 3 and warm.plan.stats.misses == 0
    assert [r.wid for r in a] == [r.wid for r in b] == [0, 1, 2]
    for x, y in zip(a, b):
        _assert_masks_equal(y.det, x.det)
        np.testing.assert_array_equal(y.cleaned, x.cleaned)


# ------------------------------------------------------------ loaders

def test_sharded_loader_pool_shares_queue():
    make = audio_batch_maker(seed=0, batch_long_chunks=1)
    pool = make_shard_pool(make, 4, 2)
    assert all(isinstance(ld, ShardedLoader) for ld in pool)
    assert pool[0].queue is pool[1].queue
    assert [ld.worker for ld in pool] == ["shard0", "shard1"]
    (wid, (batch, labels)), = pool[0].pull()
    assert batch.shape[0] == 1 and labels.shape == (12,)
    assert pool[0].complete(wid) and not pool[0].complete(wid)
    assert pool[0].cursor()["done"] == [wid]
    sp = audio_shard_pool(seed=0, n_batches=3, batch_long_chunks=1,
                          n_shards=3, lease_items=2)
    assert len(sp) == 3 and sp[2].lease_items == 2
    assert [w for w, _ in sp[0].pull()] == [0, 1]


def test_audio_chunk_loader_yields_the_maker_stream():
    """The prefetching loader yields the maker's batches in order,
    completes each as it goes, and resumes from `start_at`."""
    make = audio_batch_maker(seed=3, batch_long_chunks=1)
    ld = AudioChunkLoader(seed=3, n_batches=3, batch_long_chunks=1,
                          prefetch=2)
    assert len(ld) == 3
    got = list(ld)
    assert [w for w, _ in got] == [0, 1, 2]
    for w, (chunks, labels) in got:
        np.testing.assert_array_equal(chunks, make(w)[0])
        np.testing.assert_array_equal(labels, make(w)[1])
    assert len(ld) == 0 and ld.cursor()["done"] == [0, 1, 2]
    rest = AudioChunkLoader(seed=3, n_batches=3, batch_long_chunks=1,
                            start_at=2)
    assert [w for w, _ in rest] == [2]


# ------------------------------------------------------- fault primitives

def test_crash_injector_fuse():
    inj = CrashInjector()
    inj.kill(0, after_items=2)
    assert inj.on_pull(0) and inj.on_pull(0)
    assert not inj.on_pull(0)               # dies on the third pull
    assert not inj.alive(0) and inj.crashed == frozenset({0})
    assert not inj.on_pull(0)               # dead stays dead
    assert inj.on_pull(1)                   # unarmed shards live on


def test_heartbeat_monitor_dead_and_forget():
    clock = SettableClock()
    mon = HeartbeatMonitor(timeout_s=5.0, clock=clock)
    mon.beat("a")
    mon.beat("b")
    clock.t = 3.0
    mon.beat("b")
    clock.t = 6.0
    assert mon.dead() == {"a"} and mon.alive() == {"b"}
    mon.forget("a")
    assert mon.dead() == set()


def test_straggler_detector_min_history_gates():
    """No speculation before enough completions: with a thin history
    every in-flight time looks infinite."""
    clock = SettableClock()
    sd = StragglerDetector(factor=2.0, min_history=5, clock=clock)
    sd.start("t")
    clock.t += 100.0
    assert sd.stragglers() == []
    for i in range(5):
        sd.start(i)
        clock.t += 1.0
        sd.complete(i)
    assert sd.stragglers() == ["t"]


def test_straggler_detector_p95_window():
    clock = SettableClock()
    sd = StragglerDetector(factor=2.0, min_history=10, clock=clock)
    for i in range(100):
        sd.start(i)
        clock.t += 1.0
        sd.complete(i)
    assert sd.p95() == 1.0
    sd.start("x")
    clock.t += 1.5
    assert sd.stragglers() == []            # 1.5 <= 2 x p95
    clock.t += 1.0
    assert sd.stragglers() == ["x"]         # 2.5 > 2 x p95


def test_straggler_detector_latency_truncation():
    """Past 1000 samples the history is cut back to the newest 500."""
    sd = StragglerDetector(clock=SettableClock())
    for i in range(1001):
        sd.start(i)
        sd.complete(i)
    assert len(sd._latencies) == 500


def test_straggler_detector_orders_longest_running_first():
    clock = SettableClock()
    sd = StragglerDetector(factor=1.0, min_history=1, clock=clock)
    sd.start("old")
    clock.t = 5.0
    sd.start("new")
    clock.t = 6.0
    sd.start("quick")
    sd.complete("quick")
    clock.t = 20.0
    assert sd.stragglers() == ["old", "new"]


def test_cached_plan_inner_sharded_is_a_plan_class():
    plan = CachedPlan(Preprocessor(cfg, device="cpu").graph,
                      inner="sharded", shards=3, device="cpu")
    assert plan.inner.shards == 3 and plan.inner.device.type == "cpu"
