"""The port's serving tier on the CPU: the cases of the reference's
`tests/test_serving.py` against the port. `StandingWorkQueue` (open-ended
FIFO, redelivery first, close and abort); the `WorkerPool` over threads
(three waves exactly once, bitwise equal to the port's `two_phase`; the
gauges; queue-depth autoscaling up and back down; a speculative duplicate
of a stalled request); the `ContinuousBatcher` (full and partial batches, pow2
occupancy with zero pad rows, deadlines while waiting and at delivery,
admission control; 4 client threads over an in-process pool);
`PreprocessService` (zero-padded pumps, popped results, the pool path and
the cached short-circuit); two pools of 2 real worker processes, one
with a worker SIGKILLed holding a lease, one over the tcp transport and
the store data plane; the kernel launch counter under threads; and
`launch.serve --audio --device cpu` with its pool options.

Against the JAX package: the batcher's batches of 1, 2 and 4 long chunks
(zero-padded to the pow2 bucket) and an all-removed batch, through the
reference's `two_phase` in backend mode "ref" in one module fixture: masks
exactly equal, cleaned rows within rtol = atol = 2e-4.

Every pool here runs `device="cpu"`; spawned workers get one intra-op
thread each.
"""
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.kernels import backend  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core.plans import Preprocessor  # noqa: E402
from repro_torch.data.loader import audio_batch_maker  # noqa: E402
from repro_torch.data.queue import (SettableClock,  # noqa: E402
                                    StandingWorkQueue)
from repro_torch.serve import (AdmissionError,  # noqa: E402
                               ContinuousBatcher, PreprocessService,
                               WorkerPool)

make = audio_batch_maker(seed=23, batch_long_chunks=1)
CHUNKS = [make(w)[0][0] for w in range(8)]      # (2, S_long) requests
# a near-silent request: every one of its chunks is removed
QUIET = (1e-4 * np.random.RandomState(0).randn(*CHUNKS[0].shape)).astype(
    np.float32)
REF = Preprocessor(cfg, plan="two_phase", device="cpu")


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture
def fresh_registry():
    """An isolated metrics registry for the test; the process's own is
    restored afterwards."""
    from repro_torch.obs import metrics as obs_metrics
    prev = obs_metrics.get_registry()
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.set_registry(reg)
    yield reg
    obs_metrics.set_registry(prev)


def padded(chunks, rows):
    batch = np.stack(chunks)
    if rows > len(chunks):
        batch = np.concatenate([batch, np.zeros(
            (rows - len(chunks),) + batch.shape[1:], np.float32)])
    return batch


def sliced(res, n, rows):
    """Per-request records of one batch result, sliced as the serving
    layers slice it."""
    keep = np.asarray(res.det.keep)
    per = keep.size // rows
    offs = np.concatenate([[0], np.cumsum(keep)]).astype(int)
    return [{"keep": keep[j * per:(j + 1) * per],
             "cleaned": res.cleaned[offs[j * per]:offs[(j + 1) * per]]}
            for j in range(n)]


def ref_sliced(chunks, rows):
    """The zero-padded batch through the port's two_phase, sliced."""
    return sliced(REF(padded(chunks, rows)), len(chunks), rows)


def _assert_records(records, want, exact=True):
    for rec, w in zip(records, want):
        np.testing.assert_array_equal(rec["keep"], w["keep"])
        if exact:
            np.testing.assert_array_equal(rec["cleaned"], w["cleaned"])
        else:
            assert rec["cleaned"].shape == w["cleaned"].shape
            np.testing.assert_allclose(rec["cleaned"], w["cleaned"],
                                       rtol=2e-4, atol=2e-4)


# ---------------------------------------------------- standing queue

def test_standing_queue_open_ended_fifo_and_close():
    q = StandingWorkQueue(lease_timeout_s=60.0)
    assert not q.finished                 # empty but open: workers poll
    a, b = q.add(), q.add()
    assert q.lease("w", 1) == [a], "a standing queue leases FIFO"
    assert q.lease("w", 2) == [b]
    assert q.depth() == (0, 2)
    q.complete([a, b])
    assert not q.finished                 # drained but still open
    c = q.add()
    q.close()
    with pytest.raises(RuntimeError):
        q.add()                           # closed to new work
    assert not q.finished                 # c outstanding
    q.lease("w", 1)
    q.complete([c])
    assert q.finished


def test_standing_queue_redelivery_beats_new_traffic():
    clock = SettableClock()
    q = StandingWorkQueue(lease_timeout_s=5.0, clock=clock)
    old = q.add()
    assert q.lease("dead", 1) == [old]
    clock.t = 6.0                         # the lease expires
    new = q.add()
    assert q.lease("live", 1) == [old], \
        "a redelivered request goes to the front of the line"
    assert q.lease("live", 1) == [new]


def test_standing_queue_abort_unblocks_workers():
    q = StandingWorkQueue()
    q.add()
    q.abort()
    assert q.finished                     # workers exit without draining


# ------------------------------------------------ worker pool (threads)

def test_pool_waves_bit_identical_and_exactly_once():
    """Three submit waves through one pool: every result bitwise equal to
    a direct two_phase call on the same batch, each wid once, the ledger
    and gauges consistent."""
    with WorkerPool(cfg, workers=2, transport="inproc", poll_s=0.002,
                    device="cpu") as pool:
        seen = set()
        for wave in range(3):
            batches = {pool.submit(np.stack(CHUNKS[2 * k:2 * k + 2])):
                       CHUNKS[2 * k:2 * k + 2] for k in range(2)}
            got = pool.wait(list(batches), timeout_s=300.0)
            assert sorted(got) == sorted(batches)
            assert not seen & got.keys(), "a wid resolved twice"
            seen |= got.keys()
            for wid, res in got.items():
                want = REF(np.stack(batches[wid]))
                np.testing.assert_array_equal(np.asarray(res.det.keep),
                                              np.asarray(want.det.keep))
                np.testing.assert_array_equal(res.cleaned, want.cleaned)
                assert res.n_kept == want.n_kept
        g = pool.gauges()
        assert g["completed"] == g["submitted"] == 6
        assert g["queue_depth"] == 0 and g["oldest_age_s"] is None
        assert sum(s.chunks_done for s in pool.worker_stats) == 6
        assert pool.pids == {}                  # threads have no pids
    assert all(s.state == "departed" for s in pool.worker_stats)


def test_pool_gauges_show_backlog():
    pool = WorkerPool(cfg, workers=1, transport="inproc", poll_s=0.002,
                      device="cpu")
    pool.submit(np.stack(CHUNKS[:1]))     # not started: work queues, ages
    pool.submit(np.stack(CHUNKS[1:2]))
    g = pool.gauges()
    assert g["queue_depth"] + g["in_flight"] == 2
    assert g["oldest_age_s"] >= 0.0 and g["completed"] == 0
    pool.start()
    pool.drain(timeout_s=300.0)
    assert pool.gauges()["queue_depth"] == 0
    pool.shutdown()


def test_pool_refuses_unknown_transport():
    with pytest.raises(ValueError, match="unknown transport"):
        WorkerPool(cfg, transport="carrier-pigeon", device="cpu")


def _assert_bitwise(got, batches):
    """Every pool result bitwise equal to the port's two_phase on its
    batch."""
    assert sorted(got) == sorted(batches)
    for wid, res in got.items():
        want = REF(batches[wid])
        np.testing.assert_array_equal(np.asarray(res.det.keep),
                                      np.asarray(want.det.keep))
        np.testing.assert_array_equal(res.cleaned, want.cleaned)


def test_pool_autoscale_inproc():
    """Sustained backlog scales the pool up toward max_workers; a
    sustained fully-idle pool drains back toward min_workers. Results
    stay exactly-once and bitwise equal to two_phase throughout."""
    pool = WorkerPool(cfg, workers=1, transport="inproc", poll_s=0.005,
                      min_workers=1, max_workers=3,
                      autoscale_backlog_s=0.05, autoscale_idle_s=0.1,
                      device="cpu").start()
    try:
        batches = {pool.submit(c[None]): c[None] for c in CHUNKS[:6]}
        got = pool.wait(list(batches), timeout_s=300.0)
        assert pool.scale_ups >= 1, "sustained backlog never scaled up"
        assert len(pool._live_active()) <= 3
        deadline = time.monotonic() + 120.0
        while len(pool._live_active()) > 1 and time.monotonic() < deadline:
            pool.poll()                   # each pump runs the autoscaler
            time.sleep(0.01)
        assert pool.scale_downs >= 1, "idle pool never drained down"
        assert len(pool._live_active()) == 1
        g = pool.gauges()
        assert g["epoch"] >= 1 and g["scale_ups"] == pool.scale_ups
        assert g["scale_downs"] == pool.scale_downs
        _assert_bitwise(got, batches)
    finally:
        pool.shutdown(drain=False)
    drained = [s for s in pool.worker_stats if s.state == "departed"]
    assert len(drained) == len(pool.worker_stats) == 1 + pool.scale_ups


def test_pool_speculates_a_straggler_inproc():
    """speculate=True: a request whose first fetch stalls turns straggler
    once it has run straggler_factor x the p95 of the warm-up latencies;
    the idle worker's empty lease duplicates it, the duplicate's result is
    accepted, and the stalled lease loses the race. Exactly once, bitwise
    equal to two_phase."""
    pool = WorkerPool(cfg, workers=2, transport="inproc", poll_s=0.005,
                      speculate=True, straggler_factor=2.0,
                      straggler_min_history=2, device="cpu")
    fetch = pool.service._fetch_item
    armed, released, stalled = threading.Event(), threading.Event(), []

    def stalling_fetch(wid):
        if armed.is_set() and not stalled:
            stalled.append(wid)
            released.wait(120.0)
        return fetch(wid)

    pool.service._fetch_item = stalling_fetch
    pool.start()
    try:
        warm = {pool.submit(c[None]): c[None] for c in CHUNKS[:4]}
        got = pool.wait(list(warm), timeout_s=300.0)
        armed.set()
        slow = pool.submit(CHUNKS[4][None])
        got.update(pool.wait([slow], timeout_s=300.0))
        assert stalled == [slow], "the stalled fetch never ran"
        assert pool.queue.speculations == 1
        assert pool.queue.speculations_lost == 1
        _assert_bitwise(got, {**warm, slow: CHUNKS[4][None]})
    finally:
        released.set()
        pool.shutdown(drain=True)
    assert sum(s.chunks_done for s in pool.worker_stats) == 5


# -------------------------------------------------- continuous batcher

def _sync_batcher(**kw):
    """A batcher over the port's in-process two_phase (no pool): one
    thread, deterministic dispatch, for the policy tests."""
    return ContinuousBatcher(plan=REF, **kw)


def test_batcher_full_batch_dispatches_immediately():
    clock = SettableClock()
    b = _sync_batcher(max_batch=2, linger_s=10.0, clock=clock)
    r0, r1 = b.submit(CHUNKS[0]), b.submit(CHUNKS[1])
    assert sorted(b.pump()) == [r0, r1]   # full batch: no linger
    want = ref_sliced(CHUNKS[:2], 2)
    for j, rid in enumerate((r0, r1)):
        rec = b.result(rid)
        assert rec["ok"]
        _assert_records([rec], [want[j]])
        assert b.result(rid) is None      # popped: exactly once


def test_batcher_partial_batch_after_linger_zero_padded():
    clock = SettableClock()
    b = _sync_batcher(max_batch=4, linger_s=0.5, clock=clock)
    rids = [b.submit(c) for c in CHUNKS[:3]]
    assert b.pump() == []                 # partial, linger not elapsed
    clock.t = 0.6
    assert sorted(b.pump()) == sorted(rids)
    (entry,) = b.batch_log
    assert entry["n_real"] == 3 and entry["rows"] == 4
    _assert_records([b.result(r) for r in rids], ref_sliced(CHUNKS[:3], 4))


def test_batcher_pow2_occupancy_buckets():
    clock = SettableClock()
    b = _sync_batcher(max_batch=8, linger_s=0.0, clock=clock)
    for n, rows in ((3, 4), (5, 8), (8, 8)):
        for c in CHUNKS[:n]:
            b.submit(c)
        b.pump()
        assert b.batch_log[-1]["rows"] == rows
    assert b.stats()["mean_occupancy"] == pytest.approx((3 / 4 + 5 / 8 + 1)
                                                        / 3)


def test_batcher_deadline_expired_fails_and_never_dispatches():
    clock = SettableClock()
    b = _sync_batcher(max_batch=4, linger_s=0.2, clock=clock)
    doomed = b.submit(CHUNKS[0], timeout_s=0.1)
    live = b.submit(CHUNKS[1])
    clock.t = 0.3                         # doomed expired, linger passed
    assert sorted(b.pump()) == [doomed, live]
    assert b.result(doomed) == {"ok": False, "error": "deadline",
                                "waited_s": pytest.approx(0.3)}
    assert b.result(doomed) is None
    assert all(doomed not in e["rids"] for e in b.batch_log), \
        "an expired request reached a dispatched batch"
    assert b.result(live)["ok"]
    assert b.expired == 1


def test_batcher_late_result_not_served_stale():
    """A request whose deadline passes while its batch computes is failed
    at delivery: a stale result is dropped, not served."""
    clock = SettableClock()

    class SlowPlan:
        def __call__(self, batch):
            clock.t += 10.0               # the batch "takes" 10 s
            return REF(batch)

    b = ContinuousBatcher(plan=SlowPlan(), max_batch=2, linger_s=0.0,
                          clock=clock)
    rid = b.submit(CHUNKS[0], timeout_s=5.0)
    ok_rid = b.submit(CHUNKS[1])          # no deadline: still served
    b.pump()
    assert b.result(rid)["ok"] is False
    assert b.result(ok_rid)["ok"] is True


def test_batcher_admission_control_backpressure():
    b = _sync_batcher(max_batch=4, max_queue=2, linger_s=10.0,
                      clock=SettableClock())
    b.submit(CHUNKS[0])
    b.submit(CHUNKS[1])
    with pytest.raises(AdmissionError):
        b.submit(CHUNKS[2])
    assert b.rejected == 1


def test_batcher_requires_exactly_one_backend():
    with pytest.raises(ValueError, match="exactly one"):
        ContinuousBatcher()


# --------------------------------------------- pool + batcher + service

def test_batcher_over_pool_concurrent_clients():
    """4 client threads against a 2-thread pool with the pump on a
    background thread: every request resolves once, bitwise equal to the
    port's two_phase on its logged batch, sliced."""
    with WorkerPool(cfg, workers=2, transport="inproc", poll_s=0.002,
                    device="cpu") as pool:
        b = ContinuousBatcher(pool=pool, max_batch=4, linger_s=0.01)
        chunks_by_rid, records, lock = {}, {}, threading.Lock()

        def client(cid):
            for i in range(2):
                c = CHUNKS[(cid * 2 + i) % len(CHUNKS)]
                rid = b.submit(c)
                with lock:
                    chunks_by_rid[rid] = c
                rec = b.wait(rid, timeout_s=300.0)
                with lock:
                    records[rid] = rec

        with b:
            ts = [threading.Thread(target=client, args=(c,))
                  for c in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        assert len(records) == 8 and all(r["ok"] for r in records.values())
        assert sorted(r for e in b.batch_log for r in e["rids"]) == \
            sorted(records)               # each request in one batch
        for e in b.batch_log:
            want = ref_sliced([chunks_by_rid[r] for r in e["rids"]],
                              e["rows"])
            _assert_records([records[r] for r in e["rids"]], want)
        assert b.stats()["in_flight"] == 0


def test_service_zero_pads_and_pops_results():
    svc = PreprocessService(cfg, device="cpu", batch_long_chunks=4)
    rids = [svc.submit(c) for c in CHUNKS[:3]]
    assert sorted(svc.pump()) == sorted(rids)
    want = ref_sliced(CHUNKS[:3], 4)
    for j, rid in enumerate(rids):
        _assert_records([svc.result(rid)], [want[j]])
        assert svc.result(rid) is None    # popped: a bounded result map
    t = svc.last_timings                  # the plan's record of the pump
    assert "emit_s" in t and t["tail_rows"] >= t["n_real"] > 0


def test_service_pool_path_and_cached_short_circuit(tmp_path):
    """PreprocessService(pool=...): pumps go to the pool's workers; with a
    cached plan a repeated batch is served from the store without
    touching a worker."""
    with WorkerPool(cfg, workers=1, transport="inproc", poll_s=0.002,
                    device="cpu") as pool:
        svc = PreprocessService(cfg, device="cpu", plan="cached",
                                store=str(tmp_path), batch_long_chunks=2,
                                pool=pool)
        rids = [svc.submit(c) for c in CHUNKS[:2]]
        svc.pump()
        miss = {rid: svc.result(rid) for rid in rids}
        assert pool.queue.n_items == 1    # the miss went to the pool
        rids2 = [svc.submit(c) for c in CHUNKS[:2]]
        svc.pump()
        assert pool.queue.n_items == 1, "a cached warm hit touched a worker"
        assert svc.cache_stats.hits == 1
        want = ref_sliced(CHUNKS[:2], 2)
        for j, (rid, rid2) in enumerate(zip(rids, rids2)):
            _assert_records([miss[rid], svc.result(rid2)], [want[j]] * 2)
        assert sum(s.chunks_done for s in svc.worker_stats) == 1
        assert "pool_workers 1" in svc.metrics_text()


# ---------------------------------------------------- worker processes

def test_pool_proc_sigkill_redelivered_exactly_once():
    """A pool of 2 worker processes with shard0 SIGKILLed the moment its
    first lease is granted: the request in flight goes to the survivor
    once, results stay bitwise equal, and the dead worker's lease shows
    as reclaimed. Then the same pool serves a second wave on the
    surviving pid."""
    from repro_torch.ft.failure import CrashInjector

    pool = WorkerPool(cfg, workers=2, transport="proc", respawn=False,
                      poll_s=0.01, device="cpu").start()
    try:
        injector = CrashInjector()
        injector.kill(0, after_items=0)
        injector.attach(0, pool.pids[0])
        pool.service.on_grant = lambda worker, wid: injector.on_pull(
            pool.service.workers[worker].shard)
        batches = {pool.submit(np.stack(CHUNKS[2 * k:2 * k + 2])):
                   CHUNKS[2 * k:2 * k + 2] for k in range(3)}
        got = pool.wait(list(batches), timeout_s=300.0)
        assert sorted(got) == sorted(batches)
        assert injector.crashed == frozenset({0})
        assert pool.queue.redeliveries >= 1
        assert pool.queue.redelivered_from["shard0"] >= 1
        survivor = pool.pids
        assert list(survivor) == [1], "only shard1 survives"
        for wid, res in got.items():
            want = REF(np.stack(batches[wid]))
            np.testing.assert_array_equal(np.asarray(res.det.keep),
                                          np.asarray(want.det.keep))
            np.testing.assert_array_equal(res.cleaned, want.cleaned)
        wid = pool.submit(np.stack(CHUNKS[6:8]))            # wave 2
        res = pool.wait([wid], timeout_s=300.0)[wid]
        np.testing.assert_array_equal(res.cleaned,
                                      REF(np.stack(CHUNKS[6:8])).cleaned)
        assert pool.pids == survivor, "wave 2 ran on another process"
    finally:
        pool.shutdown(drain=True)
    (st,) = [s for s in pool.worker_stats if s.worker == "shard1"]
    assert st.state == "departed" and st.report["device"] == "cpu"
    assert st.chunks_done == 4


def test_pool_tcp_store_plane_two_waves(tmp_path, fresh_registry):
    """A pool of 2 worker processes over the tcp transport with the store
    data plane: request bytes and results move through the ChunkStore, so
    the pool's socket carries keys only; two waves on the same pids,
    bitwise equal to two_phase."""
    pool = WorkerPool(cfg, workers=2, transport="tcp", store=tmp_path / "dp",
                      poll_s=0.01, device="cpu").start()
    try:
        pids = None
        for wave in range(2):
            batches = {pool.submit(np.stack(CHUNKS[4 * wave + 2 * k:
                                                   4 * wave + 2 * k + 2])):
                       np.stack(CHUNKS[4 * wave + 2 * k:
                                       4 * wave + 2 * k + 2])
                       for k in range(2)}
            _assert_bitwise(pool.wait(list(batches), timeout_s=300.0),
                            batches)
            assert pids in (None, pool.pids), "wave 2 ran on other processes"
            pids = pool.pids
        assert sorted(pids) == [0, 1]
    finally:
        pool.shutdown(drain=True)
    raw = sum(c.nbytes for c in CHUNKS)
    for d in ("fetch", "push"):
        series = fresh_registry.snapshot()[f"dist_{d}_bytes_total"]["series"]
        moved = {s["labels"]["plane"]: s["value"] for s in series}
        assert moved.get("socket", 0) == 0
        assert 0 < moved["store"] < raw * 0.01
    assert all(s.state == "departed" and s.report["device"] == "cpu"
               for s in pool.worker_stats)


# ---------------------------------------------------------- launcher

def test_launch_serve_audio_on_cpu(capsys):
    from repro_torch.launch import serve
    lat = serve.main(["--audio", "--device", "cpu", "--pool-transport",
                      "inproc", "--clients", "2", "--requests", "1",
                      "--rate-hz", "1000", "--max-batch", "2",
                      "--poll-ms", "2"])
    out = capsys.readouterr().out
    assert "served 2/2 requests" in out and "on cpu" in out
    assert "latency p50" in out and len(lat) == 2


@pytest.mark.parametrize("argv,line", [
    (["--pool-min-workers", "1", "--pool-max-workers", "2"], "autoscale:"),
    (["--pool-speculate"], "served 2/2 requests"),
    (["--pool-store", "STORE"], "served 2/2 requests"),
], ids=["autoscale", "speculate", "store"])
def test_launch_serve_pool_options(argv, line, tmp_path, capsys):
    """The launcher's pool options reach the pool: autoscaling prints its
    ledger, and speculation and the store data plane serve every
    request."""
    from repro_torch.launch import serve
    argv = [str(tmp_path / "dp") if a == "STORE" else a for a in argv]
    lat = serve.main(["--audio", "--device", "cpu", "--pool-transport",
                      "inproc", "--pool-workers", "1", "--clients", "2",
                      "--requests", "1", "--rate-hz", "1000",
                      "--max-batch", "2", "--poll-ms", "2", *argv])
    out = capsys.readouterr().out
    assert line in out and len(lat) == 2 and all(ok for _, ok in lat)
    if "--pool-store" in argv:
        assert any((tmp_path / "dp").iterdir()), "nothing went to the store"


def test_launch_serve_runs_the_language_model_mode(capsys):
    """Without --audio the launcher serves a language model (here a reduced
    llama on the CPU)."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", "llama3.2-3b", "--reduced", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "4", "--gen",
                       "2", "--requests", "2"])
    out = capsys.readouterr().out
    assert sorted(done) == [0, 1]
    assert "served 2 requests, 4 tokens in" in out and "tok/s) on cpu" in out


@pytest.mark.parametrize("flag", [["--telemetry", "DIR"], ["--trace", "F"]])
def test_launch_serve_refuses_instrumentation_without_audio(flag, capsys):
    """--telemetry / --trace instrument the audio serving tier only, as in
    the reference."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--reduced", "--device", "cpu", *flag])
    assert e.value.code == 2
    assert "audio serving tier" in capsys.readouterr().err


def test_kernel_launch_counts_stay_exact_under_threads(monkeypatch):
    """The in-process pool launches from several threads: the launch count
    takes every accepted launch. The entry point and the stream are
    stand-ins here (no card); the counting is the wrapper's own."""
    import contextlib
    import types

    from repro_torch.kernels._build import CudaKernel
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    k = CudaKernel("fir", "stand_in", [])
    k._fn = lambda stream: 0              # cudaSuccess

    def launch():
        for _ in range(20_000):
            k(torch.device("cpu"))

    ts = [threading.Thread(target=launch) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert k.launches == 160_000


# ---------------------------------------------- against the JAX package

# batches the batcher forms from requests arriving 1, 2, 4 at a time,
# then one near-silent request alone (every chunk removed)
WAVES = [CHUNKS[:1], CHUNKS[1:3], CHUNKS[3:7], [QUIET]]


@pytest.fixture(scope="module")
def served():
    """The port's batcher over its in-process two_phase: each wave
    submitted together and pumped, the batch log and the records."""
    b = ContinuousBatcher(plan=REF, max_batch=4, linger_s=0.0,
                          clock=SettableClock())
    records = []
    for wave in WAVES:
        rids = [b.submit(c) for c in wave]
        b.pump()
        records.append([b.result(r) for r in rids])
    return list(b.batch_log), records


@pytest.fixture(scope="module")
def jax_batches(served):
    log, _ = served
    with backend.use("ref"):
        pre = JPreprocessor(JCFG, plan="two_phase")
        return [pre(padded(wave, e["rows"])) for wave, e in zip(WAVES, log)]


def test_serving_batches_match_the_reference(served, jax_batches):
    log, records = served
    assert [e["rows"] for e in log] == [1, 2, 4, 1]
    assert [e["n_real"] for e in log] == [1, 2, 4, 1]
    for wave, e, recs, want in zip(WAVES, log, records, jax_batches):
        assert all(r["ok"] for r in recs)
        _assert_records(recs, sliced(want, len(wave), e["rows"]),
                        exact=False)
    quiet = records[-1][0]
    assert not quiet["keep"].any() and quiet["cleaned"].shape[0] == 0
    assert int(np.asarray(jax_batches[-1].det.keep).sum()) == 0


def test_serving_masks_match_the_reference(served, jax_batches):
    log, records = served
    for wave, e, recs, want in zip(WAVES, log, records, jax_batches):
        per = np.asarray(want.det.keep).size // e["rows"]
        for j, r in enumerate(recs):
            for m in ("keep", "rain", "silence"):
                np.testing.assert_array_equal(
                    r[m], np.asarray(getattr(want.det, m))[
                        j * per:(j + 1) * per], m)


def test_pool_serves_the_reference_batches(served, jax_batches):
    """The same batches through an in-process pool (the dispatch path a
    server runs) against the reference."""
    log, _ = served
    with WorkerPool(cfg, workers=2, transport="inproc", poll_s=0.002,
                    device="cpu") as pool:
        wids = [pool.submit(padded(w, e["rows"]))
                for w, e in zip(WAVES, log)]
        got = pool.wait(wids, timeout_s=300.0)
    for wid, wave, e, want in zip(wids, WAVES, log, jax_batches):
        res = got[wid]
        np.testing.assert_array_equal(np.asarray(res.det.keep),
                                      np.asarray(want.det.keep))
        assert res.n_kept == int(np.asarray(want.det.keep).sum())
        np.testing.assert_allclose(res.cleaned, np.asarray(want.cleaned),
                                   rtol=2e-4, atol=2e-4)
