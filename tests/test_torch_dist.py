"""The port's master/worker runtime on the CPU: the QueueService's RPC
surface, registry, membership, speculation, metrics and store data plane;
the worker runtime driven in-process over `InProcTransport`; real worker
processes over the proc and tcp transports (spawned with one intra-op
thread each, every run bounded by the plan's `stall_timeout_s`), bitwise
equal to the port's two_phase per work id and in the same emission order;
SIGKILLed workers redelivered exactly once over the socket and the store
planes; a worker told to run on a card this machine does not have; the
authkey kept out of argv and error text; and a payload pushed by a port
worker through the store plane read by the JAX package's `unpack_result`.
"""
import collections
import multiprocessing
import random
import threading
import time

import numpy as np
import pytest

from repro_torch.configs import SERF_AUDIO as cfg
from repro_torch.core.plans import Preprocessor
from repro_torch.data.loader import audio_batch_maker, make_shard_pool
from repro_torch.data.queue import SettableClock, WorkQueue
from repro_torch.dist import (InProcTransport, QueueService, RemoteError,
                              StoreDataPlane, TcpTransport, pack_result)
from repro_torch.dist.data_plane import result_key
from repro_torch.dist.service import RPC_METHODS, WORKER_STATES
from repro_torch.dist.worker import run_worker
from repro_torch.ft.failure import CrashInjector, StragglerDetector
from repro_torch.obs import metrics as obs_metrics

# every proc run of this file: a stall bound that fails a test instead of
# hanging the run
PROC_KW = {"stall_timeout_s": 120.0, "device": "cpu"}
SETUP = {"cfg": cfg, "stages": None, "source_channels": 2,
         "pad_multiple": 1, "bucket": "linear", "device": "cpu"}


@pytest.fixture
def fresh_registry():
    """An isolated metrics registry for the test; the process's own is
    restored afterwards."""
    prev = obs_metrics.get_registry()
    reg = obs_metrics.MetricsRegistry()
    obs_metrics.set_registry(reg)
    yield reg
    obs_metrics.set_registry(prev)


def total(reg, name, **labels):
    """The sum of a registry counter's series whose labels match."""
    m = reg.snapshot().get(name, {"series": []})
    return sum(s["value"] for s in m["series"]
               if all(s["labels"][k] == v for k, v in labels.items()))


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Spawned workers inherit the environment: one intra-op thread each
    (the suite runs beside other test processes)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _stream(n_batches=3, seed=21):
    make = audio_batch_maker(seed=seed, batch_long_chunks=1)
    return [(w, (make(w)[0], None)) for w in range(n_batches)]


def _two_phase(stream):
    pre = Preprocessor(cfg, device="cpu")
    return {w: pre(c) for w, (c, _) in stream}


def _assert_bitwise(got, want):
    for m in ("keep", "rain", "silence", "cicada15"):
        np.testing.assert_array_equal(np.asarray(getattr(got.det, m)),
                                      np.asarray(getattr(want.det, m)), m)
    np.testing.assert_array_equal(got.cleaned, want.cleaned)
    assert got.n_kept == want.n_kept and got.src_bytes == want.src_bytes


# ------------------------------------------------- queue under threads

def test_workqueue_thread_hammer_no_lost_or_dup():
    """8 threads lease / complete / fail against one queue with a 20 ms
    lease, so expiry reaps race live completes: every id retired exactly
    once."""
    n = 400
    q = WorkQueue(n, lease_timeout_s=0.02)
    retired = collections.Counter()
    lock = threading.Lock()
    errors = []

    def worker(tid):
        rng = random.Random(1000 + tid)
        name = f"w{tid}"
        try:
            while not q.finished:
                ids = q.lease(name, rng.randint(1, 4))
                if not ids:
                    time.sleep(0.001)
                    continue
                if rng.random() < 0.2:
                    time.sleep(0.03)      # blow the deadline
                if rng.random() < 0.05:
                    q.fail_worker(name)
                newly = q.complete(ids)
                with lock:
                    retired.update(newly)
        except Exception as e:            # pragma: no cover - must not fire
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert q.finished
    assert sorted(retired) == list(range(n))
    assert max(retired.values()) == 1
    assert q.redeliveries >= 1
    assert sum(q.redelivered_from.values()) == q.redeliveries


# --------------------------------------------------- service + registry

def test_queue_service_ledger_grant_hook_and_counters(fresh_registry):
    q = WorkQueue(4, lease_timeout_s=60.0)
    svc = QueueService(q)
    granted = []
    svc.on_grant = lambda worker, wid: granted.append((worker, wid))
    assert svc.hello("shard0", pid=123, shard=0) == {}
    assert svc.lease("shard0", 3) == [0, 1, 2]
    assert granted == [("shard0", 0), ("shard0", 1), ("shard0", 2)]
    assert svc.complete([0]) == [0]
    assert svc.complete([0]) == []          # the exactly-once gate
    svc.push_result("shard0", 1, {"x": np.zeros(4, np.float32)})
    (got,) = svc.pop_results()
    assert got[:2] == ("shard0", 1) and svc.pop_results() == []
    assert not svc.finished and svc.progress() == (1, 4)
    (st,) = svc.worker_report()
    assert (st.pid, st.shard) == (123, 0)
    assert st.lease_calls == 1 and st.leased_total == 3
    assert st.chunks_done == 0              # a push is not credit
    svc.note_done("shard0")
    assert svc.worker_report()[0].chunks_done == 1
    assert st.leases_held == 2 and st.last_beat_age_s is not None
    reg = fresh_registry            # under the reference's names
    assert total(reg, "dist_lease_calls_total") == svc.lease_calls == 1
    assert total(reg, "dist_leased_ids_total", worker="shard0") == 3
    assert total(reg, "dist_pushes_total") == 1
    assert total(reg, "dist_push_bytes_total", plane="socket") == 16
    assert total(reg, "dist_chunks_done_total") == 1
    m = svc.metrics()
    workers = {s["labels"]["state"]: s["value"]
               for s in m["dist_workers"]["series"]}
    assert workers == {"active": 1, "draining": 0, "departed": 0,
                       "dead": 0}
    assert set(workers) == set(WORKER_STATES)
    report = {"idle_s": 1.5, "busy_s": 2.5, "chunks": 1,
              "launches": {"fir_hpf": 3}}
    svc.bye("shard0", report)
    st = svc.workers["shard0"]
    assert st.report == report and (st.idle_s, st.busy_s) == (1.5, 2.5)
    assert st.state == "departed"


def test_inproc_transport_serves_only_the_rpc_surface(fresh_registry):
    svc = QueueService(WorkQueue(2))
    proxy = InProcTransport().connect(svc)
    assert proxy.call("lease", "w", 1) == [0]
    assert proxy.call("finished") is False  # a property, dispatched plainly
    assert proxy.call("complete", [0]) == [0]
    assert proxy.call("metrics")["dist_leased_ids_total"]["series"][0][
        "value"] == 1
    for method in ("pop_results", "worker_report", "queue", "on_grant",
                   "reserve", "resolve_result"):
        assert method not in RPC_METHODS
        with pytest.raises(RemoteError):
            proxy.call(method)


def test_registry_assigns_reserved_then_sequential():
    """`hello(None, pid, -1)` announces: the shard reserved for that pid,
    else the next free id; explicit identities keep the counter ahead."""
    svc = QueueService(WorkQueue(8, lease_timeout_s=60.0),
                       setup={"pad_multiple": 2})
    svc.reserve(111, 3)
    spec = svc.hello(None, pid=111, shard=-1)
    assert spec["assigned"] == {"worker": "shard3", "shard": 3}
    assert spec["pad_multiple"] == 2
    a = svc.hello(None, pid=222, shard=-1)["assigned"]
    b = svc.hello(None, pid=333, shard=-1)["assigned"]
    assert (a["shard"], b["shard"]) == (4, 5)
    assert {st.worker: st.shard for st in svc.worker_report()} == {
        "shard3": 3, "shard4": 4, "shard5": 5}
    svc.hello("shard9", pid=444, shard=9)
    assert svc.hello(None, pid=555, shard=-1)["assigned"]["shard"] == 10


def test_queue_service_membership_registry(fresh_registry):
    svc = QueueService(WorkQueue(4, lease_timeout_s=60.0,
                                 clock=SettableClock()))
    svc.hello("shard0", pid=1, shard=0)
    svc.hello("shard1", pid=2, shard=1)
    e0 = svc.epoch
    assert e0 >= 2 and svc.active_workers() == ["shard0", "shard1"]
    svc.hello("shard0", pid=1, shard=0)     # re-hello while active
    assert svc.epoch == e0
    assert svc.drain("shard1") is True
    assert svc.draining("shard1") and svc.epoch == e0 + 1
    assert svc.lease("shard1", 4) == []     # draining workers take no work
    assert svc.lease("shard0", 1) == [0]
    svc.bye("shard1")
    assert svc.workers["shard1"].state == "departed"
    assert svc.draining("shard1")
    svc.hello("shard1", pid=3, shard=1)     # rejoin: a fresh incarnation
    assert svc.workers["shard1"].state == "active"
    assert svc.lease("shard1", 1) == [1]
    svc.fail_worker("shard0")
    assert svc.workers["shard0"].state == "dead"
    assert svc.active_workers() == ["shard1"]
    assert svc.epoch > e0 + 1
    assert [total(fresh_registry, f"dist_workers_{k}_total")
            for k in ("joined", "drained", "left")] == [3, 1, 1]


def test_work_queue_speculate_refusals_and_grant():
    q = WorkQueue(3, lease_timeout_s=10.0, clock=SettableClock())
    assert not q.speculate("w2", 0)         # not leased yet
    assert q.lease("w1", 2) == [0, 1]
    assert not q.speculate("w1", 0)         # no self-speculation
    assert q.speculate("w2", 0)
    assert not q.speculate("w3", 0)         # one backup per id
    assert q.speculated() == [0] and q.leases_held("w2") == [0]
    q.complete([1])
    assert not q.speculate("w2", 1)         # done ids are never duplicated
    assert q.speculations == 1


def test_queue_service_grants_speculative_lease_to_idle_worker(
        fresh_registry):
    """An active worker whose normal lease comes back empty gets a
    duplicate of the slowest flagged in-flight id; a draining one never."""
    clock = SettableClock()
    q = WorkQueue(3, lease_timeout_s=60.0, clock=clock)
    svc = QueueService(q, straggler=StragglerDetector(
        factor=2.0, min_history=2, clock=clock))
    for wid in (0, 1):
        assert svc.lease("w1", 1) == [wid]
        clock.t += 1.0
        assert svc.complete([wid], worker="w1") == [wid]
    assert svc.lease("w1", 1) == [2]
    clock.t += 10.0
    assert svc.lease("w2", 1) == [2]        # speculated
    assert q.speculated() == [2]
    svc.drain("w2")
    assert svc.lease("w2", 1) == []
    assert svc.complete([2], worker="w2") == [2]
    assert q.speculations == 1 and q.speculations_lost == 1
    assert q.finished
    assert total(fresh_registry, "dist_speculations_total") == 1
    assert total(fresh_registry, "dist_redeliveries_total",
                 reason="speculated") == 1


# ------------------------------------------------- store data plane unit

def test_lease_chunks_grants_keys_and_reoffers_cached(tmp_path,
                                                      fresh_registry):
    chunks = {w: np.full((1, 2, 16), w, np.float32) for w in range(2)}
    plane = StoreDataPlane(tmp_path / "dp")
    svc = QueueService(WorkQueue(2, lease_timeout_s=60.0),
                       fetch_item=lambda wid: chunks[wid], data_plane=plane)
    keys = dict(svc.lease_chunks("a", 2))
    assert sorted(keys) == [0, 1]
    assert all(k.startswith("raw-") for k in keys.values())
    assert plane.store.stats.writes == 2
    svc.fail_worker("a")
    assert dict(svc.lease_chunks("b", 2)) == keys     # the cached offer
    assert plane.store.stats.writes == 2
    assert plane.store.stats.dup_writes == 0
    assert total(fresh_registry, "dist_fetch_bytes_total",
                 plane="store") == sum(len(k) for k in keys.values()) * 2


def test_lease_chunks_retired_item_and_missing_plane(tmp_path):
    svc = QueueService(
        WorkQueue(2, lease_timeout_s=60.0),
        data_plane=StoreDataPlane(tmp_path / "dp"),
        fetch_item=lambda wid: None if wid == 0
        else np.ones((1, 2, 8), np.float32))
    pairs = svc.lease_chunks("w", 2)
    assert pairs[0] == [0, None]
    assert pairs[1][0] == 1 and pairs[1][1].startswith("raw-")
    bare = QueueService(WorkQueue(1), fetch_item=lambda wid: None)
    with pytest.raises(RuntimeError, match="store data plane"):
        bare.lease_chunks("w", 1)
    with pytest.raises(RuntimeError, match="no fetch_item"):
        QueueService(WorkQueue(1)).fetch(0)


def test_fetch_many_is_one_pass_one_heartbeat(fresh_registry):
    svc = QueueService(WorkQueue(3, lease_timeout_s=60.0),
                       fetch_item=lambda wid: np.full((1, 2, 4), wid,
                                                      np.float32))
    ids = svc.lease("w", 3)
    beats = []
    orig = svc.heartbeat
    svc.heartbeat = lambda w: beats.append(w) or orig(w)
    items = svc.fetch_many("w", ids)
    assert beats == ["w"]
    for wid, item in zip(ids, items):
        np.testing.assert_array_equal(item, np.full((1, 2, 4), wid,
                                                    np.float32))
    assert total(fresh_registry, "dist_fetch_bytes_total",
                 plane="socket") == 3 * items[0].nbytes


def test_store_plane_pushed_but_unacked_redelivers_exactly_once(tmp_path):
    """A worker writes its result to the store and dies before its push:
    the id redelivers under the same key, the second write loses
    first-write-wins, and the master accepts once, the first bytes."""
    q = WorkQueue(1, lease_timeout_s=60.0)
    plane = StoreDataPlane(tmp_path / "dp")
    svc = QueueService(q, fetch_item=lambda wid: np.ones((1, 2, 8),
                                                         np.float32),
                       data_plane=plane)
    ((wid, key),) = svc.lease_chunks("a", 1)
    plane.push(key, {"ans": np.arange(4, dtype=np.float32), "mark": 1})
    svc.fail_worker("a")
    assert q.redeliveries == 1
    assert svc.lease_chunks("b", 1) == [[wid, key]]
    ref = plane.push(key, {"ans": np.arange(4, dtype=np.float32),
                           "mark": 2})
    assert ref == {"store_key": result_key(key)}
    assert plane.store.stats.dup_writes >= 1
    svc.push_result("b", wid, ref)
    ((_, got_wid, got_ref),) = svc.pop_results()
    assert svc.complete([got_wid]) == [wid]
    assert svc.complete([got_wid]) == []
    full = svc.resolve_result(got_ref)
    assert full["mark"] == 1
    np.testing.assert_array_equal(full["ans"],
                                  np.arange(4, dtype=np.float32))


# ----------------------------------------------- worker runtime in-process

def test_worker_runtime_inproc_round_trip():
    """The worker loop (lease -> fetch -> two_phase -> push) in-process:
    its payloads equal two_phase's bitwise, in one lease round-trip."""
    stream = _stream(2, seed=9)
    chunks = {w: c for w, (c, _) in stream}
    q = WorkQueue(2, lease_timeout_s=60.0)
    svc = QueueService(q, fetch_item=chunks.__getitem__, setup=SETUP)
    stats = run_worker(svc, shard=0, lease_items=2,
                       transport=InProcTransport(), max_items=2)
    assert stats["chunks"] == 2 and stats["device"] == "cpu"
    assert not any(stats["launches"].values())     # CPU: no kernel
    assert stats["cuda_reserved_bytes"] == 0       # nor card memory
    got = {wid: payload for _, wid, payload in svc.pop_results()}
    assert q.complete(sorted(got)) == [0, 1]
    want = _two_phase(stream)
    for wid, payload in got.items():
        np.testing.assert_array_equal(payload["keep"],
                                      want[wid].det.keep.numpy())
        np.testing.assert_array_equal(payload["cleaned"], want[wid].cleaned)
        assert payload["n_kept"] == want[wid].n_kept
        assert all(isinstance(v, (np.ndarray, int, float, dict))
                   for v in payload.values())      # numpy and plain Python
    (st,) = svc.worker_report()
    assert st.lease_calls == 1 and st.report["chunks"] == 2


def test_worker_skips_stale_fetch():
    make = audio_batch_maker(seed=9, batch_long_chunks=1)
    svc = QueueService(
        WorkQueue(2, lease_timeout_s=60.0), setup=SETUP,
        fetch_item=lambda wid: None if wid == 0 else make(wid)[0])
    stats = run_worker(svc, shard=0, lease_items=2,
                       transport=InProcTransport(), max_items=1)
    assert stats["chunks"] == 1
    assert [wid for _, wid, _ in svc.pop_results()] == [1]


def test_store_plane_inproc_worker_round_trip(tmp_path, fresh_registry):
    """Over the store plane the socket carries no payload bytes: keys out,
    refs back, and the resolved payloads equal two_phase's bitwise."""
    stream = _stream(2, seed=9)
    chunks = {w: c for w, (c, _) in stream}
    q = WorkQueue(2, lease_timeout_s=60.0)
    plane = StoreDataPlane(tmp_path / "dp")
    svc = QueueService(q, fetch_item=chunks.__getitem__, setup=SETUP,
                       data_plane=plane)
    stats = run_worker(svc, shard=None, lease_items=2,
                       transport=InProcTransport(), max_items=2)
    assert stats["chunks"] == 2
    got = {}
    for _, wid, payload in svc.pop_results():
        assert set(payload) == {"store_key"}
        assert payload["store_key"].startswith("res-")
        got[wid] = svc.resolve_result(payload)
    assert q.complete(sorted(got)) == [0, 1]
    want = _two_phase(stream)
    for wid, payload in got.items():
        np.testing.assert_array_equal(payload["cleaned"], want[wid].cleaned)
    assert len(plane.store) == 4
    raw = sum(v.nbytes for v in chunks.values())
    moved = {(d, p): total(fresh_registry, f"dist_{d}_bytes_total", plane=p)
             for d in ("fetch", "push") for p in ("socket", "store")}
    assert moved["fetch", "socket"] == 0 and moved["push", "socket"] == 0
    assert 0 < moved["fetch", "store"] < raw * 0.1
    assert 0 < moved["push", "store"] < raw * 0.1


def test_worker_drain_and_late_join_inproc():
    """A drained worker finishes what it holds and exits through bye; a
    late joiner finishes the stream; every id accepted exactly once."""
    n = 4
    make = audio_batch_maker(seed=9, batch_long_chunks=1)
    hold = threading.Event()

    def fetch(wid):
        if wid >= 2:
            hold.wait(120.0)     # the tail waits until the drain is issued
        return make(wid)[0]

    q = WorkQueue(n, lease_timeout_s=120.0)
    svc = QueueService(q, fetch_item=fetch, setup=SETUP)
    accepted = []

    def accept_all():
        while not q.finished:
            for worker, wid, _ in svc.pop_results():
                if svc.complete([wid], worker=worker):
                    svc.note_done(worker, wid=wid)
                    accepted.append(wid)
            time.sleep(0.002)

    acceptor = threading.Thread(target=accept_all, daemon=True)
    acceptor.start()
    stats0 = {}
    t0 = threading.Thread(target=lambda: stats0.update(run_worker(
        svc, shard=0, lease_items=1, poll_s=0.005,
        transport=InProcTransport())), daemon=True)
    t0.start()
    deadline = time.monotonic() + 120.0
    while not accepted and time.monotonic() < deadline:
        time.sleep(0.005)
    assert accepted, "shard0 made no progress"
    svc.drain("shard0")
    hold.set()
    t0.join(120.0)
    assert not t0.is_alive(), "a drained worker must exit"
    assert svc.workers["shard0"].state == "departed"
    assert not q.finished
    stats1 = run_worker(svc, shard=1, lease_items=1, poll_s=0.005,
                        transport=InProcTransport())
    acceptor.join(60.0)
    assert q.finished and sorted(accepted) == list(range(n))
    assert 0 < stats0["chunks"] < n and stats1["chunks"] >= 1
    assert svc.workers["shard1"].state == "departed"
    assert q.redeliveries == 0


# ------------------------------------------------- real worker processes

@pytest.mark.parametrize("transport,shards", [("proc", 1), ("proc", 2),
                                              ("tcp", 2)])
def test_process_transport_bitwise_equal_to_two_phase(transport, shards,
                                                      tmp_path,
                                                      fresh_registry):
    """Real worker processes run two_phase on the same device: per work
    id bitwise equal to the port's two_phase, emitted in ascending order;
    the tcp run moves its bytes through the store plane."""
    stream = _stream(3)
    kw = {"data_plane": str(tmp_path / "dp")} if transport == "tcp" else {}
    pre = Preprocessor(cfg, plan="sharded", shards=shards,
                       transport=transport, **PROC_KW, **kw)
    got = list(pre.run(stream))
    assert [r.wid for r in got] == [0, 1, 2]
    want = _two_phase(stream)
    for r in got:
        _assert_bitwise(r, want[r.wid])
    plan = pre.plan
    assert plan.redeliveries == 0 and plan.fleet_start_s > 0
    assert sorted(st.worker for st in plan.worker_stats) == \
        [f"shard{k}" for k in range(shards)]
    assert sum(st.chunks_done for st in plan.worker_stats) == 3
    for st in plan.worker_stats:
        assert st.state == "departed" and st.report["device"] == "cpu"
        assert st.pid != multiprocessing.current_process().pid
    plane = "store" if transport == "tcp" else "socket"
    other = "socket" if transport == "tcp" else "store"
    for d in ("fetch", "push"):
        name = f"dist_{d}_bytes_total"
        assert total(fresh_registry, name, plane=plane) > 0
        assert total(fresh_registry, name, plane=other) == 0


@pytest.mark.parametrize("plane", ["socket", "store"])
def test_sigkilled_worker_redelivered_exactly_once(plane, tmp_path):
    """Shard 1 is SIGKILLed at its first grant, holding the lease: every
    id is still emitted once, bitwise equal to two_phase, and the lease
    was redelivered."""
    make = audio_batch_maker(seed=5, batch_long_chunks=1)
    pool = make_shard_pool(make, 3, 2, lease_timeout_s=120.0)
    inj = CrashInjector()
    inj.kill(1, after_items=0)
    kw = ({"transport": "tcp", "data_plane": str(tmp_path / "dp")}
          if plane == "store" else {"transport": "proc"})
    pre = Preprocessor(cfg, plan="sharded", shards=2, injector=inj,
                       **PROC_KW, **kw)
    results = list(pre.run(pool))
    assert [r.wid for r in results] == [0, 1, 2]
    assert pre.plan.redeliveries == 1 and not inj.alive(1)
    ref = Preprocessor(cfg, device="cpu")
    for r in results:
        _assert_bitwise(r, ref(make(r.wid)[0]))
    dead = [st for st in pre.plan.worker_stats if st.worker == "shard1"]
    assert dead and dead[0].state == "dead" and dead[0].redeliveries >= 1


def test_fleet_late_joiner_and_drain_over_processes(fresh_registry):
    """`plan.fleet` mid-run: a late joiner spawned after the first result
    hellos into the run in progress, the original worker is drained out
    (it finishes what it holds and leaves through bye), and the joiner
    finishes the stream; every id once, bitwise equal to two_phase, no
    lease reclaimed."""
    stream = _stream(4)
    pre = Preprocessor(cfg, plan="sharded", shards=1, transport="proc",
                       **PROC_KW)
    got = []
    for r in pre.run(stream):
        got.append(r)
        if len(got) == 1:
            fleet = pre.plan.fleet
            assert sorted(fleet.live()) == [0]
            assert fleet.spawn().worker == "shard1"
            fleet.drain(0)
    assert [r.wid for r in got] == [0, 1, 2, 3]
    want = _two_phase(stream)
    for r in got:
        _assert_bitwise(r, want[r.wid])
    st = {s.worker: s for s in pre.plan.worker_stats}
    assert st["shard0"].state == st["shard1"].state == "departed"
    assert st["shard1"].chunks_done >= 1
    assert st["shard0"].chunks_done + st["shard1"].chunks_done == 4
    assert pre.plan.redeliveries == 0
    assert total(fresh_registry, "dist_workers_drained_total") == 1


def test_worker_told_cuda_without_a_card_fails_the_run():
    """The setup blob names "cuda" on this CPU-only machine: the workers
    raise rather than run the plain versions, and the master reports that
    every worker exited."""
    pre = Preprocessor(cfg, plan="sharded", shards=1, transport="proc",
                       **PROC_KW)
    blob = pre.plan._proc_setup()
    assert blob["device"] == "cpu"
    pre.plan._proc_setup = lambda: {**blob, "device": "cuda"}
    with pytest.raises(RuntimeError, match="every worker process exited"):
        list(pre.run(_stream(1)))
    (st,) = pre.plan.worker_stats
    assert st.report is None and st.chunks_done == 0


def test_workers_pinned_one_card_each_with_several(monkeypatch):
    """With more than one card visible, shard k's worker sees only card
    k mod count of this process's visible set; with one card (or on the
    CPU) the environment is left as it is."""
    import torch
    from repro_torch.device import worker_env
    assert worker_env(torch.device("cpu"), 1) == {}
    card = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert worker_env(card, 1) == {}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    assert [worker_env(card, k) for k in range(3)] == [
        {"CUDA_VISIBLE_DEVICES": v} for v in ("5", "7", "5")]
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert worker_env(card, 3) == {"CUDA_VISIBLE_DEVICES": "1"}


def test_authkey_env_only_never_argv_never_error_text():
    """The authkey reaches workers through REPRO_DIST_AUTHKEY only: never
    argv, never the text of a RemoteError; the spawned argv names the
    port's worker module and no shard."""
    tp = TcpTransport()
    svc = QueueService(WorkQueue(1, lease_timeout_s=60.0), setup={})
    addr = tp.serve(svc)
    try:
        key = tp._authkey
        assert key and key not in addr
        h = tp.spawn_worker(shard=0)
        argv = " ".join(map(str, h.proc.args))
        h.kill()
        assert key not in argv and "--shard" not in argv
        assert "repro_torch.dist.worker" in argv
        proxy = tp.connect(addr, authkey=key)
        with pytest.raises(RemoteError) as not_served:
            proxy.call("pop_results")
        assert key not in str(not_served.value)
        with pytest.raises(RemoteError) as raised:
            proxy.call("lease_chunks", "w", 1)
        assert "RuntimeError" in str(raised.value)
        assert key not in str(raised.value)
        proxy.close()
        h.proc.wait(10)
    finally:
        tp.close()


def test_wrong_authkey_rejected_no_handler_thread_leak():
    tp = TcpTransport()
    addr = tp.serve(QueueService(WorkQueue(1, lease_timeout_s=60.0)))
    try:
        host, _, port = addr.rpartition(":")
        n_before = sum(t.name == "repro-dist-conn"
                       for t in threading.enumerate())
        from multiprocessing.connection import Client
        with pytest.raises(multiprocessing.AuthenticationError):
            Client((host, int(port)), authkey=b"not-the-key")
        time.sleep(0.2)
        assert sum(t.name == "repro-dist-conn"
                   for t in threading.enumerate()) <= n_before
        proxy = tp.connect(addr)
        assert tuple(proxy.call("progress")) == (0, 1)
        proxy.close()
    finally:
        tp.close()


# ----------------------------------------- read by the JAX package's codec

def test_port_worker_store_payload_read_by_the_reference(tmp_path):
    """A result a port worker pushed through the store plane is read by
    the reference's StoreDataPlane and `unpack_result`: the payload and the
    store layout are byte-compatible across frameworks."""
    pytest.importorskip("jax")
    from repro.dist.data_plane import StoreDataPlane as JPlane
    from repro.dist.service import unpack_result as j_unpack

    stream = _stream(1, seed=9)
    chunks = stream[0][1][0]
    plane = StoreDataPlane(tmp_path / "dp")
    svc = QueueService(WorkQueue(1, lease_timeout_s=60.0),
                       fetch_item=lambda wid: chunks, setup=SETUP,
                       data_plane=plane)
    run_worker(svc, shard=0, transport=InProcTransport(), max_items=1)
    ((_, wid, ref),) = svc.pop_results()
    payload = JPlane(str(tmp_path / "dp")).take(ref["store_key"])
    det, f = j_unpack(payload)
    want = _two_phase(stream)[0]
    np.testing.assert_array_equal(np.asarray(det.keep),
                                  want.det.keep.numpy())
    np.testing.assert_array_equal(f["cleaned"], want.cleaned)
    assert f["n_kept"] == want.n_kept and f["src_bytes"] == want.src_bytes
    assert pack_result(want)["wave_width"] == det.wave5.shape[-1]


# ------------------------------------------------------------ launcher

def test_launcher_sharded_proc_same_kept_counts(capsys):
    """`--plan sharded --transport proc --shards 2 --lease-items 2` keeps
    what `--plan two_phase` keeps, and prints one line per worker."""
    from repro_torch.launch import preprocess
    base = ["--minutes", "3", "--batch-long-chunks", "1", "--device", "cpu"]
    kept = preprocess.main(base)
    first = capsys.readouterr().out
    got = preprocess.main([*base, "--plan", "sharded", "--transport", "proc",
                           "--shards", "2", "--lease-items", "2"])
    out = capsys.readouterr().out
    assert got == kept > 0
    line = next(s for s in first.splitlines() if s.startswith("chunks kept"))
    assert line in out
    assert "shards=2 transport=proc lease_items=2 redeliveries=0" in out
    assert "last-round survivor re-shard:" in out
    workers = [s for s in out.splitlines() if s.startswith("worker shard")]
    assert len(workers) == 2
    assert all("[departed]" in s and "idle" in s for s in workers)


@pytest.mark.parametrize("argv", [
    ["--transport", "proc"], ["--lease-items", "2"], ["--no-speculate"],
    ["--data-plane-store", "/nonexistent"],
    ["--plan", "sharded", "--data-plane-store", "/nonexistent"],
    ["--plan", "sharded", "--bucket", "pow2"]])
def test_launcher_refuses_sharded_options_without_their_plan(argv):
    from repro_torch.launch import preprocess
    with pytest.raises(SystemExit):
        preprocess.main(["--device", "cpu", *argv])
