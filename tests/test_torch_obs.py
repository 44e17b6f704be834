"""The port's observability (`repro_torch.obs`) on the CPU: the cases of
the reference's `tests/test_obs.py` against the port's metrics registry,
tracer, Chrome-trace schema gate and durable telemetry, the sharded
plan's exactly-once telemetry (in process and over real worker processes,
whose spans arrive parented under the master's run span), SIGKILL
redelivery attribution, the ring caps, the StoreStats mirror and the
`metrics` RPC.

Then the same inputs through both frameworks: the reference's
`validate_chrome_trace` takes the port's trace and its `read_records` /
`worker_ledger` read the port's telemetry to the same ledger; one seeded
stream through `CachedPlan` around the in-process sharded plan, cold then
warm, leaves the same `plan_*`, `store_*` and `dist_*` metric names and
counter values in both registries (the JAX package in backend mode "ref";
stage timings excepted); a port `QueueService`'s `metrics` RPC has the
reference's shape; a telemetry record built from a result holding tensors
is byte for byte the reference's. Last, the hooks change nothing: plans
run bitwise equal with metrics, tracing and telemetry on and off.

Spawned workers get one intra-op thread each and every process run is
bounded by the plan's `stall_timeout_s`.
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import SERF_AUDIO as JCFG  # noqa: E402
from repro.core.plans import Preprocessor as JPreprocessor  # noqa: E402
from repro.kernels import backend  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import telemetry as jtelemetry  # noqa: E402
from repro.obs import tracing as jtracing  # noqa: E402

from repro_torch.configs import SERF_AUDIO as cfg  # noqa: E402
from repro_torch.core.plans import TIMINGS_CAP, BatchResult, Preprocessor
from repro_torch.data.loader import audio_batch_maker, make_shard_pool
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.metrics import (NULL_INSTRUMENT, MetricsRegistry,
                                     NullRegistry)
from repro_torch.obs.tracing import NULL_TRACER, Tracer, validate_chrome_trace
from repro_torch.serve.batcher import BATCH_LOG_CAP, ContinuousBatcher
from repro_torch.store.chunk_store import StoreStats

PROC_KW = {"stall_timeout_s": 120.0, "device": "cpu"}


@pytest.fixture
def fresh_registry():
    """Swap in an isolated registry; restore the process's afterwards."""
    prev = obs_metrics.get_registry()
    reg = MetricsRegistry()
    obs_metrics.set_registry(reg)
    yield reg
    obs_metrics.set_registry(prev)


@pytest.fixture
def fresh_tracer():
    """A tracer with an open run span, installed for the test."""
    t = Tracer()
    obs_tracing.set_tracer(t)
    t.start_run("run")
    yield t
    obs_tracing.set_tracer(None)


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _stream(n_batches, seed=21, batch_long_chunks=1):
    make = audio_batch_maker(seed=seed, batch_long_chunks=batch_long_chunks)
    return [(w, (make(w)[0], None)) for w in range(n_batches)]


# ------------------------------------------------------------- metrics

def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("c_total", "help")
    c.inc()
    c.inc(3)
    assert c.value == 4
    with pytest.raises(ValueError):
        c.inc(-1)                      # counters are monotonic
    g = reg.gauge("g")
    g.set(5)
    g.dec(2)
    assert g.value == 3
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 7.0):
        h.observe(v)
    (series,) = reg.snapshot()["h_seconds"]["series"]
    assert series["count"] == 3 and series["sum"] == pytest.approx(7.55)
    assert series["buckets"]["0.1"] == 1        # cumulative
    assert series["buckets"]["1.0"] == 2
    assert series["buckets"]["+Inf"] == 3


def test_labeled_series_and_kind_mismatch():
    reg = MetricsRegistry()
    c = reg.counter("rpc_total", labels=("method",))
    c.labels(method="lease").inc(2)
    c.labels(method="fetch").inc()
    snap = reg.snapshot()["rpc_total"]
    got = {tuple(s["labels"].items()): s["value"] for s in snap["series"]}
    assert got == {(("method", "lease"),): 2, (("method", "fetch"),): 1}
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("rpc_total")


def test_render_prometheus_text():
    reg = MetricsRegistry()
    reg.counter("x_total", "things", ("kind",)).labels(kind="a").inc(2)
    reg.histogram("d_seconds", buckets=(1.0,)).observe(0.5)
    text = reg.render()
    assert "# TYPE x_total counter" in text
    assert 'x_total{kind="a"} 2' in text
    assert 'd_seconds_bucket{le="1.0"} 1' in text
    assert "d_seconds_count 1" in text


def test_disabled_registry_is_null_and_mutation_gated():
    null = NullRegistry()
    assert null.counter("a") is NULL_INSTRUMENT
    assert null.snapshot() == {}
    reg = MetricsRegistry()
    c = reg.counter("a_total")
    reg.enabled = False                # toggled mid-run: live instruments
    c.inc(100)                         # stop mutating too
    reg.enabled = True
    assert c.value == 0


def test_module_level_instruments_respect_enabled(fresh_registry):
    obs_metrics.counter("m_total").inc()
    assert obs_metrics.snapshot()["m_total"]["series"][0]["value"] == 1
    fresh_registry.enabled = False
    assert obs_metrics.counter("m_total") is NULL_INSTRUMENT


# ------------------------------------------------------------- tracing

def test_tracer_spans_nest_and_validate():
    t = Tracer()
    t.start_run("run")
    with t.span("outer", wid=1):
        with t.span("inner"):
            t.instant("mark", x=2)
    t.complete("work", start_s=1.0, end_s=2.0)
    t.async_begin("request", 7)
    t.async_end("request", 7)
    t.finish_run()
    data = t.chrome()
    assert validate_chrome_trace(data) == {"B": 3, "E": 3, "i": 1, "X": 1,
                                           "b": 1, "e": 1}
    run_span = t.trace_id + ":0"
    for ev in data["traceEvents"]:
        if ev["ph"] in ("B", "X", "i") and ev["name"] != "run":
            assert ev["args"]["parent"] == run_span


def test_trace_propagation_parents_child_events():
    parent = Tracer()
    parent.start_run("run")
    child = Tracer(**parent.propagate())     # the worker process's twin
    child.complete("compute", start_s=1.0, end_s=2.0, wid=0)
    parent.add_events(child.drain())
    parent.finish_run()
    evs = parent.chrome()["traceEvents"]
    (compute,) = [e for e in evs if e["name"] == "compute"]
    assert compute["args"]["parent"] == parent.trace_id + ":0"
    assert compute["args"]["trace"] == parent.trace_id
    validate_chrome_trace(evs)
    assert child.drain() == []               # drain pops


def test_validate_chrome_trace_rejects_bad_events():
    base = {"ts": 0, "pid": 1, "tid": 1}
    with pytest.raises(ValueError, match="missing"):
        validate_chrome_trace([{"ph": "B", **base}])
    with pytest.raises(ValueError, match="unknown phase"):
        validate_chrome_trace([{"ph": "?", "name": "x", **base}])
    with pytest.raises(ValueError, match="without dur"):
        validate_chrome_trace([{"ph": "X", "name": "x", **base}])
    with pytest.raises(ValueError, match="closes"):
        validate_chrome_trace([{"ph": "B", "name": "a", **base},
                               {"ph": "E", "name": "b", **base}])
    with pytest.raises(ValueError, match="unclosed"):
        validate_chrome_trace([{"ph": "B", "name": "a", **base}])


def test_tracer_caps_events():
    t = Tracer(max_events=3)
    for i in range(5):
        t.instant(f"e{i}")
    assert len(t.events) == 3 and t.dropped == 2


def test_null_tracer_is_inert():
    assert not NULL_TRACER.enabled
    with NULL_TRACER.span("x"):
        NULL_TRACER.instant("y")
    assert NULL_TRACER.propagate() is None
    assert NULL_TRACER.start_run() is None


# ----------------------------------------------------------- telemetry

def test_telemetry_write_read_and_torn_tail(tmp_path):
    d = tmp_path / "t"
    with obs_telemetry.TelemetryWriter(d) as w:
        w.record(event="chunk", status="done", wid=0, worker="a",
                 survivors=3, accept_ts=1.0)
        w.record(event="chunk", status="done", wid=1, worker="b",
                 survivors=2, accept_ts=2.0)
    assert w.records_written == 2
    with open(w.path, "a") as f:           # a writer killed mid-line
        f.write('{"event":"chunk","status":"do')
    recs = obs_telemetry.read_records(str(d))
    assert [r["wid"] for r in recs] == [0, 1]
    led = obs_telemetry.worker_ledger(recs)
    assert led["a"]["chunks_done"] == 1 and led["a"]["survivors"] == 3
    assert led["b"]["first_accept_ts"] == 2.0
    chunks = obs_telemetry.chunk_ledger(recs)
    assert chunks[0]["done"] and chunks[0]["survivors"] == 3


def test_telemetry_torn_mid_file_raises(tmp_path):
    p = tmp_path / "x.jsonl"
    p.write_text('{"event":"chunk","wid":0}\n{"torn\n{"event":"chunk"}\n')
    with pytest.raises(ValueError):
        obs_telemetry.read_records(str(p))


@pytest.mark.parametrize("transport", ["inproc", "proc"])
def test_sharded_telemetry_exactly_once(transport, tmp_path, fresh_tracer):
    """Both transports leave exactly one master-side "done" record per
    chunk, naming a real worker, with acceptance times. The run is traced:
    the trace passes both frameworks' schema gates, and over worker
    processes their lease / fetch / compute / push spans arrive under the
    master's run span with the workers' own pids."""
    stream = _stream(2)
    d = tmp_path / transport
    with obs_telemetry.TelemetryWriter(d) as w:
        pre = Preprocessor(cfg, plan="sharded", shards=2,
                           transport=transport, telemetry=w,
                           **({"stall_timeout_s": 120.0}
                              if transport == "proc" else {}),
                           device="cpu")
        results = list(pre.run(stream))
    assert sorted(r.wid for r in results) == [0, 1]
    recs = obs_telemetry.read_records(str(d))
    done = [r for r in recs if r["status"] == "done"]
    assert sorted(r["wid"] for r in done) == [0, 1]
    by_wid = {r["wid"]: r for r in done}
    for r in results:
        rec = by_wid[r.wid]
        assert rec["survivors"] == int(r.n_kept)
        assert rec["worker"].startswith("shard")
        assert rec["accept_ts"] is not None
        assert rec["redelivered"] == 0
        assert rec["bytes_out"] == r.cleaned.nbytes
    fresh_tracer.finish_run()
    trace = fresh_tracer.chrome()
    assert validate_chrome_trace(trace) == \
        jtracing.validate_chrome_trace(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    if transport == "inproc":
        assert "tail_rebalanced" in names
        return
    assert {"accept", "emit_gated"} <= names
    run_span = fresh_tracer.run_span_id
    pids = {st.pid for st in pre.plan.worker_stats}
    worker_evs = [e for e in trace["traceEvents"] if e["pid"] in pids]
    assert {"lease", "fetch_many", "compute", "push", "tail", "emit"} <= {
        e["name"] for e in worker_evs}
    for e in worker_evs:
        assert e["args"]["trace"] == fresh_tracer.trace_id
        if e["ph"] != "E":
            assert e["args"]["parent"] == run_span
    # the spans were merged into the tracer, not kept in the bye report
    assert all("spans" not in (st.report or {})
               for st in pre.plan.worker_stats)


def test_proc_sigkill_leaves_redelivery_attribution(tmp_path):
    """A worker SIGKILLed while holding a lease leaves a durable
    "redelivered" record naming the losing incarnation, and the final
    "done" record carries the redelivery count and the survivor."""
    from repro_torch.ft.failure import CrashInjector

    n_batches = 3
    make = audio_batch_maker(seed=3, batch_long_chunks=1)
    pool = make_shard_pool(make, n_batches, 2, lease_timeout_s=120.0)
    injector = CrashInjector()
    injector.kill(1, after_items=0)          # shard1 dies at its first grant
    d = tmp_path / "t"
    with obs_telemetry.TelemetryWriter(d) as w:
        pre = Preprocessor(cfg, plan="sharded", shards=2, transport="proc",
                           injector=injector, telemetry=w, **PROC_KW)
        results = list(pre.run(pool))
    assert sorted(r.wid for r in results) == list(range(n_batches))
    assert pre.plan.redeliveries >= 1
    recs = obs_telemetry.read_records(str(d))
    done = {r["wid"]: r for r in recs if r["status"] == "done"}
    assert sorted(done) == list(range(n_batches))
    redel = [r for r in recs if r["status"] == "redelivered"]
    assert redel and all(r["worker"] == "shard1" for r in redel)
    for r in redel:
        assert done[r["wid"]]["redelivered"] >= 1
        assert done[r["wid"]]["worker"] == "shard0"
    led = obs_telemetry.worker_ledger(recs)
    assert led["shard1"]["redelivered_from"] >= 1
    assert led["shard0"]["chunks_done"] == n_batches


# ----------------------------------------------------------- ring caps

def test_batch_log_is_ring_capped():
    b = ContinuousBatcher(plan=lambda x: x, max_batch=1)
    assert b.batch_log.maxlen == BATCH_LOG_CAP
    for i in range(BATCH_LOG_CAP + 10):
        b.batch_log.append({"rids": [i]})
    assert len(b.batch_log) == BATCH_LOG_CAP
    assert b.batch_log[0]["rids"] == [10]


def test_async_plan_timings_ring_capped():
    pre = Preprocessor(cfg, plan="async", device="cpu")
    assert pre.plan.last_timings.maxlen == TIMINGS_CAP


# --------------------------------------------------- store mirroring

def test_store_stats_mirror_into_registry(fresh_registry):
    st = StoreStats(label="lake")
    st.hits += 2
    st.bytes_saved += 1000
    st.misses += 1
    assert (st.hits, st.misses, st.bytes_saved) == (2, 1, 1000)
    assert st.hit_rate == pytest.approx(2 / 3)
    snap = obs_metrics.snapshot()
    assert snap["store_hits_total"]["series"][0] == {
        "labels": {"store": "lake"}, "value": 2}
    assert snap["store_bytes_saved_total"]["series"][0]["value"] == 1000
    fresh_registry.enabled = False           # plain attributes still work
    st.hits += 5
    assert st.hits == 7


def test_chunk_store_labels_stats_by_directory(tmp_path, fresh_registry):
    from repro_torch.store import ChunkStore
    store = ChunkStore(tmp_path / "mystore")
    store.put("k1", {"a": np.zeros(4, np.float32)})
    assert store.get("k1", src_bytes=64) is not None
    snap = obs_metrics.snapshot()
    assert snap["store_hits_total"]["series"][0]["labels"] == {
        "store": "mystore"}
    assert snap["store_writes_total"]["series"][0]["value"] == 1


# --------------------------------------------------------- metrics RPC

def test_metrics_rpc_over_transport(fresh_registry):
    from repro_torch.data.queue import WorkQueue
    from repro_torch.dist.service import RPC_METHODS, QueueService
    from repro_torch.dist.transport import InProcTransport

    assert "metrics" in RPC_METHODS
    svc = QueueService(WorkQueue(2, lease_timeout_s=60.0))
    proxy = InProcTransport().connect(svc)
    proxy.call("lease", "shard0", 1)
    snap = proxy.call("metrics")
    assert snap["dist_lease_calls_total"]["series"][0] == {
        "labels": {"worker": "shard0"}, "value": 1}
    json.dumps(snap)                         # the payload is JSON-safe
    text = proxy.call("metrics", render=True)
    assert 'dist_lease_calls_total{worker="shard0"} 1' in text


def test_redelivery_counter_fires_without_telemetry(fresh_registry):
    from repro_torch.data.queue import SettableClock, WorkQueue
    from repro_torch.dist.service import QueueService

    clock = SettableClock()
    q = WorkQueue(2, lease_timeout_s=10.0, clock=clock)
    QueueService(q)                          # attaches on_redeliver
    q.lease("w0", 2)
    clock.t = 11.0
    q.lease("w1", 1)                         # reaps w0's expired leases
    series = obs_metrics.snapshot()["dist_redeliveries_total"]["series"]
    (s,) = [s for s in series if s["labels"]["worker"] == "w0"]
    assert s["labels"]["reason"] == "expired" and s["value"] == 2


# ------------------------------------------------ the plans' own hooks

def test_plan_hooks_record_each_plan(fresh_registry, fresh_tracer):
    """Each single-process plan counts its batches, chunks, survivors and
    source bytes under its own label, and opens the reference's spans."""
    stream = _stream(2)
    out = {plan: list(Preprocessor(cfg, plan=plan, device="cpu").run(stream))
           for plan in ("fused", "two_phase", "async")}
    snap = obs_metrics.snapshot()

    def val(name, plan):
        (v,) = [s["value"] for s in snap[name]["series"]
                if s["labels"]["plan"] == plan]
        return v

    for plan, res in out.items():
        assert val("plan_batches_total", plan) == 2
        assert val("plan_chunks_total", plan) == sum(
            r.det.keep.numel() for r in res) == 24
        assert val("plan_survivors_total", plan) == sum(
            r.n_kept for r in res)
        assert val("plan_src_bytes_total", plan) == sum(
            c.nbytes for _, (c, _) in stream)
    stages = {(s["labels"]["plan"], s["labels"]["stage"])
              for s in snap["plan_stage_seconds"]["series"]}
    assert ("async", "dispatch") in stages and ("two_phase", "emit") in stages
    fresh_tracer.finish_run()
    names = {e["name"] for e in fresh_tracer.chrome()["traceEvents"]}
    assert {"fused_batch", "detect_dispatch", "tail", "emit"} <= names


@pytest.mark.parametrize("plan,kw", [("two_phase", {}),
                                     ("async", {"depth": 2}),
                                     ("sharded", {"shards": 2}),
                                     ("cached", {})])
def test_outputs_bitwise_equal_with_observability_on(plan, kw, tmp_path):
    """The hooks only watch: metrics, tracing and telemetry on against
    all off gives the same bytes out."""
    stream = _stream(2)

    def run(on):
        args = dict(kw)
        if plan == "cached":
            args["store"] = str(tmp_path / ("on" if on else "off"))
        prev = obs_metrics.get_registry()
        obs_metrics.set_registry(MetricsRegistry() if on else NullRegistry())
        tracer = Tracer() if on else None
        obs_tracing.set_tracer(tracer)
        try:
            with obs_telemetry.TelemetryWriter(tmp_path / f"t{on}") as w:
                extra = {"telemetry": w} if on and plan == "sharded" else {}
                out = list(Preprocessor(cfg, plan=plan, device="cpu", **args,
                                        **extra).run(stream))
                for r in out:
                    if on:
                        obs_telemetry.record_result(w, r.wid, r)
        finally:
            obs_metrics.set_registry(prev)
            obs_tracing.set_tracer(None)
        if on:
            validate_chrome_trace(tracer.chrome())
        return out

    off, on = run(False), run(True)
    assert [r.wid for r in on] == [r.wid for r in off]
    for a, b in zip(off, on):
        for m in ("keep", "rain", "silence", "cicada15"):
            assert torch.equal(getattr(a.det, m), getattr(b.det, m))
        np.testing.assert_array_equal(a.cleaned, b.cleaned)


# ---------------------------------------------- against the JAX package


def _cached_sharded_twice(make_pre, metrics_mod, directory):
    """A cold then a warm pass of the seeded stream through CachedPlan
    around the 2-shard in-process plan, into a registry of its own."""
    prev = metrics_mod.get_registry()
    reg = metrics_mod.MetricsRegistry()
    metrics_mod.set_registry(reg)
    try:
        for _ in range(2):
            list(make_pre(store=str(directory / "store")).run(_stream(2)))
    finally:
        metrics_mod.set_registry(prev)
    return reg.snapshot()


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    with backend.use("ref"):
        return _cached_sharded_twice(
            lambda store: JPreprocessor(JCFG, plan="cached", inner="sharded",
                                        shards=2, store=store),
            jmetrics, d)


def _counter_view(snap):
    """name -> {labels: value} for every plan_ / store_ / dist_ counter
    and gauge, and the sample counts of the histograms (stage timings
    excepted: host times differ between frameworks)."""
    out = {}
    for name, m in snap.items():
        if not name.startswith(("plan_", "store_", "dist_")):
            continue
        series = {}
        for s in m["series"]:
            key = tuple(sorted(s["labels"].items()))
            if m["type"] == "histogram":
                if name == "plan_stage_seconds":
                    continue
                series[key] = s["count"]
            else:
                series[key] = s["value"]
        out[name] = series
    return out


def test_registries_hold_the_same_counts_as_the_reference(jax_snapshot,
                                                          tmp_path):
    got = _cached_sharded_twice(
        lambda store: Preprocessor(cfg, plan="cached", inner="sharded",
                                   shards=2, store=store, device="cpu"),
        obs_metrics, tmp_path)
    mine, ref = _counter_view(got), _counter_view(jax_snapshot)
    assert sorted(mine) == sorted(ref)
    assert {"plan_batches_total", "store_hits_total",
            "dist_lease_calls_total"} <= set(mine)
    assert mine == ref
    for name in got:                      # same kinds and label names
        if name in jax_snapshot:
            assert got[name]["type"] == jax_snapshot[name]["type"]
            assert got[name]["labels"] == jax_snapshot[name]["labels"]


def test_metrics_rpc_has_the_reference_shape(fresh_registry):
    """The same calls on a port and a reference QueueService give the
    same snapshot (kinds, help, label names, series) and the same
    Prometheus text."""
    from repro.data.queue import WorkQueue as JWorkQueue
    from repro.dist.service import QueueService as JQueueService
    from repro_torch.data.queue import WorkQueue
    from repro_torch.dist.service import QueueService

    def drive(svc):
        svc.hello("shard0", pid=1, shard=0)
        svc.lease("shard0", 2)
        svc.push_result("shard0", 0, {"x": np.zeros(4, np.float32)})
        svc.complete([0], worker="shard0")
        svc.note_done("shard0", wid=0, survivors=1, bytes_out=16)
        svc.fail_worker("shard0")
        return svc.metrics(), svc.metrics(render=True)

    mine = drive(QueueService(WorkQueue(3, lease_timeout_s=60.0)))
    prev = jmetrics.get_registry()
    jmetrics.set_registry(jmetrics.MetricsRegistry())
    try:
        ref = drive(JQueueService(JWorkQueue(3, lease_timeout_s=60.0)))
    finally:
        jmetrics.set_registry(prev)
    assert mine == ref


def _record_lines(path):
    """Records without the fields that name the moment or the process."""
    out = []
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        for k in ("ts", "accept_ts", "pid"):
            rec.pop(k, None)
        out.append(rec)
    return out


def test_telemetry_of_tensors_writes_the_reference_numbers(tmp_path):
    """A result whose fields are tensors (a count, the cleaned rows) and
    scalar tensors passed to `record` write the numbers the reference
    writes for the numpy equivalents, never the text "tensor(...)"."""
    cleaned = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    fields = {"n": np.int64(7), "x": np.float32(0.5), "flag": np.bool_(True),
              "v": np.arange(3, dtype=np.int32)}
    mine = BatchResult(cleaned=torch.as_tensor(cleaned), det=None,
                       n_kept=torch.tensor(3), src_bytes=torch.tensor(4096))
    ref = BatchResult(cleaned=cleaned, det=None, n_kept=np.int64(3),
                      src_bytes=np.int64(4096))
    with obs_telemetry.TelemetryWriter(tmp_path / "port", "t.jsonl") as w:
        obs_telemetry.record_result(w, torch.tensor(5), mine)
        w.record(event="extra", **{k: torch.as_tensor(v)
                                   for k, v in fields.items()})
    with jtelemetry.TelemetryWriter(tmp_path / "ref", "t.jsonl") as w:
        jtelemetry.record_result(w, np.int64(5), ref)
        w.record(event="extra", **fields)
    got = _record_lines(tmp_path / "port" / "t.jsonl")
    assert got == _record_lines(tmp_path / "ref" / "t.jsonl")
    assert got[0]["survivors"] == 3 and got[0]["bytes_out"] == cleaned.nbytes
    assert "tensor" not in (tmp_path / "port" / "t.jsonl").read_text()


def test_reference_readers_take_the_port_telemetry_and_trace(tmp_path,
                                                              fresh_tracer):
    """The port's telemetry through the reference's reader gives the same
    records and ledgers as through the port's; its trace passes the
    reference's schema gate."""
    d = tmp_path / "t"
    stream = _stream(2)
    with obs_telemetry.TelemetryWriter(d) as w:
        pre = Preprocessor(cfg, plan="sharded", shards=2, telemetry=w,
                           device="cpu")
        list(pre.run(stream))
        for i, r in enumerate(Preprocessor(cfg, plan="async",
                                           device="cpu").run(stream)):
            obs_telemetry.record_result(w, i, r)
    mine = obs_telemetry.read_records(str(d))
    ref = jtelemetry.read_records(str(d))
    assert mine == ref and len(mine) == 4
    assert jtelemetry.worker_ledger(ref) == obs_telemetry.worker_ledger(mine)
    assert jtelemetry.chunk_ledger(ref) == obs_telemetry.chunk_ledger(mine)
    fresh_tracer.finish_run()
    trace = fresh_tracer.chrome()
    assert jtracing.validate_chrome_trace(trace) == \
        validate_chrome_trace(trace)
