"""The fleet's cell on the CPU: `serf_fleet4.chorus` cut to 2 worker
processes over pools of one long chunk, against the SERF reference; the
cards composed into one trace; and a program whose workers cannot report
their card refused before anything is spawned."""
import time

import pytest

from perfbench import harness
from perfbench.spec import Bench
from perfbench.trace import Interval, Trace

CELL = "serf_fleet4.chorus"
SEED = 2**31 + 29
PLAN = {"shards": 2, "transport": "proc", "lease_items": 1,
        "stall_timeout_s": 120.0}
SMALL = {"traffic": {"pool_items": 2, "long_chunks_per_item": 1},
         "deployment": {"plan_kwargs": PLAN}}
# every label of the generator, so that the masks differ chunk to chunk
MIXED = {"traffic": {"pool_items": 2, "long_chunks_per_item": 1,
                     "persistence": 0.85,
                     "label_probs": [0.45, 0.2, 0.15, 0.2]},
         "deployment": {"plan_kwargs": PLAN}}


@pytest.fixture(autouse=True)
def one_thread_workers(monkeypatch):
    """Spawned workers inherit the environment: one intra-op thread each
    (the suite runs beside other test processes)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _runner(overrides):
    import torch
    bench = Bench()
    config = bench.config(bench.cell(CELL)["config"])
    for part, changes in overrides.items():
        if part != "traffic":
            config[part].update(changes)
    return bench.runner(config["runner"]).Runner(config, "cpu", torch)


def test_the_fleet_on_the_cpu_is_correct_and_leaves_no_worker():
    """Every work id emitted once and in order, one device record a
    worker, and no worker process left once the window closed the run."""
    drv = _runner(SMALL)
    wids = []
    emitted = drv._emitted
    drv._emitted = lambda res: (wids.append(int(res.wid)), emitted(res))
    try:
        r = harness.run_cell(CELL, SEED, 3.0, 0, time.monotonic(),
                             device="cpu", overrides=SMALL, runner=drv)
        handles = drv.pre.plan.fleet.handles
        assert len(handles) == 2
        assert all(h.poll() is not None for h in handles.values())
    finally:
        drv.close()
    assert r["correct"], r["check"]
    assert list(r["check"]) == ["mask_mismatch", "cleaned_err",
                                "cleaned_rms", "repeat_mismatch",
                                "emit_mismatch"]
    assert wids == list(range(len(wids))) and r["attempted"] >= 2
    assert r["diagnostics"]["coverage"]["items"] >= 2
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 2,
                           "memory_peak_bytes": 0}
    assert [c["index"] for c in r["diagnostics"]["cards"]] == [0, 1]
    assert set(r["metrics"]) == {"setup_s"}     # no card to read


def test_a_traced_fleet_run_against_the_reference_reads_its_spans():
    """Mixed labels: masks equal the reference's and cleaned rows lie
    within the limits; the traced part gives the master's and the
    workers' span metrics (no card on the CPU: no idle share)."""
    r = harness.run_cell(CELL, SEED + 1, 3.0, 1, time.monotonic(),
                         device="cpu", overrides=MIXED)
    assert r["correct"], r["check"]
    cov = r["diagnostics"]["coverage"]
    assert cov["cleaned_rows_compared"] > 0
    assert r["check"]["mask_mismatch"]["value"] == 0
    assert set(r["metrics"]) == {
        "fleet_mb_s.fleet", "serve_fetch_ms.fleet", "fetch_ms.fleet",
        "compute_ms.fleet", "push_ms.fleet"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    # a batch's fetch, as the worker waits for it, holds its serving
    assert r["metrics"]["fetch_ms.fleet"]["value"] >= \
        0.5 * r["metrics"]["serve_fetch_ms.fleet"]["value"]
    assert [c["index"] for c in r["diagnostics"]["cards"]] == [0, 1]


def test_the_cards_read_as_their_mean_card():
    """Two cards' traces: `busy_s()` is their mean, and `device_mb_s` the
    window's source bytes over it; a card's parts merge as a union."""
    from perfbench.runners.fleet import CardTraces, card_trace
    a = Trace(device=[Interval("k", 0.0, 1.0), Interval("c", 0.5, 2.0)],
              start=0.0, window_s=10.0)
    b = Trace(device=[Interval("k", 5.0, 9.0)], start=5.0, window_s=10.0)
    cards = CardTraces({0: a, 1: b}, {"k": 5.0, "c": 1.5})
    assert cards.busy_s() == pytest.approx(3.0)
    assert cards.window_s == pytest.approx(10.0)
    assert cards.device_ops() == [["k", 5.0], ["c", 1.5]]
    record = {"kind": "fleet", "window_s": 51.0, "card_trace": cards,
              "batches": [{"src_bytes": 4_000_000},
                          {"src_bytes": 2_000_000}]}
    run = harness.Run(record, Bench(), CELL, {}, {})
    assert Bench().reader("device_mb_s").read(run) == pytest.approx(2.0)
    one = card_trace([{"busy": [[1.0, 2.0], [3.0, 4.0]], "window_s": 5.0},
                      {"busy": [[1.5, 3.5]], "window_s": 4.0}])
    assert one.busy_s() == pytest.approx(3.0) and one.window_s == 5.0
    assert CardTraces({}).busy_s() == 0.0


def test_workers_that_cannot_report_their_card_fail_before_a_spawn(
        monkeypatch):
    """A program whose workers report no card (the parent of this cell's
    commit) is refused in set-up, before any worker is spawned."""
    from repro_torch import device
    from repro_torch.dist.transport import ProcTransport
    spawned = []
    monkeypatch.setattr(ProcTransport, "spawn_worker",
                        lambda *a, **k: spawned.append(a))
    monkeypatch.delattr(device, "card_record")
    with pytest.raises(RuntimeError, match="cannot report their cards"):
        harness.run_cell(CELL, SEED, 1.0, 0, time.monotonic(),
                         device="cpu", overrides=SMALL)
    assert spawned == []
