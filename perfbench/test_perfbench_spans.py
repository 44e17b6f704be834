"""The readers of the program's spans (`obs/...` host events in the traced
window): on a hand-built trace whose numbers are known, and in a traced
run of each cell on the CPU."""
import time
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.spec import Bench
from perfbench.trace import Interval, Trace

SMALL = {"traffic": {"pool_items": 1, "long_chunks_per_item": 1}}
SPAN_METRICS = ("upload_ms.archive", "detect_enqueue_ms.archive",
                "idle_in_plan_ms.archive", "idle_outside_plan_ms.archive")
IDLE = ("idle_in_plan_ms.archive", "idle_outside_plan_ms.archive")


def _read(metric, run):
    return Bench().reader(metric).read(run)


def _run(host, device, window_s=10.0, traced=2):
    """Two traced batches and one before the trace, over a window that
    starts at 0."""
    batches = [{"src_bytes": 1}] + \
        [{"src_bytes": 1, "facts": {"rows": 4}}] * traced
    tr = Trace(device=[Interval(n, s, e) for n, s, e in device],
               host=[Interval(n, s, e) for n, s, e in host],
               window_s=window_s, start=0.0)
    return SimpleNamespace(trace=tr, record={"batches": batches})


# two batches, [0, 4] and [5, 8.5] s; a host op of the caller's between
HOST = [("obs/two_phase_batch", 0.0, 4.0), ("obs/detect_dispatch", 0.1, 2.0),
        ("obs/upload", 0.1, 1.5), ("aten::copy_", 0.2, 1.4),
        ("obs/stage.stft", 1.6, 1.9),
        ("aten::empty", 4.2, 4.4),
        ("obs/two_phase_batch", 5.0, 8.5), ("obs/detect_dispatch", 5.1, 6.0),
        ("obs/upload", 5.1, 5.5), ("obs/stage.detect_rain", 5.6, 5.8)]
# idle: [0, 0.5] and [1.5, 2] and [6.5, 7] inside a batch (1.5 s), [3, 5.5]
# and [8, 10] in none (4.5 s)
DEVICE = [("Memcpy HtoD", 0.5, 1.5), ("kernel", 2.0, 3.0),
          ("Memcpy HtoD", 5.5, 6.5), ("kernel", 7.0, 8.0)]


@pytest.mark.parametrize("metric,want", [
    ("upload_ms.archive", 1e3 * (1.4 + 0.4) / 2),
    ("detect_enqueue_ms.archive", 1e3 * (0.3 + 0.2) / 2),
    ("idle_in_plan_ms.archive", 1e3 * 1.5 / 2),
    ("idle_outside_plan_ms.archive", 1e3 * 4.5 / 2)])
def test_readers_on_a_known_trace(metric, want):
    assert _read(metric, _run(HOST, DEVICE)) == pytest.approx(want)


def test_idle_readers_partition_the_windows_idle_time():
    """The two idle readers sum to what device_idle_share.archive implies,
    a batch; a gap whose middle lies in no program span (under a host op
    of the caller's) is the caller's."""
    run = _run(HOST, DEVICE)
    share = _read("device_idle_share.archive", run)
    assert share == pytest.approx(60.0)
    inside, outside = (_read(m, run) for m in IDLE)
    assert inside + outside == pytest.approx(
        share / 100 * run.trace.window_s * 1e3 / 2)
    # a device operation filling [3, 5.5] leaves only [8, 10] outside
    run = _run(HOST, DEVICE + [("kernel", 3.0, 5.5)])
    assert _read("idle_outside_plan_ms.archive", run) == pytest.approx(1e3)
    assert _read("idle_in_plan_ms.archive", run) == pytest.approx(750.0)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_readers_find_nothing_without_spans(metric):
    """The parent's program opens no span: every reader returns None, as
    it does with no trace or no traced batch."""
    no_spans = [h for h in HOST if not h[0].startswith("obs/")]
    assert _read(metric, _run(no_spans, DEVICE)) is None
    assert _read(metric, _run(HOST, DEVICE, traced=0)) is None
    assert _read(metric, SimpleNamespace(trace=None, record={
        "batches": [{"facts": {"rows": 4}}]})) is None


def test_the_span_breakdown_charges_each_gap_to_its_innermost_span():
    """`scripts/span_breakdown.py`'s table on the known trace: the gaps
    inside a batch go to the innermost span over their middle, the rest to
    no span, and the table sums to the idle readers' total."""
    from perfbench.spec import ROOT, load_module
    sb = load_module(ROOT / "scripts" / "span_breakdown.py",
                     "span_breakdown")
    out = sb.analyse(_run(HOST, DEVICE))
    assert out["idle_ms_by_span"] == pytest.approx({
        "obs/upload": 250.0, "obs/stage.stft": 250.0,
        "obs/two_phase_batch": 250.0, "(no obs span)": 1e3 * 4.5 / 2})
    assert out["idle_ms_by_span_and_op"]["(no obs span) | aten::empty"] \
        == pytest.approx(1e3 * 2.5 / 2)
    assert out["idle_ms"] == pytest.approx(
        sum(_read(m, _run(HOST, DEVICE)) for m in IDLE))
    assert out["span_ms"]["obs/upload"] == pytest.approx(900.0)


@pytest.mark.parametrize("workload", ["serf_archive.chorus",
                                      "serf_archive.rain"])
def test_a_traced_cpu_run_reports_the_host_span_metrics(workload):
    """On the CPU the profiler records the host only: the upload and the
    detection enqueue are reported, the idle metrics are absent."""
    r = harness.run_cell(workload, 2**31 + 13, 0.5, 1, time.monotonic(),
                         device="cpu", overrides=SMALL)
    assert r["correct"], r["check"]
    m = r["metrics"]
    assert m["upload_ms.archive"]["value"] > 0
    assert m["detect_enqueue_ms.archive"]["value"] > 0
    assert not set(IDLE) & set(m)
