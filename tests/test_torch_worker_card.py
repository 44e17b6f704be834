"""A worker's report of its card and of the part of the run its master
marks, and the master's `serve_fetch` span: the worker loop driven
in-process over `InProcTransport`, on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.configs import SERF_AUDIO as cfg
from repro_torch.data.loader import audio_batch_maker
from repro_torch.data.queue import WorkQueue
from repro_torch.device import card_record
from repro_torch.dist import InProcTransport, QueueService
from repro_torch.dist.worker import run_worker
from repro_torch.obs import tracing as obs_tracing

SETUP = {"cfg": cfg, "stages": None, "source_channels": 2,
         "pad_multiple": 1, "bucket": "linear", "device": "cpu"}


@pytest.fixture
def master_tracer():
    """A tracer on the master for the test; the process's own is restored
    afterwards."""
    prev = obs_tracing.get_tracer()
    tracer = obs_tracing.Tracer()
    obs_tracing.set_tracer(tracer)
    yield tracer
    obs_tracing.set_tracer(prev)


def _service(n=2):
    make = audio_batch_maker(seed=13, batch_long_chunks=1)
    chunks = {w: make(w)[0] for w in range(n)}
    return QueueService(WorkQueue(n, lease_timeout_s=60.0),
                        fetch_item=chunks.__getitem__, setup=SETUP), chunks


def test_bye_carries_the_card_and_the_marked_part():
    """A part marked before the run: the worker's bye carries its card
    (the CPU: no index, no peak) and the part, with the items computed in
    it and their source bytes; no span is recorded without a tracer."""
    svc, chunks = _service()
    assert svc.heartbeat("shard0") is True          # nothing marked yet
    assert svc.mark(True) == 1
    assert svc.heartbeat("shard0") == {"seq": 1, "on": True, "trace": None}
    stats = run_worker(svc, shard=0, transport=InProcTransport(),
                       max_items=2)
    assert stats["card"] == {"index": None, "name": "cpu",
                             "memory_peak_bytes": 0}
    part = stats["part"]
    assert part["batches"] == [[w, chunks[w].nbytes] for w in (0, 1)]
    assert part["busy"] == [] and part["ops"] == {}
    assert part["window_s"] > 0 and "spans" not in stats
    assert svc.workers["shard0"].report["card"] == stats["card"]


def test_a_part_ended_before_the_run_records_nothing():
    svc, _ = _service()
    svc.mark(True)
    svc.mark(False)
    stats = run_worker(svc, shard=0, transport=InProcTransport(),
                       max_items=2)
    assert "part" not in stats and stats["card"]["name"] == "cpu"


def test_a_marked_part_with_the_masters_context_records_spans():
    """With no tracer running in the worker, a mark that carries the
    master's tracer context gives the part a tracer of its own: the
    worker's compute and push spans of the part, under the master's trace
    id, go out in bye; the process's tracer is put back afterwards."""
    svc, _ = _service()
    svc.mark(True, trace={"trace_id": "fleet", "parent": "fleet:0"})
    stats = run_worker(svc, shard=0, transport=InProcTransport(),
                       max_items=2)
    names = [ev["name"] for ev in stats["spans"] if ev["ph"] == "X"]
    assert names.count("compute") == 2 and names.count("push") == 2
    assert {ev["args"]["trace"] for ev in stats["spans"]} == {"fleet"}
    assert obs_tracing.get_tracer() is obs_tracing.NULL_TRACER


def test_serve_fetch_span_when_the_master_traces(master_tracer):
    """The master's serving of each fetch is a `serve_fetch` span, with
    the batches it served; untraced, none is recorded."""
    svc, _ = _service()
    run_worker(svc, shard=0, lease_items=2, transport=InProcTransport(),
               max_items=2)
    evs = [ev for ev in master_tracer.events if ev["name"] == "serve_fetch"]
    assert [ev["ph"] for ev in evs] == ["B", "E"]
    assert evs[0]["args"]["n"] == 2 and evs[0]["args"]["method"] == \
        "fetch_many"
    obs_tracing.set_tracer(None)
    svc, _ = _service()
    run_worker(svc, shard=0, transport=InProcTransport(), max_items=1)
    assert [ev for ev in master_tracer.events
            if ev["name"] == "serve_fetch"] == evs


def test_card_record_numbers_the_card_as_the_master_does(monkeypatch):
    """A worker pinned to the master's card "7" of ["5", "7"] reports
    index 1; one that sees the master's own cards reports its own index;
    name and peak are the card's."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: f"card{i}")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i: 1000 + i)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    dev = torch.device("cuda", 0)
    assert card_record(dev, ["5", "7"]) == {
        "index": 1, "name": "card0", "memory_peak_bytes": 1000}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "5,7")
    assert card_record(torch.device("cuda", 1), ["5", "7"])["index"] == 1
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert card_record(torch.device("cuda", 1), []) == {
        "index": 1, "name": "card1", "memory_peak_bytes": 1001}


def test_the_card_recorder_without_a_card_keeps_the_parts_length():
    rec = obs_tracing.CardRecorder(torch.device("cpu"))
    rec.start()
    rec.stop()
    out = rec.result()
    assert out["busy"] == [] and out["ops"] == {}
    assert out["window_s"] >= 0 and np.isfinite(out["window_s"])
