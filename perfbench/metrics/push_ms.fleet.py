"""push_ms.fleet: the workers' `push` spans, host ms a batch, the mean over
the workers: a result's masks and cleaned rows back to the master over the
socket (`dist/worker.py`, traced part)."""
from perfbench.spec import HERE, load_module

_spans = load_module(HERE / "metrics" / "_fleet_spans.py",
                     "perfbench_fleet_spans")


def read(run):
    return _spans.worker_ms(run, "push")
