"""compute_ms.fleet: the workers' `compute` spans, host ms a batch, the
mean over the workers: two_phase on the worker's card, from the host array
to the packed result (`dist/worker.py`, traced part)."""
from perfbench.spec import HERE, load_module

_spans = load_module(HERE / "metrics" / "_fleet_spans.py",
                     "perfbench_fleet_spans")


def read(run):
    return _spans.worker_ms(run, "compute")
