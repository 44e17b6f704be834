"""fetch_ms.fleet: the workers' `fetch_many` spans, host ms a batch, the
mean over the workers: a lease's batches from the request to the worker
holding them, the master's serving (`serve_fetch_ms.fleet`) and the socket
included (`dist/worker.py`, traced part)."""
from perfbench.spec import HERE, load_module

_spans = load_module(HERE / "metrics" / "_fleet_spans.py",
                     "perfbench_fleet_spans")


def read(run):
    return _spans.worker_ms(run, "fetch_many")
