"""h2d_ms.archive: device time of host-to-device copies a traced batch, ms
(the profiler's "Memcpy HtoD" operations)."""


def read(run):
    tr = run.trace
    n = sum(1 for b in run.record.get("batches", []) if b.get("facts"))
    if tr is None or not n:
        return None
    s = sum(iv.end - iv.start for iv in tr.device if "HtoD" in iv.name)
    return 1e3 * s / n if s > 0 else None
