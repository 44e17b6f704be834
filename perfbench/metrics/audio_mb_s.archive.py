"""audio_mb_s.archive: float32 source bytes the plan emitted over all the
time of a traced run's window, in MB/s (10^6 bytes), on the host's clock:
what the archive job delivers on this host (its last `TRACE_S` seconds
under the profiler)."""


def read(run):
    b = run.record.get("batches")
    if not b:
        return None
    return sum(x["src_bytes"] for x in b) / run.window_s / 1e6
