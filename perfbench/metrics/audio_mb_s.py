"""audio_mb_s: float32 source bytes the plan emitted over all the time of
the window, in MB/s (10^6 bytes)."""


def read(run):
    b = run.record.get("batches")
    if not b:
        return None
    return sum(x["src_bytes"] for x in b) / run.window_s / 1e6
