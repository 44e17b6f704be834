"""device_mb_s: float32 source bytes the plan emitted over the window, per
second in which the card ran an operation (a kernel, a copy or a set)
there, in MB/s (10^6 bytes): the rate of the job once the host keeps the
card fed. The card's operations come from `torch.profiler` recording the
card alone over the whole window of an untraced run ("card_trace")."""


def read(run):
    tr = run.record.get("card_trace")
    b = run.record.get("batches")
    if tr is None or not tr.device or not b:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    return sum(x["src_bytes"] for x in b) / busy / 1e6
