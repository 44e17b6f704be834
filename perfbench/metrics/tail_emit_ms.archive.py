"""tail_emit_ms.archive: `timings["tail_s"] + timings["emit_s"]`, the
tail's enqueue and the wait for the cleaned rows, mean ms a batch over the
window."""


def read(run):
    v = [b["tail_s"] + b["emit_s"] for b in run.record.get("batches", [])
         if b.get("tail_s") is not None and b.get("emit_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
