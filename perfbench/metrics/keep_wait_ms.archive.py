"""keep_wait_ms.archive: the plan's own `timings["readback_s"]`, the host's
wait on the keep mask (which covers detection on the device), mean ms a
batch over the window."""


def read(run):
    v = [b["readback_s"] for b in run.record.get("batches", [])
         if b.get("readback_s") is not None]
    return 1e3 * sum(v) / len(v) if v else None
