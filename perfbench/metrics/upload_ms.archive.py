"""upload_ms.archive: host time of the program's `obs/upload` spans a
traced batch, ms: the host's side of the copy that `h2d_ms.archive` sees
on the device (two_phase's pageable `torch.as_tensor`, which blocks the
host for the whole copy)."""


def read(run):
    tr = run.trace
    n = sum(1 for b in run.record.get("batches", []) if b.get("facts"))
    if tr is None or not n:
        return None
    ups = [iv for iv in tr.host if iv.name == "obs/upload"]
    if not ups:
        return None
    return 1e3 * sum(iv.end - iv.start for iv in ups) / n
