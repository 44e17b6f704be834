"""detect_enqueue_ms.archive: host time of the program's `obs/stage.<name>`
spans a traced batch, ms: the enqueue of `core/graph.py`'s stages, each
span one stage's `apply` (its launches and its DTensor dispatch). The
detection's stages in both archive cells, whose tail is the fused kernel;
a tail run stage by stage would add its stages. The plan's and the mesh's
work around the stages (`outputs`, `_whole_output`, `_local_rows`) is not
in it."""


def read(run):
    tr = run.trace
    n = sum(1 for b in run.record.get("batches", []) if b.get("facts"))
    if tr is None or not n:
        return None
    stages = [iv for iv in tr.host if iv.name.startswith("obs/stage.")]
    if not stages:
        return None
    return 1e3 * sum(iv.end - iv.start for iv in stages) / n
