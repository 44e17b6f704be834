"""A traced window's share of the roofline over hand-kernel launches: the
least time the launches' shapes need (each kernel's counter) over the
device time the trace gives them."""
from __future__ import annotations

import sys

from perfbench.peaks import least_ms


def share(run, only=None):
    """100 x sum of least ms / sum of device ms over the launches of the
    kernels `only` names (None: every kernel with a counter) in the traced
    batches, or None where the trace holds no such launch. The launches a
    counter predicts must match the trace's and the program's own counts,
    or the counter does not describe what ran: then None, and a line on
    standard error."""
    tr = run.trace
    if tr is None:
        return None
    traced = [b["facts"] for b in run.record["batches"] if b.get("facts")]
    least = device = 0.0
    for name, mod in run.bench.rooflines().items():
        if only is not None and name not in only:
            continue
        shapes = [s for f in traced for s in mod.launches(f)]
        events = [iv for iv in tr.device if mod.TRACE_NAME.search(iv.name)]
        counted = run.record.get("launches", {}).get(mod.KERNEL)
        if len(events) != len(shapes) or (counted is not None
                                          and counted != len(shapes)):
            print(f"perfbench: {name}: {len(shapes)} launches predicted, "
                  f"{len(events)} traced, {counted} counted by the "
                  f"program; no roofline share", file=sys.stderr)
            return None
        for s in shapes:
            least += least_ms(*mod.count(s))[0]
        device += sum(iv.end - iv.start for iv in events) * 1e3
    if device <= 0:
        return None
    return 100.0 * least / device
