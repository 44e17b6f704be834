"""idle_in_plan_ms.archive: the device's idle ms a traced batch in gaps
whose middle lies inside a program span (`obs/...`): time in which the
program's own host work holds the card. Gaps as `Trace.idle_gaps` finds
them: from the window's start, between the merged device operations, to
the window's end, each charged by its middle. `split` is shared with
idle_outside_plan_ms.archive, and the two sum to the window's idle time."""
import bisect


def _gaps(tr):
    end = tr.start + tr.window_s
    gaps, t = [], tr.start
    for iv in sorted(tr.device, key=lambda i: i.start):
        if iv.start > t:
            gaps.append((t, min(iv.start, end)))
        t = max(t, iv.end)
    if t < end:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]


def split(run):
    """(idle seconds inside program spans, idle seconds outside them,
    traced batches), or None where the trace has no device operation or
    no program span."""
    tr = run.trace
    n = sum(1 for b in run.record.get("batches", []) if b.get("facts"))
    if tr is None or not n or not tr.device:
        return None
    spans = sorted((iv.start, iv.end) for iv in tr.host
                   if iv.name.startswith("obs/"))
    if not spans:
        return None
    starts, ends = [], []           # the spans' union, sorted
    for s, e in spans:
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    inside = outside = 0.0
    for s, e in _gaps(tr):
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and ends[i] >= mid:
            inside += e - s
        else:
            outside += e - s
    return inside, outside, n


def read(run):
    parts = split(run)
    return None if parts is None else 1e3 * parts[0] / parts[2]
