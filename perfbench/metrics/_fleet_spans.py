"""What the fleet's span readers share: the worker spans of a traced
fleet run (`runners/fleet.py` keeps the master's tracer's events under
"spans"; the workers' `lease` / `fetch_many` / `compute` / `push` complete
events reach it through their `bye`)."""


def worker_ms(run, name):
    """Host ms a batch of the workers' `name` spans: each worker's summed
    span time over the batches they covered (a span's "n", else one), the
    mean over the workers that recorded any; None where none did."""
    per = {}
    for ev in run.record.get("spans") or ():
        if ev.get("ph") != "X" or ev.get("name") != name:
            continue
        args = ev.get("args", {})
        tot = per.setdefault(args.get("worker"), [0.0, 0])
        tot[0] += ev["dur"]
        tot[1] += int(args.get("n", 1))
    ms = [1e-3 * s / n for s, n in per.values() if n]
    return sum(ms) / len(ms) if ms else None
