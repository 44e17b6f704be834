"""fleet_mb_s.fleet: float32 source bytes the master emitted over the
window's seconds on its own clock, in MB/s (10^6 bytes): the fleet job's
rate as the paper measures it, read in a traced run (`runners/fleet.py`'s
"emitted")."""


def read(run):
    e = run.record.get("emitted")
    if not e or run.window_s <= 0:
        return None
    return sum(e) / run.window_s / 1e6
