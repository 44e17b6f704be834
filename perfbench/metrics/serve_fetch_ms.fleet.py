"""serve_fetch_ms.fleet: the master's `serve_fetch` spans, host ms a batch:
its serving of one fetch, from the batch's materialisation (the run's
`make_item`, `_host_f32`) to the end of its send over the socket
(`dist/transport.py`, traced part; the master's tracer's B/E pairs, one
pair a fetch and a handler thread)."""


def read(run):
    open_, tot, n = {}, 0.0, 0
    for ev in run.record.get("spans") or ():
        if ev.get("name") != "serve_fetch":
            continue
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            open_[key] = ev
        elif ev["ph"] == "E" and key in open_:
            b = open_.pop(key)
            tot += ev["ts"] - b["ts"]
            n += int(b.get("args", {}).get("n", 1))
    return 1e-3 * tot / n if n else None
