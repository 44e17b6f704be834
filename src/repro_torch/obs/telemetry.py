"""Durable per-chunk telemetry: crash-safe JSONL records and their
aggregation (the port's copy of the reference's `obs/telemetry.py`; the
records are byte for byte the reference's for the same result, so that
either framework's reader takes the other's files).

Every chunk that moves through a leased queue leaves records written on
the master (the paper's master is the one box guaranteed to survive a
slave crash), at the moments the master learns something:

  * status "done": written at `complete` acceptance
    (`QueueService.note_done`), with the lease -> fetch -> push -> accept
    timeline, worker / shard / pid, content key, survivor count and bytes
    moved. Exactly one per chunk id, because acceptance is gated on
    `WorkQueue.complete` returning the id as newly done.
  * status "redelivered": written when a lease is reclaimed
    (`WorkQueue.on_redeliver`: reason "expired", "failed" or
    "speculated"), attributing the losing incarnation.

Records survive SIGKILLed workers by construction (workers never write
them) and a killed master up to the last flushed line: each record is
one buffered `write()` of one line and a `flush()`, and the reader skips
a torn trailing line.

Values that JSON does not take natively (numpy scalars, tensors) go
through `_json_safe`: a tensor is read back to numpy first, then takes
the reference's int / float / str casts, so a record never holds the
text of a tensor. `worker_ledger` aggregates records into the paper's
Figure-style per-worker load view.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time

import torch


class TelemetryWriter:
    """Append-only JSONL writer, one file per writing process."""

    def __init__(self, directory, name=None, fsync=False):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        fname = name or f"telemetry-{os.getpid()}.jsonl"
        self.path = os.path.join(self.directory, fname)
        self._fsync = fsync
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")
        self.records_written = 0

    def record(self, **fields):
        fields.setdefault("ts", time.time())
        line = json.dumps(fields, separators=(",", ":"), default=_json_safe)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self.records_written += 1

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _json_safe(obj):
    if torch.is_tensor(obj):
        # the numbers numpy would give, never the text "tensor(...)"
        obj = obj.detach().cpu().numpy()
    for cast in (int, float):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return str(obj)


def record_result(writer, wid, res, worker="master"):
    """Acceptance record for a result emitted OUTSIDE a queue service
    (single-process plans in the launcher, benches): same shape as
    the master-side "done" records, minus the RPC timeline."""
    if writer is None:
        return
    writer.record(event="chunk", status="done", wid=int(wid),
                  worker=worker, pid=os.getpid(), accept_ts=time.time(),
                  survivors=int(getattr(res, "n_kept", 0)),
                  bytes_in=int(getattr(res, "src_bytes", 0)),
                  bytes_out=int(getattr(res, "cleaned", None).nbytes
                                if getattr(res, "cleaned", None) is not None
                                else 0))


# ------------------------------------------------------------------ read

def read_records(path):
    """Load every record under `path` (a directory of *.jsonl, or one
    file).  A torn trailing line — the writing process died mid-write —
    is skipped, not fatal; a torn line anywhere else raises."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.jsonl")))
    else:
        files = [path]
    records = []
    for fp in files:
        with open(fp, encoding="utf-8") as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                if i == len(lines) - 1:
                    continue    # torn tail: writer was killed mid-line
                raise
    return records


def chunk_ledger(records):
    """Per-chunk view: {wid: {"statuses": [...], "workers": [...],
    "survivors": int|None, "done": bool}} in record order."""
    out = {}
    for r in records:
        if r.get("event") != "chunk":
            continue
        wid = r.get("wid")
        c = out.setdefault(wid, {"statuses": [], "workers": [],
                                 "survivors": None, "done": False})
        c["statuses"].append(r.get("status"))
        if r.get("worker") is not None:
            c["workers"].append(r.get("worker"))
        if r.get("status") == "done":
            c["done"] = True
            c["survivors"] = r.get("survivors")
    return out


def worker_ledger(records):
    """The Figure-style per-worker load ledger: how many chunks each
    worker actually carried, what it produced, and what it dropped."""
    out = {}

    def w(name):
        return out.setdefault(name, {
            "chunks_done": 0, "survivors": 0, "bytes_in": 0, "bytes_out": 0,
            "redelivered_from": 0, "speculation_lost": 0,
            "first_accept_ts": None, "last_accept_ts": None})

    for r in records:
        if r.get("event") != "chunk":
            continue
        name = r.get("worker") or "?"
        entry = w(name)
        if r.get("status") == "done":
            entry["chunks_done"] += 1
            entry["survivors"] += int(r.get("survivors") or 0)
            entry["bytes_in"] += int(r.get("bytes_in") or 0)
            entry["bytes_out"] += int(r.get("bytes_out") or 0)
            ts = r.get("accept_ts")
            if ts is not None:
                if entry["first_accept_ts"] is None:
                    entry["first_accept_ts"] = ts
                entry["last_accept_ts"] = ts
        elif r.get("status") == "redelivered":
            entry["redelivered_from"] += 1
            # a "speculated" reason is not a lost LEASE but a lost RACE:
            # this incarnation computed an id whose duplicate finished
            # first — break it out so wasted-work dashboards see it
            if r.get("reason") == "speculated":
                entry["speculation_lost"] += 1
    return out
