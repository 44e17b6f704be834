"""Span tracing exported as Chrome trace-event JSON, loadable in
Perfetto (the port's copy of the reference's `obs/tracing.py`).

A run gets one `Tracer` with a run-level `trace_id`. The master opens a
root "run" span (`start_run()`); every span opened afterwards, on the
master or in a worker, carries `{"trace": trace_id, "parent":
run_span_id}` in its `args`, which is how worker spans are parented under
the master's run span across the pickle boundary:

  * master: `tracer.propagate()` -> a small dict, put into the `hello`
    setup blob by `dist.service.QueueService`;
  * worker: builds its own `Tracer(**propagated)` (another pid, the same
    trace id and parent), buffers events locally and ships them back as
    `bye(stats={"spans": [...]})`; the master merges them with
    `add_events`.

Event kinds used:
  * `B`/`E` pairs from `span()`, strictly nested per (pid, tid) because
    they come from a context manager;
  * `X` complete events from `complete()`, for the worker loop's phases
    (lease / fetch / compute / push), recorded only for iterations that
    got work;
  * `i` instants from `instant()`; `b`/`e` async pairs from
    `async_begin`/`async_end` for request lifetimes that start and end on
    different threads (the continuous batcher).

A span measures host time: on the card it covers the enqueue of the
work, not its execution, as the reference's spans cover JAX's
asynchronous dispatch. No span synchronises the device.

Two sinks, two clocks. The run's `Tracer` stamps its events with
`time.time_ns()` (epoch microseconds in the Chrome JSON), the clock the
master and its workers share. While `torch.profiler` records, the
module-level `span()` also opens a record named `obs/<name>` in the
profiler (`torch._C._profiler._RecordFunctionFast`, a function-scope
record: kineto keeps it among the host operations and does not mirror it
onto the device timeline as it does `record_function`'s user
annotations). That record is stamped by the profiler's own clock, the
one its kernels and copies carry, so each idle gap of the device can be
put down to the program span around it. The record carries the name
only; nesting is the profiler's, by interval.

`validate_chrome_trace` is the schema gate: every event carries
`ph`/`ts`/`pid`/`tid`/`name`, and `B`/`E` balance LIFO per (pid, tid).

Near zero cost when off: the module-level tracer defaults to
`NULL_TRACER`, and with no profiler recording `span()` returns the shared
no-op context manager after one check of the profiler's state.

`timed(name)` is a span that also keeps its own host seconds (`.s`, by
`time.perf_counter`, on or off): the one clock of an interval whose length
the caller also needs, such as a plan's `timings`.
"""
from __future__ import annotations

import json
import os
import threading
import time
import uuid

import torch

# whether torch.profiler is recording (one call into C)
_profiling = torch._C._autograd._profiler_enabled


def _now_us():
    # Wall-clock (not monotonic) so master and worker events share a
    # comparable timebase across processes.
    return time.time_ns() / 1e3


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting a B/E pair on one tracer."""
    __slots__ = ("_tracer", "_name")

    def __init__(self, tracer, name, args):
        self._tracer = tracer
        self._name = name
        tracer._emit("B", name, args=args)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer._emit("E", self._name)
        return False


class _ProfiledSpan:
    """A span while a profiler records: an `obs/<name>` record in the
    profiler around the tracer's span (None: no tracer installed)."""
    __slots__ = ("_record", "_span")

    def __init__(self, name, span):
        self._record = torch._C._profiler._RecordFunctionFast("obs/" + name)
        self._span = span

    def __enter__(self):
        self._record.__enter__()
        return self

    def __exit__(self, *exc):
        self._record.__exit__(*exc)
        if self._span is not None:
            self._span.__exit__(*exc)
        return False


class Tracer:
    """Event buffer with Chrome trace-event output.

    `max_events` bounds memory on long-lived services; once full, new
    events are dropped and counted (`dropped`) — short smoke/validation
    runs never get near the cap, so B/E balance is preserved where it is
    checked.
    """

    enabled = True

    def __init__(self, trace_id=None, parent=None, max_events=200_000):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.parent = parent          # span id worker events attach under
        self.run_span_id = None
        self.max_events = int(max_events)
        self.dropped = 0
        self.events = []
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- low-level emit ---------------------------------------------------
    def _emit(self, ph, name, ts=None, args=None, **extra):
        ev = {"name": name, "ph": ph,
              "ts": _now_us() if ts is None else ts,
              "pid": self._pid, "tid": threading.get_ident(),
              "cat": extra.pop("cat", "repro")}
        a = dict(args) if args else {}
        a["trace"] = self.trace_id
        if self.parent is not None and ph in ("B", "X", "i", "b", "e"):
            a["parent"] = self.parent
        ev["args"] = a
        ev.update(extra)
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
            else:
                self.events.append(ev)
        return ev

    # -- public span API --------------------------------------------------
    def span(self, name, **args):
        return _Span(self, name, args)

    def complete(self, name, start_s, end_s=None, **args):
        """X (complete) event from wall-clock seconds — for after-the-fact
        recording, e.g. a worker lease poll kept only when it got ids."""
        end_s = time.time() if end_s is None else end_s
        self._emit("X", name, ts=start_s * 1e6,
                   dur=max(0.0, (end_s - start_s) * 1e6), args=args)

    def instant(self, name, **args):
        self._emit("i", name, args=args, s="t")

    def async_begin(self, name, id, **args):
        self._emit("b", name, args=args, id=str(id), cat="request")

    def async_end(self, name, id, **args):
        self._emit("e", name, args=args, id=str(id), cat="request")

    # -- run-root span ----------------------------------------------------
    def start_run(self, name="run", **args):
        ev = self._emit("B", name, args=args)
        self.run_span_id = ev["args"]["span"] = f"{self.trace_id}:0"
        self._run_name = name
        self.parent = self.run_span_id
        return self.run_span_id

    def finish_run(self):
        if self.run_span_id is not None:
            self._emit("E", getattr(self, "_run_name", "run"))

    # -- cross-process plumbing -------------------------------------------
    def propagate(self):
        """Picklable context for a child tracer in another process."""
        return {"trace_id": self.trace_id, "parent": self.parent}

    def add_events(self, events):
        """Merge events shipped from a worker tracer (already dicts)."""
        if not events:
            return
        with self._lock:
            room = self.max_events - len(self.events)
            if room < len(events):
                self.dropped += len(events) - max(0, room)
                events = events[:max(0, room)]
            self.events.extend(events)

    def drain(self):
        """Pop and return all buffered events (worker -> bye payload)."""
        with self._lock:
            evs, self.events = self.events, []
            return evs

    # -- export -----------------------------------------------------------
    def chrome(self):
        with self._lock:
            evs = sorted(self.events, key=lambda e: (e["pid"], e["tid"], e["ts"]))
        return {"traceEvents": evs,
                "otherData": {"trace_id": self.trace_id,
                              "dropped": self.dropped}}

    def save(self, path):
        data = self.chrome()
        with open(path, "w") as f:
            json.dump(data, f)
        return len(data["traceEvents"])


class NullTracer:
    """Shared no-op tracer: the off state."""

    enabled = False
    trace_id = None
    parent = None
    run_span_id = None
    events = ()
    dropped = 0

    def span(self, name, **args):
        return _NULL_SPAN

    def complete(self, name, start_s, end_s=None, **args):
        pass

    def instant(self, name, **args):
        pass

    def async_begin(self, name, id, **args):
        pass

    def async_end(self, name, id, **args):
        pass

    def start_run(self, name="run", **args):
        return None

    def finish_run(self):
        pass

    def propagate(self):
        return None

    def add_events(self, events):
        pass

    def drain(self):
        return []

    def chrome(self):
        return {"traceEvents": [], "otherData": {}}


NULL_TRACER = NullTracer()
_TRACER = NULL_TRACER


def get_tracer():
    return _TRACER


def set_tracer(tracer):
    global _TRACER
    _TRACER = tracer if tracer is not None else NULL_TRACER


def span(name, **args):
    """A span on the run's tracer and, while a profiler records, in the
    profiler as `obs/<name>`."""
    t = _TRACER
    if not _profiling():
        return t.span(name, **args) if t.enabled else _NULL_SPAN
    return _ProfiledSpan(name, t.span(name, **args) if t.enabled else None)


class _Timed:
    """A span (`span()`'s, null when off) and its host seconds, `s`."""
    __slots__ = ("_span", "_t0", "s")

    def __init__(self, span):
        self._span = span
        self.s = 0.0

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self._t0
        return self._span.__exit__(*exc)


def timed(name, **args):
    """`span(name, **args)` that also times itself: `with timed("x") as
    t: ...`, then `t.s` is the interval's host seconds."""
    return _Timed(span(name, **args))


def instant(name, **args):
    t = _TRACER
    if t.enabled:
        t.instant(name, **args)


# ---------------------------------------------------------------- schema

_REQUIRED = ("ph", "ts", "pid", "tid", "name")
_KNOWN_PH = {"B", "E", "X", "i", "I", "b", "e", "n", "M", "C"}


def validate_chrome_trace(data):
    """Schema-check a Chrome trace-event dump (dict or event list).

    Enforces: every event carries ph/ts/pid/tid/name; `ph` is a known
    phase; `X` events carry `dur`; `B`/`E` pairs balance LIFO per
    (pid, tid) with matching names.  Returns per-phase counts.
    Raises ValueError on the first violation.
    """
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    counts = {}
    stacks = {}
    for i, ev in enumerate(events):
        for k in _REQUIRED:
            if k not in ev:
                raise ValueError(f"event {i} missing {k!r}: {ev}")
        ph = ev["ph"]
        if ph not in _KNOWN_PH:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if ph == "X" and "dur" not in ev:
            raise ValueError(f"event {i} is 'X' without dur")
        counts[ph] = counts.get(ph, 0) + 1
        if ph in ("B", "E"):
            key = (ev["pid"], ev["tid"])
            stack = stacks.setdefault(key, [])
            if ph == "B":
                stack.append(ev["name"])
            else:
                if not stack:
                    raise ValueError(
                        f"event {i}: 'E' {ev['name']!r} with empty stack on {key}")
                top = stack.pop()
                if top != ev["name"]:
                    raise ValueError(
                        f"event {i}: 'E' {ev['name']!r} closes {top!r} on {key}")
    for key, stack in stacks.items():
        if stack:
            raise ValueError(f"unclosed spans {stack} on {key}")
    return counts
