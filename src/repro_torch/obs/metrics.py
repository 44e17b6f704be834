"""Process-local metrics registry: counters, gauges, histograms (the
port's copy of the reference's `obs/metrics.py`; nothing in it touches a
device).

One registry per process (module-global, swappable for tests and
benches). Instruments are named and labelled Prometheus-style:

    metrics.counter("plan_batches_total", labels=("plan",)) \
           .labels(plan="async").inc()

Design constraints, in order:

  1. Zero cost when off. `metrics.counter(...)` on a disabled registry
     returns the shared `NULL_INSTRUMENT`, whose every method is a no-op;
     enabled instruments re-check `registry.enabled` on mutation, so that
     a registry can be toggled mid-run.
  2. No wire surface beyond `snapshot()`: a plain-dict, JSON- and
     pickle-safe dump that backs the `metrics` RPC of
     `dist.service.QueueService`.
  3. Prometheus text exposition through `render()` for
     `serve.preprocess_service.PreprocessService.metrics_text()`, with no
     HTTP dependency.

The plain ledgers (`StoreStats`, the service's counters, `batch_log`,
per-batch `timings`) stay at their homes and mirror into the registry, so
that their callers and the one registry see the same numbers.
"""
from __future__ import annotations

import threading

# Latency-ish buckets (seconds), log-spaced 0.5 ms .. 30 s.
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# Fill-fraction buckets for batch occupancy (1/8 .. 1).
OCCUPANCY_BUCKETS = tuple(i / 8 for i in range(1, 9))
# Byte-size buckets, log-spaced 1 KiB .. 1 GiB.
BYTES_BUCKETS = tuple(float(1 << k) for k in range(10, 31, 2))


class _NullInstrument:
    """Shared do-nothing stand-in for every instrument kind."""
    __slots__ = ()

    def labels(self, **kv):
        return self

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    @property
    def value(self):
        return 0.0


NULL_INSTRUMENT = _NullInstrument()


class _Child:
    """One labeled series of a parent instrument (`.labels(...)` result)."""
    __slots__ = ("_parent", "_key")

    def __init__(self, parent, key):
        self._parent = parent
        self._key = key

    def inc(self, n=1):
        self._parent._inc(self._key, n)

    def dec(self, n=1):
        self._parent._inc(self._key, -n)

    def set(self, v):
        self._parent._set(self._key, v)

    def observe(self, v):
        self._parent._observe(self._key, v)

    @property
    def value(self):
        return self._parent._value(self._key)


class _Instrument:
    kind = "untyped"

    def __init__(self, registry, name, help="", label_names=()):
        self._reg = registry
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series = {}          # label-values tuple -> mutable cell
        if not self.label_names:   # unlabeled: single default series
            self._series[()] = self._new_cell()

    # -- label plumbing ---------------------------------------------------
    def labels(self, **kv):
        key = tuple(str(kv.get(k, "")) for k in self.label_names)
        if key not in self._series:
            with self._reg._lock:
                self._series.setdefault(key, self._new_cell())
        return _Child(self, key)

    def _cell(self, key):
        cell = self._series.get(key)
        if cell is None:
            with self._reg._lock:
                cell = self._series.setdefault(key, self._new_cell())
        return cell

    # -- unlabeled convenience (mirrors _Child) ---------------------------
    def inc(self, n=1):
        self._inc((), n)

    def dec(self, n=1):
        self._inc((), -n)

    def set(self, v):
        self._set((), v)

    def observe(self, v):
        self._observe((), v)

    @property
    def value(self):
        return self._value(())

    # -- per-kind cells ---------------------------------------------------
    def _new_cell(self):
        return [0.0]

    def _inc(self, key, n):
        raise TypeError(f"{self.kind} does not support inc()")

    def _set(self, key, v):
        raise TypeError(f"{self.kind} does not support set()")

    def _observe(self, key, v):
        raise TypeError(f"{self.kind} does not support observe()")

    def _value(self, key):
        cell = self._series.get(key)
        return cell[0] if cell else 0.0

    def _series_snapshot(self):
        out = []
        with self._reg._lock:
            for key, cell in sorted(self._series.items()):
                out.append({"labels": dict(zip(self.label_names, key)),
                            "value": cell[0]})
        return out


class Counter(_Instrument):
    kind = "counter"

    def _inc(self, key, n):
        if n < 0:
            raise ValueError("counters only go up")
        if self._reg.enabled:
            with self._reg._lock:
                self._cell(key)[0] += n


class Gauge(_Instrument):
    kind = "gauge"

    def _inc(self, key, n):
        if self._reg.enabled:
            with self._reg._lock:
                self._cell(key)[0] += n

    def _set(self, key, v):
        if self._reg.enabled:
            with self._reg._lock:
                self._cell(key)[0] = float(v)


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, registry, name, help="", label_names=(),
                 buckets=DEFAULT_TIME_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        super().__init__(registry, name, help, label_names)

    def _new_cell(self):
        # [per-bucket counts..., +Inf count] + [sum, count] trailer
        return {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "n": 0}

    def _observe(self, key, v):
        if not self._reg.enabled:
            return
        v = float(v)
        with self._reg._lock:
            cell = self._cell(key)
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            cell["counts"][i] += 1
            cell["sum"] += v
            cell["n"] += 1

    def _value(self, key):
        cell = self._series.get(key)
        return cell["n"] if cell else 0

    def _series_snapshot(self):
        out = []
        with self._reg._lock:
            for key, cell in sorted(self._series.items()):
                cum, counts = 0, {}
                for b, c in zip(self.buckets, cell["counts"]):
                    cum += c
                    counts[repr(b)] = cum
                counts["+Inf"] = cum + cell["counts"][-1]
                out.append({"labels": dict(zip(self.label_names, key)),
                            "buckets": counts,
                            "sum": cell["sum"], "count": cell["n"]})
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named-instrument registry.  Getter methods create-or-return, so hot
    paths can call `registry.counter(name).inc()` without pre-declaring;
    redeclaring with a different kind is an error."""

    def __init__(self, enabled=True):
        self.enabled = enabled
        self._metrics = {}
        self._lock = threading.RLock()

    # -- instrument getters ----------------------------------------------
    def _get(self, cls, name, help, label_names, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(self, name, help, label_names, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name, help="", labels=()):
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_TIME_BUCKETS):
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- export -----------------------------------------------------------
    def snapshot(self):
        """Plain-dict dump: JSON- and pickle-safe (backs the `metrics` RPC)."""
        out = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                out[name] = {"type": m.kind, "help": m.help,
                             "labels": list(m.label_names),
                             "series": m._series_snapshot()}
        return out

    def render(self):
        """Prometheus text exposition (text/plain; version=0.0.4)."""
        lines = []
        for name, m in sorted(self.snapshot().items()):
            if m["help"]:
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['type']}")
            for s in m["series"]:
                lab = _fmt_labels(s["labels"])
                if m["type"] == "histogram":
                    for le, c in s["buckets"].items():
                        blab = _fmt_labels({**s["labels"], "le": le})
                        lines.append(f"{name}_bucket{blab} {c}")
                    lines.append(f"{name}_sum{lab} {_fmt_val(s['sum'])}")
                    lines.append(f"{name}_count{lab} {s['count']}")
                else:
                    lines.append(f"{name}{lab} {_fmt_val(s['value'])}")
        return "\n".join(lines) + "\n"

    def summary_lines(self, prefix=""):
        """Compact human report: one `name{labels} value` line per non-zero
        series (histograms render count/mean).  Drives the end-of-run
        report in the launchers."""
        lines = []
        for name, m in sorted(self.snapshot().items()):
            if prefix and not name.startswith(prefix):
                continue
            for s in m["series"]:
                lab = _fmt_labels(s["labels"])
                if m["type"] == "histogram":
                    if s["count"]:
                        mean = s["sum"] / s["count"]
                        lines.append(
                            f"{name}{lab} n={s['count']} mean={mean:.6g}")
                elif s["value"]:
                    lines.append(f"{name}{lab} {_fmt_val(s['value'])}")
        return lines

    def reset(self):
        with self._lock:
            self._metrics.clear()


class NullRegistry(MetricsRegistry):
    """Disabled registry: every getter returns the shared no-op instrument,
    so instrumented code pays one attribute check and nothing else."""

    def __init__(self):
        super().__init__(enabled=False)

    def counter(self, name, help="", labels=()):
        return NULL_INSTRUMENT

    def gauge(self, name, help="", labels=()):
        return NULL_INSTRUMENT

    def histogram(self, name, help="", labels=(), buckets=DEFAULT_TIME_BUCKETS):
        return NULL_INSTRUMENT


def _fmt_labels(labels):
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
    return "{" + inner + "}"


def _escape(v):
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_val(v):
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


# ---------------------------------------------------------------- globals

_REGISTRY = MetricsRegistry()
NULL_REGISTRY = NullRegistry()


def get_registry():
    return _REGISTRY


def set_registry(registry):
    global _REGISTRY
    _REGISTRY = registry


def enabled():
    return _REGISTRY.enabled


def counter(name, help="", labels=()):
    r = _REGISTRY
    return r.counter(name, help, labels) if r.enabled else NULL_INSTRUMENT


def gauge(name, help="", labels=()):
    r = _REGISTRY
    return r.gauge(name, help, labels) if r.enabled else NULL_INSTRUMENT


def histogram(name, help="", labels=(), buckets=DEFAULT_TIME_BUCKETS):
    r = _REGISTRY
    return (r.histogram(name, help, labels, buckets)
            if r.enabled else NULL_INSTRUMENT)


def snapshot():
    return _REGISTRY.snapshot()


def render():
    return _REGISTRY.render()


def summary_lines(prefix=""):
    return _REGISTRY.summary_lines(prefix)
