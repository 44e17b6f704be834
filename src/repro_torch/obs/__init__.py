"""One observability spine for the port (the port's copy of the
reference's `obs` package; it imports nothing of the reference).

  * `obs.metrics`: the process-local registry of counters, gauges and
    histograms with Prometheus-style labels. The plans, the store, the
    master/worker runtime and the serving tier mirror into it;
    `snapshot()` backs the `metrics` RPC and `render()` is Prometheus
    text.
  * `obs.telemetry`: durable per-chunk JSONL records, written on the
    master at acceptance, so that they survive SIGKILLed workers; a reader
    aggregates them into the per-worker load ledger.
  * `obs.tracing`: spans with a run-level trace id propagated through the
    `dist` RPC surface (worker spans carry the master's parent id across
    the pickle boundary), exported as Chrome trace-event JSON.

Off is close to free: the disabled registry and the null tracer are
shared no-op objects. No hook synchronises the card: a span measures host
time, a counter takes numbers the host already holds.
"""
from repro_torch.obs import metrics, telemetry, tracing
from repro_torch.obs.metrics import (MetricsRegistry, NullRegistry,
                                     get_registry, set_registry)
from repro_torch.obs.telemetry import (TelemetryWriter, read_records,
                                       worker_ledger)
from repro_torch.obs.tracing import (NULL_TRACER, Tracer, get_tracer,
                                     set_tracer, validate_chrome_trace)

__all__ = [
    "metrics", "telemetry", "tracing",
    "MetricsRegistry", "NullRegistry", "get_registry", "set_registry",
    "TelemetryWriter", "read_records", "worker_ledger",
    "Tracer", "NULL_TRACER", "get_tracer", "set_tracer",
    "validate_chrome_trace",
]
