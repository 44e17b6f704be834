"""Execution plans: how a validated `PipelineGraph` runs on a batch stream.

The reference's plans, all ported:

  * `FusedPlan`     -- the whole chain on every chunk in one pass, removed
                       chunks masked but still denoised: the paper's
                       no-early-exit baseline, and the plan for a graph
                       without a removal point.
  * `TwoPhasePlan`  -- detection -> the host reads back the keep mask -> a
                       padded survivor-index vector -> the survivor tail on
                       the device, which gathers the survivors out of the
                       still-resident batch. MMSE cost scales with
                       surviving audio. One batch at a time: the
                       single-stream default. On the card its copies go
                       through a one-slot `core.transfer.Staging` ring.
  * `AsyncPlan`     -- the deep pipeline: a window of `depth` detection
                       batches enqueued ahead, each keep mask read back
                       without blocking as soon as its detection is
                       enqueued, power-of-two survivor buckets, reuse of
                       the plan's device input buffers (donation), and one
                       finished tail held back so that its cleaned rows
                       come back while the next batch computes. On the card
                       its copies go through `core.transfer.Staging`:
                       pinned host buffers, a copy stream one batch ahead.
  * `StreamingPlan` -- `AsyncPlan` at depth 1, linear padding, no donation
                       and no held-back tail.
  * `ShardedPlan`   -- the paper's master/worker runtime: a shared leased
                       `WorkQueue` served behind a `dist.QueueService` to
                       shards that are simulated in this process
                       (`transport="inproc"`, a survivor re-shard by the
                       `Rebalancer` between detection and the tail) or real
                       worker processes (`"proc"`, `"tcp"`: each runs
                       `two_phase` on the device its setup blob names),
                       with redelivery of a dead worker's leases,
                       speculative re-lease of stragglers and
                       completion-gated, exactly-once emission.
  * `CachedPlan`    -- any of the above behind a content-addressed
                       `store.ChunkStore` (a batch seen before is a lookup)
                       and a `store.RunJournal` (a killed run resumes,
                       each batch emitted once across the kill).

Emission is always input order, each batch exactly once. Per-batch
`BatchResult.timings` keep the reference's keys.

When the graph's post-removal chain is the canonical fused tail, `("mmse",)`
or `("hpf", "mmse")`, the survivor phase runs the fused tail kernel
(gather + [HPF] + STFT + MMSE gain in one pass, the iSTFT outside).
`fuse_tail=` overrides: None (default) engages it on a canonical tail,
False forces the staged per-stage path, True demands fusion and raises on
a non-canonical tail.

The port runs eagerly: no compile cache. Bucketing (`bucket`, `pad_multiple`)
still decides the tail's row count, as in the reference.

Observability (`repro_torch.obs`), as in the reference: every plan reports
each batch it emits into the process's metrics registry (`_record_batch`:
`plan_batches_total`, `plan_chunks_total`, `plan_survivors_total`,
`plan_src_bytes_total`, `plan_{d2h,h2d}_bytes_total`, all labelled
`{plan=...}`, and the `plan_stage_seconds{plan,stage}` histogram of the
numbers `BatchResult.timings` carries), counts how each batch `_dispatch`
takes reached the device (`plan_uploads_total{plan,path}`, the port's own:
`pinned` through a staging ring, `resident` a device tensor used where it
is, `direct` a `torch.as_tensor`), and opens spans (`obs.tracing.span`:
on the run's tracer, and in `torch.profiler` as `obs/<name>` while it
records):

  * `fused_batch` -- one fused batch; `two_phase_batch` -- one synchronous
    two_phase batch (`TwoPhasePlan.__call__`), the root of those below;
  * `detect_dispatch` -- the upload, the detection enqueue and the start of
    the keep readback, in every plan that dispatches (`_dispatch`);
  * `upload` -- a batch's copy to the device (`_to_device`: a pageable
    `torch.as_tensor`, the host blocked for the whole copy, where no
    staging ring takes the batch; or `transfer.Staging.upload`: the pinned
    `copy_` and the DMA's enqueue);
  * `stage.<name>` and `outputs` -- each stage's enqueue and the
    detection's outputs (`core.graph.PipelineGraph`);
  * `tail` -- parent of `keep_wait` (the host's wait for the keep mask),
    `compact` (the survivor indices) and `tail_dispatch` (the index upload,
    the tail's enqueue and the start of the cleaned readback; absent when
    nothing survives);
  * `emit` -- the cleaned readback's wait; `tail_rebalanced`;

and the sharded plan's process master marks `accept` and `emit_gated`
instants. `keep_wait`, `compact`, `tail_dispatch` and `emit` are
`obs.tracing.timed` spans: their own clocks give `timings`' `readback_s`,
`compact_s`, `tail_s` and `emit_s`. A two_phase batch opens about 19
spans, 38 `Tracer` events where it made 4 before them, so a `Tracer` at
its default `max_events` of 200,000 fills after some 5,000 batches and
drops the rest of the run's events, perhaps a span's `E` after its `B`
was kept. The hooks read only what the host already holds (`.numel()`,
never a copy), so they add no synchronisation of the card; with the
registry disabled each costs one attribute check, and a span with neither
a tracer nor a profiler one check of the profiler's state. `ShardedPlan`
takes `telemetry=` (a `TelemetryWriter`), which its `QueueService` writes
per chunk at acceptance.
"""
from __future__ import annotations

import collections
import math
import operator
import os
import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core import scheduler as SCHED
from repro_torch.core import transfer
from repro_torch.core.graph import (GraphValidationError, PipelineGraph,
                                    PipelineOutput)
from repro_torch.data.loader import ShardedLoader, make_shard_pool
from repro_torch.data.queue import WorkQueue
from repro_torch.device import resolve_device, worker_env
from repro_torch.distributed.sharding import NULL_RULES, is_dtensor, whole
from repro_torch.dist.data_plane import StoreDataPlane
from repro_torch.dist.service import QueueService, pack_result, unpack_result
from repro_torch.dist.transport import ProcTransport, TcpTransport
from repro_torch.ft.failure import StragglerDetector
from repro_torch.kernels import backend
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.store import ChunkStore, RunJournal, content_key

# Cap on the per-batch timing dicts `AsyncPlan.last_timings` keeps.
TIMINGS_CAP = 4096

_STAGE_KEYS = ("dispatch_s", "readback_s", "compact_s", "tail_s", "emit_s")


@dataclass
class BatchResult:
    """One batch through a plan: compacted survivors + the detection record."""
    cleaned: np.ndarray             # (n_kept, S_final) denoised survivors
    det: PipelineOutput             # detection-phase record (masks, stats)
    n_kept: int
    wid: object = None              # loader work id (when run over a stream)
    labels: object = field(default=None, repr=False)   # stream passthrough
    src_bytes: int = 0              # input bytes (throughput accounting)
    timings: dict = field(default=None, repr=False)
    # per-batch instrumentation, the reference's keys:
    #   dispatch_s  upload + detection enqueue (async plans; not compute)
    #   in_flight   detection batches in the window when this one entered
    #   readback_s  blocking part of the keep-mask readback
    #   compact_s   host index bookkeeping
    #   tail_s      tail enqueue + start of the cleaned readback
    #   emit_s      blocking part of the cleaned readback at emission
    #   d2h_bytes / h2d_bytes   host-boundary traffic this batch caused:
    #               the keep mask and the n_real cleaned rows down, the
    #               int32 index vector up (the batch upload is not counted,
    #               as in the reference)
    #   tail_rows / n_real      padded tail batch rows vs real survivors
    #   wave5_bytes, old_boundary_bytes   the full pre-denoise batch and
    #               what a host-side compaction round trip would have moved


def _record_batch(plan_name, res: BatchResult):
    """Mirror one emitted batch into the metrics registry: counters for
    volume, the `plan_stage_seconds` histogram for the per-batch timings.
    The chunk count is the keep mask's `numel()`, which a tensor on the
    card gives without a copy."""
    reg = obs_metrics.get_registry()
    if not reg.enabled:
        return
    lab = {"plan": plan_name}
    reg.counter("plan_batches_total", "batches emitted",
                ("plan",)).labels(**lab).inc()
    if res.det is not None:
        keep = res.det.keep
        n = keep.numel() if torch.is_tensor(keep) else int(np.size(keep))
        reg.counter("plan_chunks_total", "chunks processed",
                    ("plan",)).labels(**lab).inc(n)
    reg.counter("plan_survivors_total", "chunks surviving detection",
                ("plan",)).labels(**lab).inc(int(res.n_kept))
    reg.counter("plan_src_bytes_total", "input bytes consumed",
                ("plan",)).labels(**lab).inc(int(res.src_bytes))
    t = res.timings
    if not t:
        return
    for k in _STAGE_KEYS:
        if k in t:
            reg.histogram("plan_stage_seconds", "per-batch stage wall time",
                          ("plan", "stage")).labels(
                plan=plan_name, stage=k[:-2]).observe(t[k])
    for k in ("d2h_bytes", "h2d_bytes"):
        if k in t:
            reg.counter(f"plan_{k}_total", "host-boundary traffic",
                        ("plan",)).labels(**lab).inc(int(t[k]))


def _count_upload(plan_name, path):
    """Count one batch `_dispatch` brought to the device by `path`."""
    reg = obs_metrics.get_registry()
    if not reg.enabled:
        return
    reg.counter("plan_uploads_total", "batches brought to the device",
                ("plan", "path")).labels(plan=plan_name, path=path).inc()


def _iter_batches(batches):
    """Normalise a batch stream: accepts arrays, (chunks, labels) pairs, or
    (wid, (chunks, labels)) items."""
    for i, item in enumerate(batches):
        wid, payload, extra = i, item, None
        if isinstance(item, tuple) and len(item) == 2 \
                and np.ndim(item[0]) == 0:
            wid, payload = item
        if isinstance(payload, tuple):
            chunks = payload[0]
            extra = payload[1] if len(payload) > 1 else None
        else:
            chunks = payload
        yield wid, chunks, extra


@dataclass
class _Detected:
    """A batch whose detection is enqueued and whose keep mask is on its
    way to the host."""
    det: PipelineOutput
    keep: transfer.Readback
    wid: object
    extra: object
    src_bytes: int
    timings: dict


@dataclass
class _PendingTail:
    """A batch whose tail is enqueued but not yet read back: everything
    `_emit` needs, held while the device works and the cleaned rows stream
    host-ward."""
    det: PipelineOutput
    cleaned: object                 # Readback of the n_real rows (None: 0)
    n_real: int
    wid: object
    extra: object
    src_bytes: int
    timings: dict


def _whole_output(det: PipelineOutput) -> PipelineOutput:
    """A phase's output with every DTensor gathered whole: what a plan
    reads back and emits is the same on every rank."""
    if not is_dtensor(det.keep):
        return det
    return replace(det, wave5=whole(det.wave5), keep=whole(det.keep),
                   rain=whole(det.rain), silence=whole(det.silence),
                   cicada15=whole(det.cicada15))


def _mesh_device(rules, device):
    """The plan's device: `device`; with none named, the CPU under a CPU
    mesh, else the current card. A mesh on another device type than the
    plan's is refused."""
    mesh = getattr(rules, "mesh", None)
    if device is None and mesh is not None and mesh.device_type != "cuda":
        device = mesh.device_type
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"rules over a {mesh.device_type} mesh for a plan "
                         f"on {dev}")
    return dev


def _mesh_multiple(pad_multiple, pool):
    """The survivor padding multiple: `pad_multiple` rounded up to a
    multiple of every mesh's size, so the tail's rows split evenly."""
    m = max(1, int(pad_multiple))
    for rules in pool:
        if rules.mesh is not None:
            m = math.lcm(m, rules.mesh.size())
    return m


class ExecutionPlan:
    """What every plan shares: its graph, its sharding rules, its device
    (None: the card, or the mesh's device type) and the survivor padding
    multiple (rounded up to a multiple of the mesh's size); `run` maps
    `__call__` over a stream."""
    name = "base"

    def __init__(self, graph: PipelineGraph, rules=NULL_RULES,
                 pad_multiple=1, device=None):
        self.graph = graph
        self.rules = rules
        self.device = _mesh_device(rules, device)
        self.pad_multiple = _mesh_multiple(pad_multiple, [rules])

    def _to_device(self, audio):
        with obs_tracing.span("upload"):
            return torch.as_tensor(audio, dtype=torch.float32,
                                   device=self.device)

    def detect(self, audio) -> PipelineOutput:
        return _whole_output(self.graph.detection(self._to_device(audio),
                                                  self.rules))

    def __call__(self, audio) -> BatchResult:
        raise NotImplementedError

    def run(self, batches):
        for wid, chunks, extra in _iter_batches(batches):
            yield replace(self(chunks), wid=wid, labels=extra)


class FusedPlan(ExecutionPlan):
    """The whole chain on every chunk (`PipelineGraph.fused`), then the
    kept rows of the masked `wave5`, gathered on the device and read back.
    Takes any valid graph, with or without a removal point."""
    name = "fused"

    def __call__(self, audio) -> BatchResult:
        with obs_tracing.span("fused_batch"):
            x = self._to_device(audio)
            out = _whole_output(self.graph.fused(x, self.rules))
            keep = out.keep.cpu().numpy()
            idx = torch.from_numpy(np.flatnonzero(keep)).to(out.wave5.device)
            cleaned = out.wave5.index_select(0, idx).cpu().numpy()
        res = BatchResult(cleaned=cleaned, det=out, n_kept=int(keep.sum()),
                          src_bytes=x.numel() * x.element_size())
        _record_batch(self.name, res)
        return res


class TwoPhasePlan(ExecutionPlan):
    """`pad_multiple` and `bucket` set the survivor tail's row count
    (`scheduler.quantize_survivors`). `donate` lets a plan write a later
    batch into the device input buffer of an earlier one once its
    detection is enqueued (None: on for CUDA); without it each batch gets a
    fresh device tensor. It acts on the card only: there a host batch goes
    through a `transfer.Staging` ring of one slot (the one batch in
    flight), and the keep mask and the cleaned rows come back through it."""
    name = "two_phase"

    def __init__(self, graph: PipelineGraph, rules=NULL_RULES,
                 pad_multiple=1, bucket="linear", donate=False,
                 fuse_tail=None, device=None):
        if not graph.has_removal_point:
            raise GraphValidationError(
                f"plan '{self.name}' needs a 'removal_point' stage in the "
                f"graph (stages: {graph.names}); use the fused plan for "
                f"graphs without early exit")
        super().__init__(graph, rules, pad_multiple, device)
        self.bucket = bucket
        SCHED.quantize_survivors(0, 1, 1, bucket)     # validate the mode
        if donate is None:
            donate = self.device.type == "cuda"
        self.donate = bool(donate)
        spec = graph.fused_tail_spec
        if fuse_tail is None:
            fuse_tail = spec is not None
        elif fuse_tail and spec is None:
            raise GraphValidationError(
                f"fuse_tail=True but post-removal stages "
                f"{graph.names[graph._cut():]} are not the canonical "
                f"[hpf ->] mmse fused tail")
        self.fuse_tail = bool(fuse_tail)
        self.staging = (transfer.Staging(self.device, 1, self.donate)
                        if self.device.type == "cuda" else None)

    def _readback(self, t) -> transfer.Readback:
        return (transfer.Readback(t) if self.staging is None
                else self.staging.readback(t))

    def _dispatch(self, audio, wid=None, extra=None):
        """Bring a batch to the device, enqueue its detection and start the
        keep-mask readback. A batch already on the device (the caller's
        tensor) is used where it is; a host batch goes through the staging
        ring when the plan has one (`slot`: the plan's device buffer it was
        copied into, when the plan donates). `plan_uploads_total` counts
        the path taken."""
        with obs_tracing.span("detect_dispatch", wid=wid):
            resident = (torch.is_tensor(audio) and audio.device.type != "cpu"
                        and self.device.type != "cpu")
            if resident or self.staging is None:
                x, slot = self._to_device(audio), None
                _count_upload(self.name, "resident" if resident else "direct")
            else:
                x, slot = self.staging.upload(audio)
                _count_upload(self.name, "pinned")
            det = _whole_output(self.graph.detection(x, self.rules))
            if slot is not None:
                if det.wave5.untyped_storage().data_ptr() == \
                        x.untyped_storage().data_ptr():
                    # a graph whose wave5 is a view of its input: keep it
                    # out of the slot that a later batch writes
                    det = replace(det, wave5=det.wave5.clone())
                self.staging.release(slot)
            return _Detected(det, self._readback(det.keep), wid, extra,
                             x.numel() * x.element_size(), {})

    def _start_tail(self, d: _Detected) -> _PendingTail:
        """Master bookkeeping, device-resident: the host reads back only
        the keep mask, builds a padded survivor-index vector, and the tail
        gathers + denoises on the device; its n_real real rows start back
        to the host at once."""
        with obs_tracing.span("tail", wid=d.wid):
            return self._start_tail_inner(d)

    def _start_tail_inner(self, d: _Detected) -> _PendingTail:
        with obs_tracing.timed("keep_wait") as wait:
            keep = d.keep.wait()                      # the only readback
        with obs_tracing.timed("compact") as compact:
            idx, n_real = SCHED.survivor_indices(keep, self.pad_multiple,
                                                 self.bucket)
        cleaned, h2d, tail_s = None, 0, 0.0
        if n_real:
            with obs_tracing.timed("tail_dispatch") as enq:
                idx_t = torch.from_numpy(idx)
                if self.device.type == "cuda":      # no wait on the stream
                    idx_t = idx_t.pin_memory().to(self.device,
                                                  non_blocking=True)
                tail = (self.graph.tail_indexed_fused if self.fuse_tail
                        else self.graph.tail_indexed)
                cleaned = self._readback(
                    whole(tail(d.det.wave5, idx_t, self.rules))[:n_real])
            h2d, tail_s = idx.nbytes, enq.s
        wave5 = d.det.wave5
        timings = dict(d.timings)
        timings.update(
            readback_s=wait.s, compact_s=compact.s, tail_s=tail_s,
            h2d_bytes=h2d, d2h_bytes=keep.nbytes,
            tail_rows=0 if idx is None else len(idx), n_real=n_real,
            wave5_bytes=wave5.numel() * wave5.element_size())
        return _PendingTail(d.det, cleaned, n_real, d.wid, d.extra,
                            d.src_bytes, timings)

    def _emit(self, pend: _PendingTail) -> BatchResult:
        """Wait for (the rest of) the cleaned readback and build the
        result. Only the real rows come back; pad rows are zero rows of
        the device tail and never reach `cleaned`."""
        with obs_tracing.timed("emit", wid=pend.wid) as emit:
            if pend.cleaned is None:
                cleaned = np.zeros((0, pend.det.wave5.shape[-1]),
                                   np.float32)
            else:
                cleaned = pend.cleaned.wait()
                pend.timings["d2h_bytes"] += cleaned.nbytes
        pend.timings["emit_s"] = emit.s
        # what the reference's host-side compaction round trip would have
        # moved for this batch: the full wave5 and mask down, the
        # linear-padded survivor batch up and the same padded rows down
        cap = pend.det.keep.numel()
        lin_rows = SCHED.quantize_survivors(
            pend.n_real, cap, self.pad_multiple, "linear") \
            if pend.n_real else 0
        row_bytes = cleaned.shape[-1] * cleaned.dtype.itemsize
        pend.timings["old_boundary_bytes"] = (
            pend.timings["wave5_bytes"] + cap + 2 * lin_rows * row_bytes)
        res = BatchResult(cleaned=cleaned, det=pend.det,
                          n_kept=pend.n_real, wid=pend.wid,
                          labels=pend.extra, src_bytes=pend.src_bytes,
                          timings=pend.timings)
        _record_batch(self.name, res)
        return res

    def _finish(self, det: PipelineOutput, src_bytes=0) -> BatchResult:
        return self._emit(self._start_tail(_Detected(
            det, self._readback(det.keep), None, None, src_bytes, {})))

    def __call__(self, audio) -> BatchResult:
        with obs_tracing.span("two_phase_batch"):
            return self._emit(self._start_tail(self._dispatch(audio)))


class AsyncPlan(TwoPhasePlan):
    """Depth-K asynchronous streaming executor: a bounded window of `depth`
    detection batches enqueued ahead, each keep mask read back without
    blocking the moment its detection is enqueued, the tail gathering
    survivors on the device, and `emit_buffer` finished tails held back so
    that their cleaned rows come back while the next batch computes.
    Defaults to power-of-two survivor buckets and, on the card, to reuse
    of the plan's device input buffers. Emission is strictly input order;
    `last_timings` keeps the per-batch records of the most recent run().

    On the card the copies go through `transfer.Staging` with `depth + 1`
    slots. Unlike the reference, which moves the padded tail batch to the
    host, the port copies back only the n_real survivor rows and counts
    those bytes in `d2h_bytes`."""
    name = "async"

    def __init__(self, graph, rules=NULL_RULES, pad_multiple=1, depth=2,
                 bucket="pow2", donate=None, emit_buffer=1, fuse_tail=None,
                 device=None):
        super().__init__(graph, rules, pad_multiple, bucket=bucket,
                         donate=donate, fuse_tail=fuse_tail, device=device)
        self.depth = max(1, int(depth))
        # dispatched tails retained before emission: 1 double-buffers the
        # cleaned readback behind the next batch; 0 emits each result the
        # moment its tail is dispatched
        self.emit_buffer = max(0, int(emit_buffer))
        self.last_timings = collections.deque(maxlen=TIMINGS_CAP)
        if self.device.type == "cuda":
            self.staging = transfer.Staging(self.device, self.depth + 1,
                                            self.donate)

    def run(self, batches):
        self.last_timings = collections.deque(maxlen=TIMINGS_CAP)
        dets = collections.deque()       # detection window (<= depth)
        tails = collections.deque()      # dispatched tails

        def start_oldest_tail():
            tails.append(self._start_tail(dets.popleft()))

        def emit_oldest():
            res = self._emit(tails.popleft())
            self.last_timings.append(res.timings)
            return res

        for wid, chunks, extra in _iter_batches(batches):
            t0 = time.perf_counter()
            in_flight = len(dets) + 1
            d = self._dispatch(chunks, wid, extra)
            d.timings.update(dispatch_s=time.perf_counter() - t0,
                             in_flight=in_flight)
            dets.append(d)
            if len(dets) > self.depth:
                start_oldest_tail()
            while len(tails) > self.emit_buffer:
                yield emit_oldest()
        while dets:
            start_oldest_tail()
            while len(tails) > self.emit_buffer:
                yield emit_oldest()
        while tails:
            yield emit_oldest()


class StreamingPlan(AsyncPlan):
    """Two-phase with one batch of dispatch-ahead: detection of batch k+1
    is already enqueued while the host does batch k's mask readback,
    compaction, tail dispatch and emission. Depth 1, linear tail padding,
    no donation, no emission hold-back: `async` with the dials turned
    down."""
    name = "streaming"

    def __init__(self, graph, rules=NULL_RULES, pad_multiple=1, depth=1,
                 bucket="linear", donate=False, emit_buffer=0,
                 fuse_tail=None, device=None):
        super().__init__(graph, rules, pad_multiple, depth=depth,
                         bucket=bucket, donate=donate,
                         emit_buffer=emit_buffer, fuse_tail=fuse_tail,
                         device=device)


class _StreamMeta:
    """ShardedPlan's marker for a plain stream's items: carries the
    original stream wid and labels through the queue as the item's
    `extra`, distinct from user labels that happen to be tuples."""
    __slots__ = ("wid", "labels")

    def __init__(self, wid, labels):
        self.wid = wid
        self.labels = labels


def _merge_outputs(outs):
    """Concatenate per-shard PipelineOutputs (row order kept) with
    chunk-count-weighted stats: the batch reads as if one shard detected
    it."""
    if len(outs) == 1:
        return outs[0]
    cat = lambda f: torch.cat([getattr(o, f) for o in outs])  # noqa: E731
    ws = np.array([float(o.stats["n_chunks5"]) for o in outs])
    stats = {"n_chunks5": int(ws.sum())}
    for k in outs[0].stats:
        if k != "n_chunks5":
            vals = np.array([float(o.stats[k]) for o in outs])
            stats[k] = float((vals * ws).sum() / ws.sum())
    return PipelineOutput(wave5=cat("wave5"), keep=cat("keep"),
                          rain=cat("rain"), silence=cat("silence"),
                          cicada15=cat("cicada15"), stats=stats)


class FleetControl:
    """Live handle on a process fleet, published as `plan.fleet` while
    `ShardedPlan._run_proc` runs (and left in place afterwards for the
    service's worker ledger): spawn a late joiner, drain a worker out
    gracefully, SIGKILL one or SIGSTOP-stall one. The chaos harness
    (`ft.chaos`) drives it. A late joiner goes through the same
    `spawn_worker` + `hello` as the original fleet."""

    def __init__(self, plan, service, transport, handles):
        self.plan = plan
        self.service = service
        self.transport = transport
        self.handles = handles          # shard -> WorkerHandle (live dict,
                                        # shared with the emit loop)
        self._next = max(handles, default=-1) + 1
        self._lock = threading.Lock()

    def live(self):
        """shard -> WorkerHandle for workers whose process still runs."""
        return {k: h for k, h in list(self.handles.items())
                if h.poll() is None}

    def spawn(self, shard=None):
        """Spawn a worker (the next free shard id unless given). Its shard
        id is reserved with the service registry against the child's pid
        and adopted at its `hello`, never passed on the command line."""
        with self._lock:
            if shard is None:
                shard = self._next
            self._next = max(self._next, int(shard) + 1)
        h = self.transport.spawn_worker(
            shard, lease_items=self.plan.lease_items,
            poll_s=self.plan.worker_poll_s,
            env_extra=worker_env(self.plan.device, int(shard)))
        self.service.reserve(h.pid, int(shard))
        self.handles[int(shard)] = h
        if self.plan.injector is not None:
            self.plan.injector.attach(int(shard), h.pid)
        return h

    def drain(self, shard):
        """Ask one worker to leave gracefully (finish held leases, take no
        more, exit through bye)."""
        return self.service.drain(self.handles[int(shard)].worker)

    def kill(self, shard):
        """SIGKILL one worker: it dies holding whatever it holds."""
        self.handles[int(shard)].kill()

    def stall(self, shard, seconds=None):
        """SIGSTOP one worker, SIGCONT after `seconds` (a genuine
        straggler: its lease clock ticks, it sends no heartbeats)."""
        self.handles[int(shard)].stall(seconds)

    def resume_all(self):
        """SIGCONT every worker (teardown: a stopped process holds a
        SIGTERM, and its card memory, until it is continued)."""
        for h in list(self.handles.values()):
            h.resume()


class ShardedPlan(TwoPhasePlan):
    """Fault-tolerant multi-shard execution over a shared leased WorkQueue,
    served by this plan (the master) to its workers over a transport
    (`repro_torch.dist`).

    In-process mode (`transport="inproc"`): the simulated round loop, one
    round = every live shard pulls up to `lease_items`, every queue
    mutation routed through the `QueueService`:

      pull    each live shard leases work ids from the shared queue and
              runs detection on the plan's device; a `CrashInjector` can
              kill a shard mid-pull, leaving its lease open (recovered by
              lease expiry or `fail_worker`, the paper's crashed-slave
              re-send).
      shuffle only the keep masks come to the host: the `Rebalancer`
              packs the survivors in (shard, item) order and re-slices
              them near-evenly across the live shards. The survivors are
              gathered, split and padded as device tensors.
      finish  the staged tail (`graph.tail`: the STFT and MMSE kernels on
              the card) runs on each re-balanced slot; the cleaned rows
              come to the host once per round and go back to their work
              ids; `queue.complete` gates emission, each id exactly once.

    Process mode (`transport="proc"` or `"tcp"`): real worker processes
    (`repro_torch.dist.worker`) lease in batches over the transport, fetch
    host chunk batches from the master (or a shared store, `data_plane=`),
    run `two_phase` on the device the setup blob names (this plan's device
    type) and push numpy results back; the master completes each work id
    (the exactly-once gate), runs the Rebalancer on the returned masks as
    the paper's Figs 14-16 ledger, emits in ascending work-id order,
    SIGKILLs armed by the `CrashInjector` land on real pids, and dead
    processes are reclaimed through `fail_worker` or lease expiry. On the
    card the master builds every kernel library before the first spawn,
    so that the workers only load them. With more than one card, shard k
    is pinned to card k mod count (`CUDA_VISIBLE_DEVICES`); with one,
    every worker shares it (each its own CUDA context). Workers inherit
    this process's environment (`OMP_NUM_THREADS` sets a CPU worker's
    threads).

    `__call__` (the serve path) always row-splits in-process. `rules` is
    one ShardingRules shared by every shard or one a shard
    (`distributed.sharding.pool_rules`): an in-process shard runs its
    detection and tail under its own rules, on its mesh's device, several
    shards on one card sharing it; a shard's rows must then split evenly
    over its mesh. Worker processes run unmeshed. `telemetry` (a
    `obs.telemetry.TelemetryWriter`) goes to the QueueService of either
    mode, which writes the per-chunk records on the master.

    Elasticity (process mode): `worker_poll_s` is a worker's sleep after
    an empty lease; `speculate` re-leases an item once it has run
    `straggler_factor` x the p95 of at least `straggler_min_history`
    completed items' latencies; `elastic=True` (set by `ft.chaos`) stops
    the master failing the run the moment every worker process has
    exited, since a joiner may be a spawn away; `stall_timeout_s` stays
    the backstop.
    """
    name = "sharded"
    accepts_rules_pool = True

    def __init__(self, graph, rules=NULL_RULES, pad_multiple=1, shards=2,
                 lease_items=1, injector=None, monitor=None,
                 transport="inproc", worker_poll_s=0.05,
                 stall_timeout_s=300.0, lease_timeout_s=None,
                 speculate=None, straggler_factor=2.0,
                 straggler_min_history=4, elastic=False, data_plane=None,
                 telemetry=None, device=None):
        shards = max(1, int(shards))
        if isinstance(rules, (list, tuple)):
            if len(rules) != shards:
                raise ValueError(
                    f"got {len(rules)} per-shard rules for {shards} "
                    f"shards")
            pool = tuple(rules)
        else:
            pool = (rules,) * shards
        super().__init__(graph, pool[0], pad_multiple, device=device)
        self.staging = None     # the shards copy with `_to_device`, `.cpu()`
        for r in pool[1:]:
            _mesh_device(r, self.device.type)
        self.rules_pool = pool
        self.pad_multiple = _mesh_multiple(self.pad_multiple, pool)
        self.shards = shards
        self.lease_items = max(1, int(lease_items))
        self.injector = injector
        self.monitor = monitor
        self.transport = transport
        self.worker_poll_s = float(worker_poll_s)
        self.stall_timeout_s = float(stall_timeout_s)
        # lease deadline of the plan's internal queue (plain-stream runs;
        # a caller's pool brings its own queue); None: the transport's
        # default_lease_timeout
        self.lease_timeout_s = lease_timeout_s
        # speculative re-lease of stragglers; None: on for worker
        # processes, off for the simulated loop (where a duplicate only
        # burns the one host)
        self.speculate = speculate
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_history = int(straggler_min_history)
        self.elastic = bool(elastic)
        self.data_plane = data_plane
        self.telemetry = telemetry
        self.fleet = None               # FleetControl while _run_proc lives
        kind = self._transport_kind()   # validate early, not mid-stream
        if data_plane is not None and kind == "inproc":
            raise ValueError("data_plane= rides the proc/tcp worker "
                             "runtime; the in-process loop never "
                             "serialises chunks")
        self.rebalancer = SCHED.Rebalancer(self.shards, self.pad_multiple)
        self.redeliveries = 0           # mirrored off the queue after run()
        self.speculations = 0
        self.speculations_lost = 0
        self.last_assignment = None     # the last round's ShardAssignment
        self.worker_stats = None        # per-worker report of the last run
        self.fleet_start_s = None       # proc: run start to the last hello
        self._release = None            # stream-item drop hook (see run())

    @staticmethod
    def default_lease_timeout(kind) -> float:
        """Lease deadline for a queue served over transport `kind`: 300 s
        for worker processes, whose first item pays their start-up, else
        60 s."""
        return 300.0 if kind in ("proc", "tcp") else 60.0

    def _transport_kind(self) -> str:
        t = self.transport
        if isinstance(t, str):
            if t not in ("inproc", "proc", "tcp"):
                raise ValueError(f"unknown transport {t!r} "
                                 "(expected 'inproc', 'proc' or 'tcp')")
            return t
        kind = getattr(t, "name", None)
        if kind not in ("inproc", "proc", "tcp"):
            raise ValueError(f"transport object {t!r} names no known kind")
        return kind

    # -- per-shard phases, each under its shard's rules ---------------------
    def _detect_on(self, shard, x):
        return _whole_output(self.graph.detection(x, self.rules_pool[shard]))

    def _tail_on(self, shard, batch):
        return whole(self.graph.tail(batch, self.rules_pool[shard]))

    # -- single batch: row-split across shards, rebalance, reassemble -------
    def __call__(self, audio) -> BatchResult:
        x = self._to_device(audio)
        dets = [self._detect_on(j, p)
                for j, p in enumerate(torch.tensor_split(x, self.shards))
                if len(p)]
        keeps = [d.keep.cpu().numpy() for d in dets]
        cleaned, asg = self._rebalanced_tail(
            [(d.wave5, k) for d, k in zip(dets, keeps)], keeps, len(dets))
        self.last_assignment = asg
        res = BatchResult(cleaned=cleaned, det=_merge_outputs(dets),
                          n_kept=int(sum(k.sum() for k in keeps)),
                          src_bytes=x.numel() * x.element_size())
        _record_batch(self.name, res)
        return res

    def _rebalanced_tail(self, item_waves_keeps, shard_keeps, n_live):
        """The rebalanced tail. item_waves_keeps: [(wave5 on the device,
        host keep mask)] per detected item in packed order; shard_keeps:
        one concatenated keep mask per live shard (the same order). The
        survivors are gathered, re-sliced and padded on the device and
        each slot runs `graph.tail`; the cleaned rows come to the host in
        one copy. Returns (cleaned rows in packed survivor order,
        ShardAssignment)."""
        with obs_tracing.span("tail_rebalanced", live=n_live):
            return self._rebalanced_tail_inner(item_waves_keeps, shard_keeps,
                                               n_live)

    def _rebalanced_tail_inner(self, item_waves_keeps, shard_keeps, n_live):
        asg = self.rebalancer.assign(shard_keeps, out_shards=n_live)
        surv = []
        for wave, keep in item_waves_keeps:
            idx = np.flatnonzero(keep)
            if len(idx):
                surv.append(wave.index_select(
                    0, torch.from_numpy(idx).to(wave.device)))
        if not surv:
            width = (item_waves_keeps[0][0].shape[1]
                     if item_waves_keeps else 0)
            return np.zeros((0, width), np.float32), asg
        packed = torch.cat(surv) if len(surv) > 1 else surv[0]
        cleaned = torch.empty_like(packed)
        for slot, batch, n_real in self.rebalancer.split(packed, asg):
            lo = int(asg.bounds[slot])
            cleaned[lo:lo + n_real] = self._tail_on(slot, batch)[:n_real]
        return cleaned.cpu().numpy(), asg

    # -- streams ------------------------------------------------------------
    def run(self, batches):
        """Takes a ShardedLoader pool (all over one WorkQueue) or any plain
        batch stream, which is wrapped behind an internal WorkQueue. Sized
        streams (lists, SizedIter) are drawn lazily and each item is
        dropped once its work id completes; only unsized generators are
        drawn in full first."""
        if isinstance(batches, (list, tuple)) and batches and \
                all(isinstance(b, ShardedLoader) for b in batches):
            yield from self.run_pool(list(batches))
            return
        n = operator.length_hint(batches, -1)
        it = _iter_batches(batches)
        if n < 0:
            drained = list(it)
            n, it = len(drained), iter(drained)
        store, cursor = {}, [0]
        draw = threading.Lock()    # proc fetches come from handler threads

        def make(i):
            with draw:
                while cursor[0] <= i:
                    wid, chunks, extra = next(it)
                    store[cursor[0]] = (chunks, _StreamMeta(wid, extra))
                    cursor[0] += 1
                return store[i]

        timeout = self.lease_timeout_s
        if timeout is None:
            timeout = self.default_lease_timeout(self._transport_kind())
        pool = make_shard_pool(make, n, self.shards,
                               lease_items=self.lease_items,
                               lease_timeout_s=timeout)
        self._release = store.pop
        try:
            yield from self.run_pool(pool)
        finally:
            self._release = None

    def run_pool(self, pool):
        # shard-ascending order keeps the packed survivor order consistent
        # with the per-shard masks handed to the Rebalancer
        pool = sorted(pool, key=lambda ld: ld.shard)
        queue = pool[0].queue
        assert all(ld.queue is queue for ld in pool), \
            "a shard pool must share one WorkQueue"
        bad = sorted({ld.shard for ld in pool} - set(range(self.shards)))
        if bad:
            raise ValueError(
                f"pool shard ids {bad} out of range for a "
                f"{self.shards}-shard plan")
        if self._transport_kind() in ("proc", "tcp"):
            yield from self._run_proc(pool, queue)
        else:
            yield from self._run_sim(pool, queue)

    def _make_straggler(self, kind):
        """The speculation arm: a StragglerDetector for the QueueService,
        or None (speculate=None: on for worker processes only)."""
        on = (kind in ("proc", "tcp")) if self.speculate is None \
            else bool(self.speculate)
        if not on:
            return None
        return StragglerDetector(factor=self.straggler_factor,
                                 min_history=self.straggler_min_history)

    def _finish_run(self, service, queue):
        self.redeliveries = queue.redeliveries
        self.speculations = queue.speculations
        self.speculations_lost = queue.speculations_lost
        self.worker_stats = service.worker_report()

    # -- in-process master: the simulated round loop ------------------------
    def _run_sim(self, pool, queue):
        service = QueueService(queue, monitor=self.monitor,
                               telemetry=self.telemetry,
                               straggler=self._make_straggler("inproc"))
        # every queue mutation flows through the service (delegation
        # under the queue's lock), so the per-worker ledger accrues as in
        # process mode
        for ld in pool:
            ld.queue = service
        try:
            stalls = 0
            while not service.finished:
                round_work = []      # (shard, wid, det, extra, nbytes)
                for ld in pool:
                    if not self._alive(ld.shard):
                        continue
                    # one beat per live shard per round
                    service.note_beat(ld.worker)
                    for wid, item in ld.pull():
                        if self.injector is not None and \
                                not self.injector.on_pull(ld.shard):
                            break    # died holding this lease
                        chunks, extra = item if isinstance(item, tuple) \
                            else (item, None)
                        x = self._to_device(chunks)
                        round_work.append((ld.shard, wid,
                                           self._detect_on(ld.shard, x),
                                           extra,
                                           x.numel() * x.element_size()))
                if round_work:
                    stalls = 0
                    yield from self._finish_round(service, round_work)
                    continue
                if self._reclaim(service, pool) or service.finished:
                    continue
                deadline = service.next_deadline()
                stalls += 1
                if deadline is not None and stalls <= 8 and \
                        any(self._alive(ld.shard) for ld in pool):
                    # a lease nothing declared dead is still ticking: wait
                    # out its deadline so that the next pull reaps and
                    # redelivers it (injected clocks do not advance while
                    # this sleeps: they re-poll into the stall cap)
                    if queue.clock in (time.monotonic, time.time):
                        time.sleep(max(0.0, min(deadline - queue.clock(),
                                                queue.lease_timeout_s))
                                   + 1e-3)
                    continue
                raise RuntimeError(
                    "sharded plan stalled: work is leased but no live "
                    f"shard can make progress (progress "
                    f"{service.progress()})")
        finally:
            for ld in pool:
                ld.queue = queue
        self._finish_run(service, queue)

    def _finish_round(self, service, round_work):
        """The rebalanced tail of one round, then exactly-once emission in
        the round's order."""
        live = sorted({s for s, *_ in round_work})
        keeps = [d.keep.cpu().numpy() for _, _, d, _, _ in round_work]
        # packed in (shard, item) order == round_work order (pool order),
        # so the per-shard masks are contiguous slices of it
        shard_keeps = [np.concatenate(
            [k for (s, *_), k in zip(round_work, keeps) if s == s2])
            for s2 in live]
        cleaned_all, asg = self._rebalanced_tail(
            [(d.wave5, k) for (_, _, d, _, _), k in zip(round_work, keeps)],
            shard_keeps, len(live))
        self.last_assignment = asg
        offs = np.concatenate(
            [[0], np.cumsum([k.sum() for k in keeps])]).astype(int)
        for i, (shard, wid, det, extra, nbytes) in enumerate(round_work):
            if not service.complete([wid]):
                continue             # redelivery raced a straggler
            cleaned = cleaned_all[offs[i]:offs[i + 1]]
            service.note_done(f"shard{shard}", wid=wid,
                              survivors=int(offs[i + 1] - offs[i]),
                              bytes_out=cleaned.nbytes)
            if self._release is not None:
                self._release(wid, None)     # drop the buffered stream item
            orig_wid, labels = (extra.wid, extra.labels) \
                if isinstance(extra, _StreamMeta) else (wid, extra)
            res = BatchResult(cleaned=cleaned, det=det,
                              n_kept=int(offs[i + 1] - offs[i]),
                              wid=orig_wid, labels=labels, src_bytes=nbytes)
            _record_batch(self.name, res)
            yield res

    def _alive(self, shard):
        return self.injector is None or self.injector.alive(shard)

    def _reclaim(self, queue, pool):
        """All pending work is held by dead shards: return their leases
        (the injector's or the heartbeat monitor's verdict). True if any
        work came back."""
        dead_workers = {ld.worker for ld in pool if not self._alive(ld.shard)}
        if self.monitor is not None:
            dead_workers |= set(self.monitor.dead())
        got = 0
        for w in sorted(dead_workers):
            got += len(queue.fail_worker(w))
        return got > 0

    # -- proc master: real worker processes over the transport --------------
    def _proc_setup(self):
        """The picklable blob workers build their plan from: the port's
        config, stage names, pad/bucket, the device type to run on and the
        backend mode."""
        return {"cfg": self.graph.cfg, "stages": list(self.graph.names),
                "source_channels": self.graph.source_geom.channels,
                "pad_multiple": self.pad_multiple, "bucket": self.bucket,
                "device": self.device.type,
                "backend_mode": backend.get_mode()}

    def _run_proc(self, pool, queue):
        t_start = time.monotonic()
        self.fleet = None           # not the last run's, until this one's
        make_item = pool[0].make_item
        extras = {}                 # wid -> labels/_StreamMeta, master-side

        def fetch(wid):
            """Materialise the batch on the master and ship only its host
            f32 bytes (labels stay here for emission). None once the id is
            done: a redelivered lease that lost the race to a straggler's
            completion skips it."""
            if queue.is_done(wid):
                return None
            try:
                item = make_item(wid)
            except KeyError:
                # completed and released between the check and the read
                if queue.is_done(wid):
                    return None
                raise
            chunks, extra = item if isinstance(item, tuple) \
                else (item, None)
            extras[wid] = extra
            return _host_f32(chunks)

        dp = self.data_plane
        if dp is not None and not isinstance(dp, StoreDataPlane):
            # CachedPlan's value identity, so that raw entries dedup across
            # runs of the same graph on the same device type
            dp = StoreDataPlane(dp, graph_fingerprint=self.graph.fingerprint,
                                framework_tag=backend.framework_tag(
                                    self.device))
        service = QueueService(queue, fetch_item=fetch,
                               setup=self._proc_setup(),
                               monitor=self.monitor,
                               telemetry=self.telemetry,
                               straggler=self._make_straggler("proc"),
                               data_plane=dp)
        if not isinstance(self.transport, str):
            tp = self.transport
        else:
            tp = TcpTransport() if self.transport == "tcp" \
                else ProcTransport()
        handles = {}
        if self.injector is not None:
            def on_grant(worker, wid):
                # a doomed shard is SIGKILLed the moment its fatal lease is
                # granted, so it dies holding the lease
                self.injector.on_pull(service.workers[worker].shard)
            service.on_grant = on_grant
        snap = queue.state()
        order = [i for i in range(snap["n_items"])
                 if i not in set(snap["done"])]
        if self.device.type == "cuda":
            # every worker loads the same libraries: build them once here
            from repro_torch.kernels import _build
            _build.build()
        try:
            tp.serve(service)
            self.fleet = FleetControl(self, service, tp, handles)
            for k in range(self.shards):
                self.fleet.spawn(k)
            yield from self._proc_emit_loop(service, queue, handles,
                                            extras, order)
            # the queue is drained: give workers a moment to observe
            # `finished` and sign off (bye carries their stats)
            deadline = time.monotonic() + 5.0
            for h in list(handles.values()):
                try:
                    h.proc.wait(max(0.0, deadline - time.monotonic()))
                except Exception:
                    pass
        finally:
            if self.fleet is not None:
                self.fleet.resume_all()   # never TERM a stopped worker
            for h in list(handles.values()):
                h.shutdown()
            tp.close()
            # the ledger is kept for a failed run too (post-mortem)
            joined = [st.joined_at for st in service.workers.values()
                      if st.joined_at is not None]
            self.fleet_start_s = max(joined) - t_start if joined else None
            self._finish_run(service, queue)

    def _proc_emit_loop(self, service, queue, handles, extras, order):
        """Drain worker results, gate on completion (exactly once), emit in
        ascending work-id order, and reclaim dead worker processes fast
        through fail_worker."""
        buffered = {}
        emit_i = 0
        reclaimed = set()
        last_progress = time.monotonic()
        while emit_i < len(order):
            drained = service.pop_results()
            if drained:
                last_progress = time.monotonic()
                # store plane: pushes are key refs, materialised here,
                # off the handler threads
                drained = [(w, wid, service.resolve_result(p))
                           for w, wid, p in drained]
                self._note_assignment(service, drained)
            for worker, wid, payload in drained:
                # the winner's name rides into complete() so that a lost
                # speculation race is charged to the other incarnation
                if not queue.complete([wid], worker=worker):
                    continue        # redelivery raced a straggler
                det, f = unpack_result(payload)
                # acceptance: counted, and the durable telemetry point
                service.note_done(worker, wid=wid, survivors=f["n_kept"],
                                  bytes_out=f["cleaned"].nbytes)
                obs_tracing.instant("accept", wid=wid, worker=worker)
                buffered[wid] = (det, f)
            progressed = bool(drained)
            while emit_i < len(order) and order[emit_i] in buffered:
                wid = order[emit_i]
                emit_i += 1
                det, f = buffered.pop(wid)
                if self._release is not None:
                    self._release(wid, None)
                extra = extras.pop(wid, None)
                orig_wid, labels = (extra.wid, extra.labels) \
                    if isinstance(extra, _StreamMeta) else (wid, extra)
                # the gap between a chunk's "accept" and this instant is
                # time spent buffered behind a straggler
                obs_tracing.instant("emit_gated", wid=wid,
                                    buffered=len(buffered))
                res = BatchResult(cleaned=f["cleaned"], det=det,
                                  n_kept=f["n_kept"], wid=orig_wid,
                                  labels=labels, src_bytes=f["src_bytes"])
                _record_batch(self.name, res)
                yield res
            if emit_i >= len(order) or progressed:
                continue
            # no progress this tick: look for dead workers to reclaim
            # (`handles` is live: late joiners appear through plan.fleet).
            # A worker that exited draining or departed left holding
            # nothing and is not marked dead.
            for k, h in list(handles.items()):
                if k in reclaimed or h.poll() is None or queue.finished:
                    continue
                reclaimed.add(k)
                st = service.workers.get(h.worker)
                if st is not None and st.state in ("draining", "departed"):
                    continue
                service.fail_worker(h.worker)
            if self.monitor is not None:
                for w in sorted(set(self.monitor.dead())):
                    service.fail_worker(w)
                    self.monitor.forget(w)
            if not self.elastic \
                    and all(h.poll() is not None for h in handles.values()) \
                    and not queue.finished:
                raise RuntimeError(
                    "sharded plan stalled: every worker process exited "
                    f"with work outstanding (progress {queue.progress()})")
            if time.monotonic() - last_progress > self.stall_timeout_s:
                raise RuntimeError(
                    f"sharded plan stalled: no worker progress for "
                    f"{self.stall_timeout_s:.0f}s "
                    f"(progress {queue.progress()})")
            time.sleep(0.01)

    def _note_assignment(self, service, drained):
        """The paper's Figs 14-16 ledger in process mode: the Rebalancer
        on the masks this drain returned, grouped per source shard. No
        data moves (each worker denoised its own leases); the would-be
        re-shard is the measurement."""
        by_shard = {}
        for worker, wid, payload in drained:
            st = service.workers.get(worker)
            shard = st.shard if st is not None else -1
            by_shard.setdefault(shard, []).append(
                np.asarray(payload["keep"]))
        keeps = [np.concatenate(v) for _, v in sorted(by_shard.items())]
        if keeps:
            self.last_assignment = self.rebalancer.assign(
                keeps, out_shards=len(keeps))


class SizedIter:
    """One-shot iterable with a length hint: a stream drawn lazily whose
    length CachedPlan can learn without drawing it (its miss stream to the
    inner plan, the launcher's synthetic stream)."""

    def __init__(self, it, n):
        self._it, self._n = iter(it), n

    def __iter__(self):
        return self._it

    def __length_hint__(self):
        return self._n


def _host_f32(chunks) -> np.ndarray:
    """A raw batch (array, or tensor on any device) as host f32: what the
    content key hashes and the inner plan receives."""
    if torch.is_tensor(chunks):
        chunks = chunks.detach().cpu()
    return np.asarray(chunks, np.float32)


def _facade_rules(rules):
    """One rules object for facade-level work when a per-shard list is
    given: its first."""
    if isinstance(rules, (list, tuple)):
        return rules[0] if rules else NULL_RULES
    return rules


def _check_rules_pool(rules, plan_cls, what):
    if isinstance(rules, (list, tuple)) and not (
            isinstance(plan_cls, type)
            and getattr(plan_cls, "accepts_rules_pool", False)):
        raise ValueError(
            f"a per-shard rules list is only valid with {what}, not "
            f"{getattr(plan_cls, 'name', plan_cls)!r}")


class CachedPlan(ExecutionPlan):
    """Content-addressed caching and resumability around any inner plan.

    Every batch is keyed by the content hash of (raw chunk bytes, graph
    fingerprint, framework tag `torch-<device type>`, with `-matmul` under
    backend mode "matmul": `backend.framework_tag`) and looked up in the
    `ChunkStore` before any dispatch; only misses flow through the inner
    plan (one sub-stream); results merge back in stream order, and fresh
    ones are written to the store as the inner plan emits them.

    With a `RunJournal` the plan snapshots its emission queue before every
    result it yields; `resume=True` restores that snapshot and skips
    exactly the batches the dead process emitted, so each is emitted once
    across the kill. Results the dead run computed but never emitted come
    back as store hits.

    `store=None` is a pass-through. A store given as a path evicts and
    recomputes a corrupt entry (`evict_corrupt=True`); pass a `ChunkStore`
    for archival strictness. A hit's `det` holds masks and stats as CPU
    tensors and a zero `wave5` of the right shape: the pre-denoise waveform
    is not stored. A per-shard rules list (`pool_rules`) goes to a sharded
    inner plan; any other inner plan refuses one."""

    name = "cached"
    accepts_rules_pool = True

    def __init__(self, graph, rules=NULL_RULES, pad_multiple=1,
                 inner="two_phase", store=None, journal=None, resume=False,
                 device=None, **inner_kwargs):
        inner_cls = PLANS[inner] if isinstance(inner, str) else inner
        _check_rules_pool(rules, inner_cls, "the sharded plan as inner")
        super().__init__(graph, _facade_rules(rules), pad_multiple, device)
        self.inner = inner_cls(graph, rules, pad_multiple,
                               device=self.device, **inner_kwargs)
        if isinstance(store, (str, os.PathLike)):
            store = ChunkStore(store, evict_corrupt=True)
        self.store = store
        if journal is True:
            if store is None:
                raise ValueError(
                    "journal=True derives the journal path from the store "
                    "directory: pass a store, or an explicit journal")
            journal = os.path.join(store.directory, "journal")
        if isinstance(journal, (str, os.PathLike)):
            journal = RunJournal(journal)
        self.journal = journal
        self.resume = bool(resume)
        if self.resume and self.journal is None:
            raise ValueError("resume=True needs a journal")

    @property
    def stats(self):
        """The store's hit/miss/bytes accounting (None when uncached)."""
        return self.store.stats if self.store is not None else None

    def _key(self, chunks_np):
        return content_key(chunks_np, self.graph.fingerprint,
                           backend.framework_tag(self.device))

    def _result(self, arrays, meta, wid, extra) -> BatchResult:
        det, f = unpack_result({**arrays, **meta})
        res = BatchResult(cleaned=f["cleaned"], det=det, n_kept=f["n_kept"],
                          wid=wid, labels=extra, src_bytes=f["src_bytes"])
        # a hit bypasses the inner plan, so it is counted here; misses are
        # counted where the inner plan emits them
        _record_batch(self.name, res)
        return res

    def __call__(self, audio) -> BatchResult:
        if self.store is None:
            return self.inner(audio)
        x = _host_f32(audio)
        key = self._key(x)
        hit = self.store.get(key, src_bytes=x.nbytes)
        if hit is not None:
            return self._result(*hit, wid=None, extra=None)
        res = self.inner(x)
        self.store.put_payload(key, pack_result(res))
        return res

    def run(self, batches):
        """BatchResults in stream order. The queue completes and the
        journal records immediately before each yield, so an abandoned
        generator resumes from the next batch it did not emit.

        Sized streams are drawn lazily: hits in the stream-order prefix
        are emitted during the probe, and raw batches are held only for
        misses, each released as the inner plan draws it. An unsized
        generator is drawn in full first, to learn the stream length that
        the journal and the resume guard need."""
        n = operator.length_hint(batches, -1)
        it = _iter_batches(batches)
        if n < 0:
            drained = list(it)
            n, it = len(drained), iter(drained)

        done, want_key0 = set(), None
        if self.journal is not None and self.resume:
            rec_meta = self.journal.load()
            if rec_meta is not None:
                rec_n = int(rec_meta["queue"]["n_items"])
                if rec_n != n:
                    raise ValueError(
                        f"journal records a {rec_n}-item stream; the "
                        f"resume stream has {n} items: refusing to mix "
                        f"runs")
                done = set(rec_meta["queue"]["done"])
                want_key0 = rec_meta.get("stream_key0")
        queue = WorkQueue.from_state({"n_items": n, "done": sorted(done)})
        order = [p for p in range(n) if p not in done]
        emit_idx = 0
        key0 = None                       # stream identity: first batch key
        results: dict[int, BatchResult] = {}
        misses = []                       # [pos, key, wid, chunks, extra]

        def emit_ready():
            """Completion-gated hand-off of the ready stream-order prefix."""
            nonlocal emit_idx
            while emit_idx < len(order) and order[emit_idx] in results:
                pos = order[emit_idx]
                emit_idx += 1
                queue.complete([pos])
                if self.journal is not None:
                    self.journal.record(queue, meta={"stream_key0": key0})
                yield results.pop(pos)

        for pos, (wid, chunks, extra) in enumerate(it):
            probe = pos not in done and self.store is not None
            if probe or (pos == 0 and self.journal is not None):
                x = _host_f32(chunks)
                key = self._key(x)
                if pos == 0:
                    key0 = key
                    if want_key0 is not None and want_key0 != key0:
                        raise ValueError(
                            "journal records a stream with different "
                            "content (first-batch key mismatch): refusing "
                            "to mix runs")
            if pos in done:
                continue                  # the killed run already emitted it
            if not probe:                 # uncached: everything is a miss
                misses.append([pos, None, wid, chunks, extra])
                continue
            hit = self.store.get(key, src_bytes=x.nbytes)
            if hit is not None:
                results[pos] = self._result(*hit, wid=wid, extra=extra)
                yield from emit_ready()   # warm prefixes flow immediately
            else:
                misses.append([pos, key, wid, x, extra])

        if misses:
            def miss_stream():
                for i, m in enumerate(misses):
                    item = (i, (m[3], m[4]))
                    m[3] = None           # the inner plan owns the bytes now
                    yield item

            for res in self.inner.run(SizedIter(miss_stream(),
                                                 len(misses))):
                pos, key, wid, _, extra = misses[res.wid]
                if self.store is not None:
                    self.store.put_payload(key, pack_result(res))
                results[pos] = replace(res, wid=wid, labels=extra)
                yield from emit_ready()
        yield from emit_ready()
        assert emit_idx == len(order), "inner plan dropped work ids"


PLANS = {p.name: p for p in (FusedPlan, TwoPhasePlan, StreamingPlan,
                             AsyncPlan, ShardedPlan, CachedPlan)}


def _phase_fn(kind, graph: PipelineGraph, rules):
    """The plain callable of one phase over `graph` and `rules`, not run:
    what the dry-run counts (`launch/dryrun.py`)."""
    if kind == "fused":
        return lambda a: graph.fused(a, rules)
    if kind == "detect":
        return lambda a: graph.detection(a, rules)
    if kind in ("tail", "mmse"):
        return lambda w: graph.tail(w, rules)
    if kind == "tail_idx":
        return lambda w, i: graph.tail_indexed(w, i, rules)
    if kind == "tail_idx_fused":
        return lambda w, i: graph.tail_indexed_fused(w, i, rules)
    raise KeyError(f"unknown phase {kind!r}")


class Preprocessor:
    """The facade every entry point uses.

        pre = Preprocessor(SERF_AUDIO, plan="async")          # on the card
        pre = Preprocessor(SERF_AUDIO, device="cpu")          # plain versions
        pre = Preprocessor(SERF_AUDIO, ShardingRules(make_local_mesh()))
        for res in pre.run(stream):
            use(res.cleaned, res.det.stats, res.n_kept)

    `rules` are the sharding rules (`NULL_RULES`: no mesh), or for the
    sharded plan one a shard (`distributed.sharding.pool_rules`); under a
    mesh every phase runs the rank's rows and the plan emits whole results
    on every rank. `plan` is a name from `PLANS` or a plan class; `stages`
    overrides the config-declared stage list (ablations, or the
    `("hpf", "mmse")` tail); `source_channels` is the input's channel
    count (2: stereo); the plan pads the survivor tail to a multiple of
    `pad_multiple` (and of the mesh's size). Extra keyword arguments go to
    the plan (e.g. `depth=4`, `fuse_tail=False`). `device=None` means the
    CUDA card (raising when there is none), or the CPU under a CPU mesh.
    """

    def __init__(self, cfg, rules=NULL_RULES, plan="two_phase",
                 pad_multiple=1, stages=None, source_channels=2, device=None,
                 **plan_kwargs):
        self.cfg = cfg
        # facade-level detect() uses one rules object even when the plan
        # gets a per-shard list
        self.rules = _facade_rules(rules)
        self.device = _mesh_device(self.rules, device)
        self.graph = PipelineGraph(cfg, stages, source_channels)
        plan_cls = PLANS[plan] if isinstance(plan, str) else plan
        _check_rules_pool(rules, plan_cls, "the sharded plan (or a cached "
                          "wrapper around it)")
        self.plan = plan_cls(self.graph, rules, pad_multiple,
                             device=self.device, **plan_kwargs)

    def __call__(self, audio) -> BatchResult:
        """One batch of (B, C, S_long_src) long chunks -> BatchResult."""
        return self.plan(audio)

    def run(self, batches):
        """Iterate BatchResults over a batch stream."""
        return self.plan.run(batches)

    def detect(self, audio) -> PipelineOutput:
        """The detection phase alone, on the facade's device: every plan
        runs it the same way. For a graph without a removal point this is
        the whole chain (`PipelineGraph.detection`)."""
        return self.plan.detect(audio)

    def phase_fn(self, kind):
        """The phase callable ('fused' | 'detect' | 'tail' / 'mmse' |
        'tail_idx' | 'tail_idx_fused') over the facade's graph and rules,
        not run; see launch/dryrun.py."""
        return _phase_fn(kind, self.graph, self.rules)
