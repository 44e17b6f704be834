"""Execution plans: how a validated `PipelineGraph` runs on a batch stream.

The reference's plans, but for the sharded one, are ported:

  * `FusedPlan`     -- the whole chain on every chunk in one pass, removed
                       chunks masked but still denoised: the paper's
                       no-early-exit baseline, and the plan for a graph
                       without a removal point.
  * `TwoPhasePlan`  -- detection -> the host reads back the keep mask -> a
                       padded survivor-index vector -> the survivor tail on
                       the device, which gathers the survivors out of the
                       still-resident batch. MMSE cost scales with
                       surviving audio. One batch at a time, with
                       synchronous copies: the single-stream default.
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
still decides the tail's row count, as in the reference. The reference's
`ShardedPlan` comes with the distribution slice.
"""
from __future__ import annotations

import collections
import operator
import os
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core import scheduler as SCHED
from repro_torch.core import transfer
from repro_torch.core.graph import (GraphValidationError, PipelineGraph,
                                    PipelineOutput)
from repro_torch.data.queue import WorkQueue
from repro_torch.device import resolve_device
from repro_torch.dist.service import pack_result, unpack_result
from repro_torch.store import ChunkStore, RunJournal, content_key

# Cap on the per-batch timing dicts `AsyncPlan.last_timings` keeps.
TIMINGS_CAP = 4096


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


class ExecutionPlan:
    """What every plan shares: its graph, its device (None: the card) and
    the survivor padding multiple; `run` maps `__call__` over a stream."""
    name = "base"

    def __init__(self, graph: PipelineGraph, pad_multiple=1, device=None):
        self.graph = graph
        self.device = resolve_device(device)
        self.pad_multiple = max(1, int(pad_multiple))

    def _to_device(self, audio):
        return torch.as_tensor(audio, dtype=torch.float32, device=self.device)

    def detect(self, audio) -> PipelineOutput:
        return self.graph.detection(self._to_device(audio))

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
        x = self._to_device(audio)
        out = self.graph.fused(x)
        keep = out.keep.cpu().numpy()
        idx = torch.from_numpy(np.flatnonzero(keep)).to(out.wave5.device)
        cleaned = out.wave5.index_select(0, idx).cpu().numpy()
        return BatchResult(cleaned=cleaned, det=out, n_kept=int(keep.sum()),
                           src_bytes=x.numel() * x.element_size())


class TwoPhasePlan(ExecutionPlan):
    """`pad_multiple` and `bucket` set the survivor tail's row count
    (`scheduler.quantize_survivors`). `donate` lets the asynchronous plans
    write a later batch into the device input buffer of an earlier one once
    its detection is enqueued (None: on for CUDA); two_phase copies each
    batch synchronously into a fresh tensor, so there it only records the
    choice, as the reference's signature has it."""
    name = "two_phase"

    def __init__(self, graph: PipelineGraph, pad_multiple=1, bucket="linear",
                 donate=False, fuse_tail=None, device=None):
        if not graph.has_removal_point:
            raise GraphValidationError(
                f"plan '{self.name}' needs a 'removal_point' stage in the "
                f"graph (stages: {graph.names}); use the fused plan for "
                f"graphs without early exit")
        super().__init__(graph, pad_multiple, device)
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
        self.staging = None             # synchronous copies

    def _readback(self, t) -> transfer.Readback:
        return (transfer.Readback(t) if self.staging is None
                else self.staging.readback(t))

    def _dispatch(self, audio, wid=None, extra=None):
        """Bring a batch to the device, enqueue its detection and start the
        keep-mask readback. A batch already on the device (the caller's
        tensor) is used where it is; a host batch goes through the staging
        ring when the plan has one (`slot`: the plan's device buffer it was
        copied into, when the plan donates)."""
        if self.staging is None or (torch.is_tensor(audio)
                                    and audio.device.type != "cpu"):
            x, slot = self._to_device(audio), None
        else:
            x, slot = self.staging.upload(audio)
        det = self.graph.detection(x)
        if slot is not None:
            if det.wave5.untyped_storage().data_ptr() == \
                    x.untyped_storage().data_ptr():
                # a graph whose wave5 is a view of its input: keep it out
                # of the slot that a later batch writes
                det = replace(det, wave5=det.wave5.clone())
            self.staging.release(slot)
        return _Detected(det, self._readback(det.keep), wid, extra,
                         x.numel() * x.element_size(), {})

    def _start_tail(self, d: _Detected) -> _PendingTail:
        """Master bookkeeping, device-resident: the host reads back only
        the keep mask, builds a padded survivor-index vector, and the tail
        gathers + denoises on the device; its n_real real rows start back
        to the host at once."""
        t0 = time.perf_counter()
        keep = d.keep.wait()                          # the only readback
        t1 = time.perf_counter()
        idx, n_real = SCHED.survivor_indices(keep, self.pad_multiple,
                                             self.bucket)
        t2 = time.perf_counter()
        cleaned, h2d = None, 0
        if n_real:
            idx_t = torch.from_numpy(idx)
            if self.device.type == "cuda":      # no wait on the stream
                idx_t = idx_t.pin_memory().to(self.device, non_blocking=True)
            tail =(self.graph.tail_indexed_fused if self.fuse_tail
                    else self.graph.tail_indexed)
            cleaned = self._readback(tail(d.det.wave5, idx_t)[:n_real])
            h2d = idx.nbytes
        t3 = time.perf_counter()
        wave5 = d.det.wave5
        timings = dict(d.timings)
        timings.update(
            readback_s=t1 - t0, compact_s=t2 - t1, tail_s=t3 - t2,
            h2d_bytes=h2d, d2h_bytes=keep.nbytes,
            tail_rows=0 if idx is None else len(idx), n_real=n_real,
            wave5_bytes=wave5.numel() * wave5.element_size())
        return _PendingTail(d.det, cleaned, n_real, d.wid, d.extra,
                            d.src_bytes, timings)

    def _emit(self, pend: _PendingTail) -> BatchResult:
        """Wait for (the rest of) the cleaned readback and build the
        result. Only the real rows come back; pad rows are zero rows of
        the device tail and never reach `cleaned`."""
        t0 = time.perf_counter()
        if pend.cleaned is None:
            cleaned = np.zeros((0, pend.det.wave5.shape[-1]), np.float32)
        else:
            cleaned = pend.cleaned.wait()
            pend.timings["d2h_bytes"] += cleaned.nbytes
        pend.timings["emit_s"] = time.perf_counter() - t0
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
        return BatchResult(cleaned=cleaned, det=pend.det,
                           n_kept=pend.n_real, wid=pend.wid,
                           labels=pend.extra, src_bytes=pend.src_bytes,
                           timings=pend.timings)

    def _finish(self, det: PipelineOutput, src_bytes=0) -> BatchResult:
        return self._emit(self._start_tail(_Detected(
            det, self._readback(det.keep), None, None, src_bytes, {})))

    def __call__(self, audio) -> BatchResult:
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

    def __init__(self, graph, pad_multiple=1, depth=2, bucket="pow2",
                 donate=None, emit_buffer=1, fuse_tail=None, device=None):
        super().__init__(graph, pad_multiple, bucket=bucket, donate=donate,
                         fuse_tail=fuse_tail, device=device)
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

    def __init__(self, graph, pad_multiple=1, depth=1, bucket="linear",
                 donate=False, emit_buffer=0, fuse_tail=None, device=None):
        super().__init__(graph, pad_multiple, depth=depth, bucket=bucket,
                         donate=donate, emit_buffer=emit_buffer,
                         fuse_tail=fuse_tail, device=device)


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


class CachedPlan(ExecutionPlan):
    """Content-addressed caching and resumability around any inner plan.

    Every batch is keyed by the content hash of (raw chunk bytes, graph
    fingerprint, framework tag `torch-<device type>`) and looked up in the
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
    is not stored."""
    name = "cached"

    def __init__(self, graph, pad_multiple=1, inner="two_phase", store=None,
                 journal=None, resume=False, device=None, **inner_kwargs):
        super().__init__(graph, pad_multiple, device)
        inner_cls = PLANS[inner] if isinstance(inner, str) else inner
        self.inner = inner_cls(graph, pad_multiple, device=self.device,
                               **inner_kwargs)
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
                           f"torch-{self.device.type}")

    def _result(self, arrays, meta, wid, extra) -> BatchResult:
        det, f = unpack_result({**arrays, **meta})
        return BatchResult(cleaned=f["cleaned"], det=det, n_kept=f["n_kept"],
                           wid=wid, labels=extra, src_bytes=f["src_bytes"])

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
                             AsyncPlan, CachedPlan)}


class Preprocessor:
    """The facade every entry point uses.

        pre = Preprocessor(SERF_AUDIO, plan="async")          # on the card
        pre = Preprocessor(SERF_AUDIO, device="cpu")          # plain versions
        for res in pre.run(stream):
            use(res.cleaned, res.det.stats, res.n_kept)

    `plan` is a name from `PLANS` or a plan class; `stages` overrides the
    config-declared stage list (ablations, or the `("hpf", "mmse")` tail);
    `source_channels` is the input's channel count (2: stereo); the plan
    pads the survivor tail to a multiple of `pad_multiple`. Extra keyword
    arguments go to the plan (e.g. `depth=4`, `fuse_tail=False`).
    `device=None` means the CUDA card and raises when there is none.
    """

    def __init__(self, cfg, plan="two_phase", pad_multiple=1, stages=None,
                 source_channels=2, device=None, **plan_kwargs):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graph = PipelineGraph(cfg, stages, source_channels)
        plan_cls = PLANS[plan] if isinstance(plan, str) else plan
        self.plan = plan_cls(self.graph, pad_multiple, device=self.device,
                             **plan_kwargs)

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
