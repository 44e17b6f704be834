"""Serving glue for the preprocessing facade (the port's copy of the
reference's `serve/preprocess_service.py`): a host-side request queue that
pumps 60 s long-chunk requests through a `Preprocessor` plan in fixed-size
batches (the serving analogue of the paper's slave pull queue).

Each request is one stereo long chunk; its result is the per-final-chunk
keep mask (with the rain and silence masks) and the cleaned surviving
chunks, as numpy arrays: what a downstream species classifier or archive
compaction needs. `result(rid)` pops its record, so that the result map
cannot grow without bound under sustained traffic.

`device` takes the place of the reference's sharding `rules` (the port
has no sharding rules yet): None is the card, "cpu" the plain versions.
Extra keyword arguments go to the plan, so that
`PreprocessService(cfg, plan="sharded", shards=4)` serves each pumped
batch through the multi-shard path. The sharded plan's `transport=` does
not change serving: a single pumped batch always row-splits in this
process. For real worker processes behind serving pass `pool=` (a started
`serve.pool.WorkerPool`): pumped batches then go to the pool's long-lived
workers, the same pids pump after pump; `serve.batcher.ContinuousBatcher`
is the lower-latency front end when requests arrive continuously.

Warm-cache serving rides the same pass-through:
`PreprocessService(cfg, plan="cached", store=DIR)` consults the
content-addressed `store.ChunkStore` per pumped batch, keyed as pumped
(zero pad rows included, never copies of a request). With `pool=` and a
cached plan, a hit short-circuits before any worker is touched; only
misses cost pool latency, and fresh results are written back. `cache_stats`
reports the hit/miss/bytes ledger.

`last_timings` holds the plan's timing record of the most recent pump
(readback / tail / emit split), so that a serving loop can watch it
without instrumenting the plan.
"""
from __future__ import annotations

import collections

import numpy as np

from repro_torch.core import scheduler as SCHED
from repro_torch.core.plans import Preprocessor
from repro_torch.device import to_host
from repro_torch.dist.service import pack_result
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing


class PreprocessService:
    def __init__(self, cfg, device=None, plan="two_phase",
                 batch_long_chunks=4, pad_multiple=1, pool=None,
                 **plan_kwargs):
        self.cfg = cfg
        self.batch = batch_long_chunks
        self.pool = pool
        self.pre = Preprocessor(cfg, plan=plan, pad_multiple=pad_multiple,
                                device=device, **plan_kwargs)
        self._queue = collections.deque()
        self._results = {}
        self._next_id = 0
        self.last_timings = None   # plan timing record of the last pump

    def submit(self, long_chunk) -> int:
        """long_chunk: (C, S_long_src) one 60 s stereo chunk. Returns a
        request id."""
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, np.asarray(to_host(long_chunk),
                                            np.float32)))
        obs_metrics.counter("serve_requests_total",
                            "requests admitted to PreprocessService").inc()
        return rid

    def pump(self):
        """Run one full (zero-padded) batch through the plan — or through
        the worker pool when one was given — and return the completed
        request ids."""
        if not self._queue:
            return []
        rids, chunks = [], []
        while self._queue and len(chunks) < self.batch:
            rid, c = self._queue.popleft()
            rids.append(rid)
            chunks.append(c)
        batch, n_real = SCHED.pad_batch(np.stack(chunks), self.batch)
        # pad rows are ZERO rows, never copies of a request: real bytes
        # must not ride the batch twice (duplicate MMSE flops, and a
        # cached plan would store a request's audio under a key that
        # depends on which request happened to arrive last)
        assert n_real == len(rids)
        assert n_real == batch.shape[0] or not batch[n_real:].any(), \
            "pad rows leaked real request bytes into the batch"
        res = self._serve(batch)
        self.last_timings = res.timings
        keep = to_host(res.det.keep)
        rain = to_host(res.det.rain)
        silence = to_host(res.det.silence)
        per = keep.size // batch.shape[0]        # final chunks per request
        # survivors are compacted in stable order: request j's cleaned rows
        # sit at [sum(keep[:j*per]), sum(keep[:(j+1)*per])). Masks are
        # sliced PER REQUEST — batch-level stats would be skewed by the
        # pad rows and the other requests in the batch; zero pad rows can
        # survive detection (their cleaned rows are zeros) but they trail
        # every real request in the stable order, so no request is ever
        # attributed a pad row.
        offs = np.concatenate([[0], np.cumsum(keep)]).astype(int)
        for j, rid in enumerate(rids):
            lo, hi = j * per, (j + 1) * per
            self._results[rid] = {
                "keep": keep[lo:hi],
                "rain": rain[lo:hi],
                "silence": silence[lo:hi],
                "cleaned": res.cleaned[offs[lo]:offs[hi]],
            }
        return rids

    def _serve(self, batch):
        """One assembled batch -> BatchResult. In-process plan by
        default; with `pool=`, a cached plan's store is consulted FIRST
        (warm hits never touch a worker), misses go to the pool's
        persistent workers, and fresh results are written back."""
        if self.pool is None:
            with obs_tracing.span("serve_pump", rows=int(batch.shape[0])):
                return self.pre(batch)
        plan = self.pre.plan
        store = getattr(plan, "store", None)
        key = None
        if store is not None:
            key = plan._key(batch)
            hit = store.get(key, src_bytes=batch.nbytes)
            if hit is not None:
                obs_metrics.counter(
                    "serve_store_hits_total",
                    "pumped batches answered from the chunk store").inc()
                return plan._result(*hit, wid=None, extra=None)
        with obs_tracing.span("serve_pool_pump", rows=int(batch.shape[0])):
            wid = self.pool.submit(batch)
            res = self.pool.wait([wid])[wid]
        if store is not None:
            store.put_payload(key, pack_result(res))
        return res

    def result(self, rid):
        """Pop a finished request's record (None if unknown/pending).
        Each record is handed over exactly once — the result map stays
        bounded by in-flight work, not service lifetime."""
        return self._results.pop(rid, None)

    @property
    def cache_stats(self):
        """Store hit/miss accounting when serving through a cached plan
        (None otherwise)."""
        return getattr(self.pre.plan, "stats", None)

    @property
    def worker_stats(self):
        """Per-worker progress ledger: the pool's live ledger when
        serving through a worker pool, else the sharded plan's report of
        its most recent stream run (None for other plans)."""
        if self.pool is not None:
            return self.pool.worker_stats
        return getattr(self.pre.plan, "worker_stats", None)

    # -- observability ------------------------------------------------------
    def metrics_snapshot(self):
        """JSON-safe dump of the process-wide metrics registry (plan,
        dist, pool, serving and store series alike — the service is just
        a convenient place to scrape from). Refreshes the pool gauges
        first so the snapshot carries the live serving view."""
        if self.pool is not None:
            self.pool.gauges()
        return obs_metrics.snapshot()

    def metrics_text(self):
        """The same registry in Prometheus text exposition format — what
        an HTTP /metrics endpoint would serve."""
        if self.pool is not None:
            self.pool.gauges()
        return obs_metrics.render()
