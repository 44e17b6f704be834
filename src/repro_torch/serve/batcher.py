"""Continuous batching front end: many small requests -> padded device
batches (the port's copy of the reference's `serve/batcher.py`).

Serving traffic arrives as single long chunks from many concurrent
clients; the card wants batches. `ContinuousBatcher` sits between them:

  coalesce   waiting requests are assembled into one batch the moment a
             full `max_batch` is available or the oldest request has
             waited `linger_s` (a partial batch is served after the
             linger, never held back for a full one)
  pad        batch sizes are the pow2 buckets of
             `scheduler.quantize_survivors`, so an arbitrary request mix
             meets O(log max_batch) batch shapes. Pad rows are zeros
             (`scheduler.pad_batch`): no request's bytes ride along twice,
             and a batch's content key does not depend on arrival order
  admit      `max_queue` bounds waiting + in-flight requests; beyond it
             `submit` raises `AdmissionError`, the backpressure signal a
             client retries on
  deadline   a request past its deadline is failed, at assembly if it
             expired waiting, or at delivery if its batch finished too
             late: a stale result is never served
  dispatch   batches go to a `WorkerPool` (`pool=`, asynchronous: new
             batches dispatch while earlier ones are in flight) or to any
             plan-like callable (`plan=`, synchronous, in this process;
             a `Preprocessor` on the card computes there)

`pump()` is the serving loop's body (one thread; `start()` runs it on a
background thread); `submit` / `result` / `wait` are thread-safe for any
number of client threads. `result(rid)` pops: a record is handed over
once. A record holds numpy arrays: masks and cleaned rows are read back
from the card where the plan left them there.

Every dispatched batch is logged in `batch_log` (request ids, real rows,
padded rows, occupancy, linger wait), a bounded ring: a load test reads
occupancy from it and can rebuild any batch bit for bit.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import scheduler as SCHED
from repro_torch.device import to_host
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing

# batch_log is a bounded ring of recent dispatches; the metrics registry
# keeps the aggregate (occupancy and wait histograms, dispatch counters).
BATCH_LOG_CAP = 1024


class AdmissionError(RuntimeError):
    """The request queue is full (`max_queue`): backpressure, not growth."""


@dataclass
class _Request:
    rid: int
    chunk: np.ndarray           # (C, S_long_src) one long chunk
    deadline: float             # absolute, or None
    submit_t: float


class ContinuousBatcher:
    def __init__(self, pool=None, plan=None, max_batch=8, max_queue=64,
                 linger_s=0.02, pad_multiple=1, clock=time.monotonic):
        if (pool is None) == (plan is None):
            raise ValueError("exactly one of pool= / plan= must be given")
        self.pool = pool
        self.plan = plan
        self.max_batch = max(1, int(max_batch))
        self.max_queue = max(1, int(max_queue))
        self.linger_s = float(linger_s)
        self.pad_multiple = max(1, int(pad_multiple))
        self.clock = clock
        self._lock = threading.RLock()
        self._waiting = collections.deque()     # _Request, FIFO
        self._inflight = {}     # pool wid -> (requests, padded_rows)
        self._results = {}      # rid -> record (popped by result())
        self._next_id = 0
        # ring of per-dispatch occupancy records (aggregates live in the
        # metrics registry — see BATCH_LOG_CAP)
        self.batch_log = collections.deque(maxlen=BATCH_LOG_CAP)
        self.rejected = 0       # admission-control refusals
        self.expired = 0        # deadline failures (waiting or delivery)
        self._thread = None
        self._stop = threading.Event()

    # -- client surface -----------------------------------------------------
    def submit(self, long_chunk, timeout_s=None) -> int:
        """Admit one (C, S_long_src) request; returns a request id.
        `timeout_s` sets a deadline relative to now: a request that
        cannot be served in time is failed, never served stale. Raises
        AdmissionError when waiting + in-flight >= max_queue."""
        x = np.asarray(to_host(long_chunk), np.float32)
        now = self.clock()
        with self._lock:
            depth = len(self._waiting) + sum(
                len(reqs) for reqs, _ in self._inflight.values())
            if depth >= self.max_queue:
                self.rejected += 1
                obs_metrics.counter(
                    "batcher_rejected_total",
                    "requests refused by admission control").inc()
                raise AdmissionError(
                    f"queue full ({depth}/{self.max_queue} requests "
                    f"waiting or in flight)")
            rid = self._next_id
            self._next_id += 1
            deadline = None if timeout_s is None else now + float(timeout_s)
            self._waiting.append(_Request(rid, x, deadline, now))
        obs_metrics.counter("batcher_requests_total",
                            "requests admitted").inc()
        # request lifetime as an async span pair: submit here, resolve in
        # _deliver/_expire — a request may start and finish on different
        # threads, which plain B/E nesting cannot express
        obs_tracing.get_tracer().async_begin("request", rid)
        return rid

    def result(self, rid):
        """Pop a finished request's record, or None if not (yet) done.
        Success: {"ok": True, keep/rain/silence/cleaned, latency_s}.
        Failure: {"ok": False, "error": ...}. Each record is handed over
        exactly once — a second call returns None."""
        with self._lock:
            return self._results.pop(rid, None)

    def wait(self, rid, timeout_s=600.0):
        """Block until `rid` resolves; pops and returns its record. Runs
        the pump inline when no background pump thread is active."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if rid in self._results:
                    return self._results.pop(rid)
            if self._thread is None:
                self.pump()
            if time.monotonic() > deadline:
                raise TimeoutError(f"request {rid} unresolved after "
                                   f"{timeout_s:.0f}s")
            time.sleep(0.001)

    # -- serving loop -------------------------------------------------------
    def pump(self, force=False):
        """One serving-loop tick: fail expired waiters, dispatch every
        ready batch (full, or lingered past linger_s, or force=True for
        drain), and deliver finished pool batches. Returns the request
        ids resolved this tick. Call from ONE thread."""
        done = []
        now = self.clock()
        while True:
            with self._lock:
                self._expire_waiting(now, done)
                batch = self._assemble(now, force)
            if batch is None:
                break
            reqs, padded, n_real = batch
            if self.pool is not None:
                wid = self.pool.submit(padded)
                with self._lock:
                    self._inflight[wid] = (reqs, padded.shape[0])
            else:
                res = self.plan(padded)
                done += self._deliver(reqs, padded.shape[0], res)
        if self.pool is not None:
            with self._lock:
                wids = list(self._inflight)
            for wid, res in self.pool.claim(wids).items():
                with self._lock:
                    reqs, rows = self._inflight.pop(wid)
                done += self._deliver(reqs, rows, res)
        return done

    def _expire_waiting(self, now, done):
        """Fail queued requests whose deadline passed — they never reach
        a batch. Caller holds the lock."""
        alive = collections.deque()
        for r in self._waiting:
            if r.deadline is not None and now > r.deadline:
                self.expired += 1
                obs_metrics.counter(
                    "batcher_expired_total",
                    "requests failed on deadline").inc()
                self._results[r.rid] = {
                    "ok": False, "error": "deadline",
                    "waited_s": now - r.submit_t}
                obs_tracing.get_tracer().async_end("request", r.rid,
                                                   ok=False)
                done.append(r.rid)
            else:
                alive.append(r)
        self._waiting = alive

    def _assemble(self, now, force):
        """Take up to max_batch waiting requests once the dispatch
        condition holds; zero-pad them to the pow2 bucket size. Caller
        holds the lock; returns (requests, padded_batch, n_real) or
        None."""
        if not self._waiting:
            return None
        waited = now - self._waiting[0].submit_t
        if not (force or len(self._waiting) >= self.max_batch
                or waited >= self.linger_s):
            return None
        reqs = [self._waiting.popleft()
                for _ in range(min(len(self._waiting), self.max_batch))]
        rows = np.stack([r.chunk for r in reqs])
        size = SCHED.quantize_survivors(len(reqs), self.max_batch,
                                        self.pad_multiple, "pow2")
        padded, n_real = SCHED.pad_batch(rows, size)
        assert n_real == len(reqs) and padded.shape[0] == size
        # pad rows must be zeros — never a copy of any request's bytes
        assert n_real == size or not padded[n_real:].any()
        self.batch_log.append({
            "rids": [r.rid for r in reqs], "n_real": n_real,
            "rows": size, "occupancy": n_real / size,
            "waited_s": waited})
        reg = obs_metrics.get_registry()
        if reg.enabled:
            reg.counter("batcher_batches_total", "batches dispatched").inc()
            reg.histogram(
                "batcher_occupancy", "real rows / padded rows per batch",
                buckets=obs_metrics.OCCUPANCY_BUCKETS).observe(n_real / size)
            reg.histogram("batcher_wait_seconds",
                          "oldest-request linger at dispatch").observe(waited)
        obs_tracing.instant("batch_dispatch", n_real=n_real, rows=size)
        return reqs, padded, n_real

    def _deliver(self, reqs, rows, res):
        """Slice one finished batch back into per-request records.
        Survivors are compacted in stable row order, so request j's
        cleaned rows sit at [sum(keep[:j*per]), sum(keep[:(j+1)*per]));
        pad rows trail every real request and are never attributed. A
        request whose deadline passed while its batch computed is failed
        here — late results are dropped, not served stale."""
        keep = to_host(res.det.keep)
        rain = to_host(res.det.rain)
        silence = to_host(res.det.silence)
        per = keep.size // rows
        offs = np.concatenate([[0], np.cumsum(keep)]).astype(int)
        now = self.clock()
        out = []
        tracer = obs_tracing.get_tracer()
        latency_h = obs_metrics.histogram(
            "serve_request_latency_seconds", "submit-to-delivery latency")
        with self._lock:
            for j, r in enumerate(reqs):
                if r.deadline is not None and now > r.deadline:
                    self.expired += 1
                    obs_metrics.counter(
                        "batcher_expired_total",
                        "requests failed on deadline").inc()
                    self._results[r.rid] = {
                        "ok": False, "error": "deadline",
                        "waited_s": now - r.submit_t}
                    tracer.async_end("request", r.rid, ok=False)
                else:
                    lo, hi = j * per, (j + 1) * per
                    self._results[r.rid] = {
                        "ok": True,
                        "keep": keep[lo:hi], "rain": rain[lo:hi],
                        "silence": silence[lo:hi],
                        "cleaned": res.cleaned[offs[lo]:offs[hi]],
                        "latency_s": now - r.submit_t}
                    latency_h.observe(now - r.submit_t)
                    tracer.async_end("request", r.rid, ok=True)
                out.append(r.rid)
        return out

    def flush(self, timeout_s=600.0):
        """Drain: force-dispatch the waiting tail and pump until nothing
        is waiting or in flight. Returns all request ids resolved."""
        done = self.pump(force=True)
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                idle = not self._waiting and not self._inflight
            if idle:
                return done
            if time.monotonic() > deadline:
                raise TimeoutError("batcher flush timed out")
            done += self.pump(force=True)
            time.sleep(0.001)

    # -- background pump loop ----------------------------------------------
    def start(self):
        """Run pump() on a background thread (the serving loop); client
        threads then only submit() and wait()."""
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stop.clear()

        def loop():
            tick = max(0.001, min(self.linger_s / 4, 0.005))
            while not self._stop.is_set():
                self.pump()
                time.sleep(tick)

        t = threading.Thread(target=loop, daemon=True,
                             name="repro-batcher-pump")
        self._thread = t
        t.start()
        return self

    def stop(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()

    # -- observability ------------------------------------------------------
    def stats(self):
        with self._lock:
            waiting = len(self._waiting)
            inflight = sum(len(reqs) for reqs, _ in
                           self._inflight.values())
        occ = [b["occupancy"] for b in self.batch_log]
        return {"waiting": waiting, "in_flight": inflight,
                "dispatched_batches": len(self.batch_log),
                "rejected": self.rejected, "expired": self.expired,
                "mean_occupancy": float(np.mean(occ)) if occ else None}
