"""QueueService: the master's serviceable surface over one shared WorkQueue
(the port's copy of the reference's `dist/service.py`), and the result
codec that worker pushes and chunk-store entries share.

The paper's master owns three things: the file list (the leased
`WorkQueue`), the data hand-off to slaves (`fetch`), and the result
collection that gates what counts as done (`push_result` and the
master-side `pop_results` drain). `QueueService` packages exactly that as
a set of named methods a transport can serve: `RPC_METHODS` is the whole
wire surface, nothing else on the object is reachable remotely.

It also duck-types the WorkQueue it wraps (lease / complete /
heartbeat_extend / fail_worker / state / next_deadline / progress /
finished / clock / lease_timeout_s / redeliveries), so that the
in-process path routes every queue mutation through the service and the
per-worker accounting accrues as under the process transports. Compound
operations take the queue's own RLock, so the transport's handler threads
and the master loop interleave safely.

Observability, as in the reference: every counter also goes into the
process's metrics registry under the reference's names (`dist_*_total`,
the `dist_workers{state}` and `dist_membership_epoch` gauges), which the
`metrics` RPC returns as a snapshot or Prometheus text; with a
`TelemetryWriter` the service writes one durable record per accepted chunk
and per reclaimed lease, on the master; `hello` hands the master's tracer
context to the worker (`setup["trace"]`) and `bye` merges the spans the
worker ships back into the master's tracer. `bye` keeps the rest of the
worker's stats dict as received (`WorkerStats.report`: its idle/busy
split, its kernel launches and the bytes its allocator held).

The measured part: the master names the start and end of a part of the
run (`mark`, master-side) and each worker learns of it in the reply to its
next `heartbeat`, which it sends before every item: with nothing marked the
reply is True, as before, so a worker that knows no marks ignores it. A
worker told a part records its card and, where the mark carries the
master's tracer context, its spans, and reports them in `bye`
(`dist.worker`).

Everything that crosses the wire is numpy and plain Python: `fetch`
returns a host f32 batch and `pack_result` a numpy-only payload, so no
tensor, on the card or off it, is ever pickled onto the socket.
"""
from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.graph import PipelineOutput
from repro_torch.device import to_host
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing

# The complete remote surface. A transport refuses anything else: the
# service carries master-side state (the result inbox, the grant hook)
# that workers have no business reaching. `metrics` is read-only, a
# snapshot of the master's metrics registry. `drain` / `draining` are the graceful-leave
# pair: a departing worker (or the master) calls `drain`, the worker polls
# `draining` and exits once its held leases are finished. `lease_chunks`
# is the store data plane's lease: grants come back as (wid, content key)
# pairs, so the socket never carries chunk bytes.
RPC_METHODS = frozenset({
    "hello", "lease", "lease_chunks", "fetch", "fetch_many", "complete",
    "push_result", "heartbeat", "fail_worker", "state", "progress",
    "finished", "next_deadline", "bye", "metrics", "drain", "draining",
})
# the methods that ship chunk batches over the master's socket: a
# transport serves each under the program span "serve_fetch", the send
# included where it has one
SERVED_FETCHES = frozenset({"fetch", "fetch_many"})

# Worker membership states (WorkerStats.state). Every transition bumps the
# service's membership epoch and is mirrored into the metrics registry.
WORKER_STATES = ("active", "draining", "departed", "dead")


@dataclass
class WorkerStats:
    """One worker's progress ledger (the launcher's end-of-run summary).

    `leases_held` / `redeliveries` / `last_beat_age_s` are filled in by
    `QueueService.worker_report()` at snapshot time; the rest accrue as the
    worker talks to the service."""
    worker: str
    shard: int = -1
    pid: int = None
    state: str = "active"           # membership: active/draining/departed/dead
    lease_calls: int = 0            # queue round-trips (Table 7's axis)
    leased_total: int = 0           # work ids ever granted
    chunks_done: int = 0            # results accepted by the master (the
                                    # completion gate, not raw pushes)
    idle_s: float = 0.0             # worker-reported: blocked on the queue
    busy_s: float = 0.0             # worker-reported: computing
    report: dict = None             # the stats dict of its `bye`, as sent
    joined_at: float = field(default=None, repr=False)  # monotonic, hello
    last_beat: float = field(default=None, repr=False)
    # snapshot-time fields (worker_report):
    leases_held: int = 0
    redeliveries: int = 0
    last_beat_age_s: float = None


class QueueService:
    """Master-side service: the WorkQueue plus the data and result planes.

    Parameters:
      queue       the shared WorkQueue (its RLock serialises everything)
      fetch_item  wid -> host chunk batch (np.ndarray, or None once the id
                  retired): the data plane. The master materialises the
                  bytes; workers never see the loader
      setup       picklable blob returned from `hello`: everything a worker
                  needs to build its plan (config, stage names,
                  pad_multiple, bucket, device type)
      monitor     optional ft.failure.HeartbeatMonitor fed on heartbeats
      telemetry   optional obs.telemetry.TelemetryWriter: per-chunk
                  records written on the master at acceptance and at
                  redelivery, so that they survive SIGKILLed workers
      straggler   optional ft.failure.StragglerDetector, which arms
                  speculative re-lease: when an active worker's lease
                  comes back empty with work still in flight (the
                  end-of-stream shape), the slowest flagged item is
                  duplicated to that idle worker (`WorkQueue.speculate`)
      data_plane  optional dist.data_plane.StoreDataPlane: workers lease
                  through `lease_chunks` (keys, not bytes) and push small
                  store refs

    Membership: `hello` / `bye` / `drain` and observed deaths drive a
    registry: a per-worker `state` and an `epoch` that bumps on every join,
    leave and death. A `hello` mid-run gets the same setup blob the
    original fleet got and leases from the same queue.

    Counts (queue round-trips, ids granted, pushes, accepted results,
    redeliveries, speculations, membership changes, and the data-plane
    bytes the master's socket carried per plane) go into the process's
    metrics registry under the reference's names and labels
    (`dist_lease_calls_total{worker}`, `dist_fetch_bytes_total{plane}`,
    ...); `lease_calls` is also kept as a plain total, as the reference
    keeps it.
    """

    def __init__(self, queue, fetch_item=None, setup=None, monitor=None,
                 telemetry=None, straggler=None, data_plane=None):
        self.queue = queue
        self._fetch_item = fetch_item
        self._setup = dict(setup or {})
        self.monitor = monitor
        self.telemetry = telemetry
        self.straggler = straggler
        self.data_plane = data_plane
        self.workers: dict[str, WorkerStats] = {}
        # registry assignment: pid -> shard reservations made master-side
        # at spawn, and the next free shard id for a worker that joins
        # with no reservation (one started by hand)
        self._reserved: dict[int, int] = {}
        self._next_shard = 0
        # wid -> offered store key (lease_chunks): a redelivered or
        # speculated lease re-offers without hashing the batch again
        self._offered: dict[int, str] = {}
        self.lease_calls = 0
        self.epoch = 0
        self._results = collections.deque()
        # per-chunk event times (lease / fetch / push, content key) by wid,
        # popped into a telemetry record at acceptance
        self._timeline: dict[int, dict] = {}
        # the queue fires these under its own lock for every reclaim path
        # (expiry, fail_worker, a lost speculation race) and every
        # retirement, whichever loop caused them
        queue.on_redeliver = self._on_redeliver
        queue.on_complete = self._on_complete
        # the measured part the master names (`mark`): the reply to every
        # heartbeat once set
        self._mark = None
        # master-side hook, called inside lease() once per granted work id
        # with (worker, wid): the CrashInjector's process-mode trigger (a
        # doomed worker is SIGKILLed while its fresh lease is registered
        # and not completed, so recovery takes the real redelivery path)
        self.on_grant = None

    # -- bookkeeping --------------------------------------------------------
    def _w(self, worker) -> WorkerStats:
        st = self.workers.get(worker)
        if st is None:
            st = self.workers[worker] = WorkerStats(worker)
        return st

    def _set_state(self, st: WorkerStats, state: str):
        """Move one worker to another membership state; bumps the epoch
        and republishes the membership gauges only on a real change."""
        if st.state != state:
            st.state = state
            self.epoch += 1
            self._publish_membership()

    def _publish_membership(self):
        reg = obs_metrics.get_registry()
        if not reg.enabled:
            return
        by_state = collections.Counter(st.state for st in
                                       self.workers.values())
        g = reg.gauge("dist_workers", "registered workers by membership "
                      "state", ("state",))
        for s in WORKER_STATES:
            g.labels(state=s).set(by_state.get(s, 0))
        reg.gauge("dist_membership_epoch",
                  "membership version: bumps on every join/drain/"
                  "departure/death").set(self.epoch)

    def active_workers(self):
        """Names of workers currently in state 'active'."""
        with self.queue.lock:
            return sorted(w for w, st in self.workers.items()
                          if st.state == "active")

    def note_beat(self, worker):
        """Record liveness without extending lease deadlines (the
        in-process path beats once per round; extending there would change
        redelivery timing, which the process path does via `heartbeat`)."""
        with self.queue.lock:
            self._w(worker).last_beat = self.queue.clock()
        if self.monitor is not None:
            self.monitor.beat(worker)

    def note_done(self, worker, n=1, wid=None, survivors=None,
                  bytes_out=None):
        """Credit accepted work to `worker`: the master calls this once
        `WorkQueue.complete` returned the id as newly done. That is the
        acceptance point, so a caller that names the chunk (`wid`, its
        survivor count and output bytes) gets its durable telemetry record
        written here, exactly once per chunk."""
        with self.queue.lock:
            st = self._w(worker)
            st.chunks_done += n
            obs_metrics.counter(
                "dist_chunks_done_total",
                "results accepted by the master", ("worker",)
            ).labels(worker=worker).inc(n)
            if self.telemetry is not None and wid is not None:
                tl = self._timeline.pop(wid, {})
                self.telemetry.record(
                    event="chunk", status="done", wid=int(wid),
                    worker=worker, shard=st.shard, pid=st.pid,
                    content_key=tl.get("content_key"),
                    lease_ts=tl.get("lease_ts"), fetch_ts=tl.get("fetch_ts"),
                    push_ts=tl.get("push_ts"), accept_ts=time.time(),
                    survivors=None if survivors is None else int(survivors),
                    bytes_in=tl.get("bytes_in"),
                    bytes_out=None if bytes_out is None else int(bytes_out),
                    redelivered=int(tl.get("redelivered", 0)),
                    speculated=int(tl.get("speculated", 0)))

    def _on_redeliver(self, wid, worker, reason):
        """Queue-level reclaim hook (under the queue lock): count it and
        attribute the losing incarnation in telemetry. For "speculated"
        the id is already done: the record names the loser and the
        timeline is left to the winner's `done` record."""
        obs_metrics.counter(
            "dist_redeliveries_total", "leases reclaimed",
            ("worker", "reason")).labels(worker=worker, reason=reason).inc()
        if self.telemetry is None:
            return
        st = self.workers.get(worker)
        tl = self._timeline.get(wid, {})
        self.telemetry.record(
            event="chunk", status="redelivered", reason=reason,
            wid=int(wid), worker=worker,
            shard=st.shard if st else -1, pid=st.pid if st else None,
            content_key=tl.get("content_key"),
            lease_ts=tl.get("lease_ts"), fetch_ts=tl.get("fetch_ts"))
        if reason == "speculated":
            return
        # the next lease starts a fresh timeline that keeps the counts, so
        # that the eventual "done" record carries them
        self._timeline[wid] = {
            "redelivered": tl.get("redelivered", 0) + 1,
            "speculated": tl.get("speculated", 0)}

    def _on_complete(self, wids):
        """Queue-level retirement hook (under the queue lock): closes the
        straggler detector's latency samples, whichever loop completed the
        ids, and forgets their store offers."""
        if self.straggler is not None:
            for wid in wids:
                self.straggler.complete(wid)
        for wid in wids:
            self._offered.pop(wid, None)

    # -- RPC surface --------------------------------------------------------
    def reserve(self, pid, shard):
        """Master-side (not served): pin the shard id a spawned process is
        assigned when its `hello` lands. The spawn path calls this right
        after Popen, so handles and injectors keyed by shard stay valid
        without a shard id on the command line."""
        with self.queue.lock:
            self._reserved[int(pid)] = int(shard)
            self._next_shard = max(self._next_shard, int(shard) + 1)

    def hello(self, worker=None, pid=None, shard=-1):
        """Worker sign-in: registers its identity and returns the setup
        blob, the same whether the worker is of the original fleet or
        joins a run in progress. A rejoin after departure or death is a
        fresh incarnation: state returns to active and the epoch bumps.

        With `worker=None` the caller announces rather than asserts its
        identity: the registry assigns it the shard reserved for its pid
        at spawn, or the next free id, and ships the assignment back under
        "assigned". With a live tracer on the master its propagation
        context rides under "trace"; with a store data plane its spec
        under "data_plane"."""
        assigned = None
        with self.queue.lock:
            if worker is None:
                shard = self._reserved.pop(int(pid), None) \
                    if pid is not None else None
                if shard is None:
                    shard = self._next_shard
                self._next_shard = max(self._next_shard, int(shard) + 1)
                worker = f"shard{int(shard)}"
                assigned = {"worker": worker, "shard": int(shard)}
            elif int(shard) >= 0:
                # an explicit identity keeps the assignment counter ahead,
                # so that a later announce never collides with it
                self._next_shard = max(self._next_shard, int(shard) + 1)
            known = worker in self.workers
            st = self._w(worker)
            st.pid, st.shard = pid, int(shard)
            st.last_beat = self.queue.clock()
            st.joined_at = time.monotonic()
            if not known or st.state != "active":
                obs_metrics.counter(
                    "dist_workers_joined_total",
                    "workers that signed in (first hello or rejoin)",
                    ("worker",)).labels(worker=worker).inc()
                st.state = "active"
                self.epoch += 1
                self._publish_membership()
        prop = obs_tracing.get_tracer().propagate()
        if prop is None and assigned is None and self.data_plane is None:
            return self._setup
        setup = dict(self._setup)
        if prop is not None:
            setup["trace"] = prop
        if assigned is not None:
            setup["assigned"] = assigned
        if self.data_plane is not None:
            setup["data_plane"] = self.data_plane.spec()
        return setup

    def lease(self, worker, max_items=1):
        with self.queue.lock:
            st = self._w(worker)
            st.lease_calls += 1
            st.last_beat = self.queue.clock()
            self.lease_calls += 1
            obs_metrics.counter(
                "dist_lease_calls_total", "queue round-trips",
                ("worker",)).labels(worker=worker).inc()
            if st.state != "active":
                # a draining or departed worker takes no more work: an
                # empty lease and the `draining` poll are its exit signal
                return []
            ids = self.queue.lease(worker, max_items)
            if not ids:
                # end of stream: nothing pending but work in flight, and
                # this worker idle: duplicate the slowest flagged item
                ids = self._speculate_for(worker)
            if self.straggler is not None:
                for wid in ids:
                    self.straggler.start(wid)
            st.leased_total += len(ids)
            if ids:
                obs_metrics.counter(
                    "dist_leased_ids_total", "work ids granted",
                    ("worker",)).labels(worker=worker).inc(len(ids))
            if self.telemetry is not None and ids:
                now = time.time()
                for wid in ids:
                    tl = self._timeline.setdefault(wid, {})
                    tl["lease_ts"] = now
                    tl["worker"] = worker
        if self.monitor is not None:
            self.monitor.beat(worker)
        hook = self.on_grant
        if hook is not None:
            for wid in ids:
                hook(worker, wid)
        return ids

    def _speculate_for(self, worker):
        """A speculative duplicate lease on the slowest straggling
        in-flight id for `worker`, or []. Called with the queue lock held,
        from an empty normal lease."""
        if self.straggler is None:
            return []
        for wid in self.straggler.stragglers():
            if self.queue.speculate(worker, wid):
                obs_metrics.counter(
                    "dist_speculations_total",
                    "speculative duplicate leases granted",
                    ("worker",)).labels(worker=worker).inc()
                # the eventual `done` record carries the count, whichever
                # incarnation wins
                tl = self._timeline.setdefault(wid, {})
                tl["speculated"] = tl.get("speculated", 0) + 1
                return [wid]
        return []

    def lease_chunks(self, worker, max_items=1):
        """Store-plane lease: grant work ids and publish their raw chunk
        batches to the shared store in the same round-trip, returning
        [[wid, key], ...]: the socket carries content keys, never the
        batches. A key of None means the id retired between grant and
        offer (a redelivery race); the worker skips it."""
        if self.data_plane is None:
            raise RuntimeError("this QueueService has no store data plane")
        ids = self.lease(worker, max_items)
        with self.queue.lock:
            cached = {wid: self._offered.get(wid) for wid in ids}
        out, fresh = [], {}
        for wid in ids:
            item = self._materialize(wid)
            if item is None:
                out.append([wid, None])
                continue
            key = cached.get(wid)
            if key is None:          # first offer: hash and publish once
                key = fresh[wid] = self.data_plane.offer(wid, item)
            self._note_fetch(wid, item, plane="store", key=key)
            out.append([wid, key])
        if fresh:
            with self.queue.lock:
                self._offered.update(fresh)
        return out

    def _materialize(self, wid):
        """wid -> chunk batch via the master's loader (None when retired)."""
        if self._fetch_item is None:
            raise RuntimeError("this QueueService serves no data plane "
                               "(no fetch_item)")
        return self._fetch_item(wid)

    def _note_fetch(self, wid, item, plane, key=None):
        """Data-plane accounting: the socket plane is charged the batch's
        bytes, the store plane only the key that replaced them."""
        raw = np.ascontiguousarray(item)
        wire = len(key) if plane == "store" else int(raw.nbytes)
        obs_metrics.counter(
            "dist_fetch_bytes_total",
            "data-plane bytes the master's socket carried for chunk "
            "fetches", ("plane",)).labels(plane=plane).inc(wire)
        if self.telemetry is None:
            return
        with self.queue.lock:
            tl = self._timeline.setdefault(wid, {})
            tl["fetch_ts"] = time.time()
            tl["bytes_in"] = int(raw.nbytes)
            tl["content_key"] = key[:21] if key is not None else \
                hashlib.sha256(memoryview(raw).cast("B")).hexdigest()[:16]

    def fetch(self, wid):
        """Socket data plane: the chunk batch of one leased work id,
        materialised master-side and shipped over the control socket."""
        item = self._materialize(wid)
        if item is not None:
            self._note_fetch(wid, item, plane="socket")
        return item

    def fetch_many(self, worker, wids):
        """Batched socket data plane: one round-trip for a whole lease
        batch, accounted item by item, with one heartbeat."""
        items = [self._materialize(wid) for wid in wids]
        for wid, item in zip(wids, items):
            if item is not None:
                self._note_fetch(wid, item, plane="socket")
        self.heartbeat(worker)
        return items

    def complete(self, work_ids, worker=None):
        return self.queue.complete(work_ids, worker=worker)

    def drain(self, worker):
        """Graceful leave: `worker` finishes the leases it holds and takes
        no more; its runtime polls `draining` and exits once its lease
        comes back empty."""
        with self.queue.lock:
            st = self._w(worker)
            if st.state == "active":
                obs_metrics.counter(
                    "dist_workers_drained_total",
                    "workers asked to leave gracefully",
                    ("worker",)).labels(worker=worker).inc()
                self._set_state(st, "draining")
        return True

    def draining(self, worker) -> bool:
        """Worker-side poll: has this worker been asked to leave?"""
        with self.queue.lock:
            st = self.workers.get(worker)
            return st is not None and st.state in ("draining", "departed")

    def push_result(self, worker, wid, payload):
        """Result plane: a worker hands back one finished work id. The
        master drains with `pop_results` and gates emission on
        `queue.complete`, so a push from a redelivery race is accepted here
        and discarded there. Each push extends the worker's remaining
        leases: progress is a heartbeat. On the store data plane the
        payload is a small `{"store_key": ...}` ref."""
        plane = ("store" if isinstance(payload, dict)
                 and "store_key" in payload else "socket")
        nbytes = _payload_nbytes(payload)
        obs_metrics.counter(
            "dist_push_bytes_total",
            "data-plane bytes the master's socket carried for result "
            "pushes", ("plane",)).labels(plane=plane).inc(nbytes)
        with self.queue.lock:
            self.queue.heartbeat_extend(worker)
            self._w(worker).last_beat = self.queue.clock()
            self._results.append((worker, wid, payload))
            obs_metrics.counter(
                "dist_pushes_total", "results pushed (pre-acceptance)",
                ("worker",)).labels(worker=worker).inc()
            if self.telemetry is not None:
                self._timeline.setdefault(wid, {})["push_ts"] = time.time()
        if self.monitor is not None:
            self.monitor.beat(worker)
        return True

    def heartbeat(self, worker):
        """Extend `worker`'s leases. Answers with the measured part the
        master last named (`mark`), or True where none was."""
        with self.queue.lock:
            self.queue.heartbeat_extend(worker)
            self._w(worker).last_beat = self.queue.clock()
            mark = self._mark
        if self.monitor is not None:
            self.monitor.beat(worker)
        return True if mark is None else mark

    def mark(self, on, trace=None):
        """Master-side (not served): name the start (`on`) or the end of a
        measured part to every worker, each at its next heartbeat. In the
        part a worker records its card's device operations and, given the
        master's tracer context (`trace`, `Tracer.propagate()`), its spans;
        `bye` carries them. Returns the mark's number."""
        with self.queue.lock:
            seq = 1 if self._mark is None else self._mark["seq"] + 1
            self._mark = {"seq": seq, "on": bool(on),
                          "trace": trace if on else None}
        return seq

    def fail_worker(self, worker):
        """Reclaim a dead worker's leases and record the death (state dead,
        epoch bump). Safe to call again."""
        with self.queue.lock:
            back = self.queue.fail_worker(worker)
            st = self.workers.get(worker)
            if st is not None and st.state not in ("departed", "dead"):
                self._set_state(st, "dead")
        return back

    def state(self):
        return self.queue.state()

    def progress(self):
        return self.queue.progress()

    @property
    def finished(self):
        return self.queue.finished

    def next_deadline(self):
        return self.queue.next_deadline()

    def bye(self, worker, stats=None):
        """Worker sign-off with its stats dict (idle/busy split, chunks,
        kernel launches), kept as received in `WorkerStats.report`, apart
        from the span events a tracing worker ships under "spans": those
        are merged into the master's tracer, which is how worker spans
        cross the pickle boundary."""
        stats = dict(stats or {})
        spans = stats.pop("spans", None)
        with self.queue.lock:
            st = self._w(worker)
            if stats:
                st.report = stats
                for k in ("idle_s", "busy_s"):
                    if k in stats:
                        setattr(st, k, float(stats[k]))
            if st.state != "dead":
                if st.state != "departed":
                    obs_metrics.counter(
                        "dist_workers_left_total",
                        "workers that signed off gracefully",
                        ("worker",)).labels(worker=worker).inc()
                self._set_state(st, "departed")
        # a departed worker stops heartbeating by design: drop it from
        # liveness tracking, so that it never reads as dead
        if self.monitor is not None:
            self.monitor.forget(worker)
        if spans:
            obs_tracing.get_tracer().add_events(spans)
        return True

    def metrics(self, render=False):
        """Read-only scrape of the master's metrics registry: a JSON- and
        pickle-safe snapshot, or Prometheus text when `render` is set."""
        reg = obs_metrics.get_registry()
        return reg.render() if render else reg.snapshot()

    # -- master-side (not served) -------------------------------------------
    def pop_results(self):
        """Drain the result inbox: [(worker, wid, payload), ...]."""
        out = []
        with self.queue.lock:
            while self._results:
                out.append(self._results.popleft())
        return out

    def resolve_result(self, payload):
        """Materialise a store-plane result ref into the full payload;
        socket-plane payloads pass through. Called by the master's emit
        loop, never in a handler thread."""
        if (self.data_plane is not None and isinstance(payload, dict)
                and "store_key" in payload):
            full = self.data_plane.take(payload["store_key"])
            if full is None:
                raise RuntimeError(
                    "store data plane lost result entry "
                    f"{payload['store_key'][:21]}…")
            return full
        return payload

    def worker_report(self):
        """Snapshot of every known worker's progress, sorted by shard:
        leases held now, chunks done, redeliveries charged to it, seconds
        since its last heartbeat."""
        with self.queue.lock:
            now = self.queue.clock()
            out = []
            for st in self.workers.values():
                st.leases_held = len(self.queue.leases_held(st.worker))
                st.redeliveries = int(
                    self.queue.redelivered_from.get(st.worker, 0))
                st.last_beat_age_s = (None if st.last_beat is None
                                      else float(now - st.last_beat))
                out.append(st)
            return sorted(out, key=lambda s: (s.shard, s.worker))

    # -- WorkQueue duck-typing (the in-process path) ------------------------
    def heartbeat_extend(self, worker):
        self.heartbeat(worker)

    def leases_held(self, worker):
        return self.queue.leases_held(worker)

    @property
    def clock(self):
        return self.queue.clock

    @property
    def lease_timeout_s(self):
        return self.queue.lease_timeout_s

    @property
    def redeliveries(self):
        return self.queue.redeliveries

    @property
    def redelivered_from(self):
        return self.queue.redelivered_from

    @property
    def n_items(self):
        return self.queue.n_items


# -------------------------------------------------------- result protocol

def _payload_nbytes(payload) -> int:
    """Wire-size estimate of one data-plane value: array bytes dominate;
    strings and bytes count their length; scalars a flat 8."""
    if payload is None:
        return 0
    if isinstance(payload, np.ndarray):
        return int(payload.nbytes)
    if isinstance(payload, dict):
        return sum(_payload_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(_payload_nbytes(v) for v in payload)
    if isinstance(payload, (str, bytes)):
        return len(payload)
    return 8


def pack_result(res) -> dict:
    """BatchResult -> payload: masks + stats + cleaned survivors, all
    numpy. The pre-denoise wave5 intermediate is not kept, only its width,
    so that the reader can rebuild a det record of the right shape."""
    det = res.det
    return {
        "cleaned": np.asarray(to_host(res.cleaned), np.float32),
        "keep": to_host(det.keep), "rain": to_host(det.rain),
        "silence": to_host(det.silence), "cicada15": to_host(det.cicada15),
        "stats": {k: (int(v) if k == "n_chunks5" else float(v))
                  for k, v in det.stats.items()},
        "n_kept": int(res.n_kept), "src_bytes": int(res.src_bytes),
        "wave_width": int(det.wave5.shape[-1]),
    }


def unpack_result(payload):
    """payload -> (PipelineOutput of CPU tensors, fields): fields carries
    cleaned / n_kept / src_bytes. wave5 is zeros at the recorded shape, as
    in the reference: an intermediate no consumer reads."""
    keep = torch.as_tensor(payload["keep"])
    wave5 = torch.zeros((keep.shape[0], int(payload["wave_width"])),
                        dtype=torch.float32)
    det = PipelineOutput(wave5=wave5, keep=keep,
                         rain=torch.as_tensor(payload["rain"]),
                         silence=torch.as_tensor(payload["silence"]),
                         cicada15=torch.as_tensor(payload["cicada15"]),
                         stats=dict(payload["stats"]))
    return det, {"cleaned": payload["cleaned"],
                 "n_kept": int(payload["n_kept"]),
                 "src_bytes": int(payload["src_bytes"])}
