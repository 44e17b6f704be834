"""Host-side leased work queue (the port's own copy of `Lease`,
`SettableClock` and `WorkQueue` from the reference's `data/queue.py`, which
imports no JAX; the port imports nothing of the reference package).

Workers lease work ids with deadlines; completion retires them exactly
once; an expired lease, or a failed worker's, returns its ids to the queue;
`speculate` grants one duplicate lease on an in-flight id, first completion
wins. `state` / `from_state` give the snapshot that `store.RunJournal`
records, so a killed run resumes without loss or repetition.
`StandingWorkQueue` is the serving pool's open-ended queue: work arrives
with `add()` and the queue is `finished` only after `close()` drains it.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field


@dataclass
class Lease:
    work_id: int
    worker: str
    deadline: float


class SettableClock:
    """Deterministic injectable clock for tests and simulations:

        clock = SettableClock()
        q = WorkQueue(n, lease_timeout_s=5.0, clock=clock)
        clock.t = 10.0        # every outstanding lease is now expired

    Consumers (e.g. ShardedPlan's stall path) treat any clock other than
    `time.monotonic` / `time.time` as non-wall and skip real sleeps."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


class WorkQueue:
    def __init__(self, n_items, lease_timeout_s=60.0, clock=time.monotonic):
        self.n_items = n_items
        self.lease_timeout_s = lease_timeout_s
        self.clock = clock
        self.lock = threading.RLock()
        self._pending = list(range(n_items - 1, -1, -1))   # stack, pop() = 0..
        self._leases: dict[int, Lease] = {}
        # speculative duplicate leases, wid -> Lease: at most ONE backup
        # copy per in-flight id, held by a different worker than the
        # primary. First completion wins; see speculate().
        self._spec: dict[int, Lease] = {}
        self._done = set()
        self.redeliveries = 0
        self.speculations = 0           # speculative leases ever granted
        self.speculations_lost = 0      # incarnations that lost the race
        # per-worker attribution of lost leases (expiry or fail_worker):
        # who HELD the lease that had to be redelivered, for a
        # per-worker summary.
        self.redelivered_from = collections.Counter()
        # Optional hook fired (under the queue lock) whenever a lease is
        # reclaimed: on_redeliver(wid, worker, reason) with reason
        # "expired" (deadline passed), "failed" (fail_worker), or
        # "speculated" (this incarnation lost a first-completion-wins race
        # against its duplicate). repro.obs wires this to durable
        # telemetry + redelivery counters.
        self.on_redeliver = None
        # Optional hook fired (under the queue lock) with the list of
        # NEWLY retired ids whenever complete() makes progress — the
        # QueueService feeds its StragglerDetector from here so every
        # completion path (proc emit loop, sim rounds, pool pump) counts.
        self.on_complete = None

    # -- worker API ---------------------------------------------------------
    def lease(self, worker, max_items=1):
        """Lease up to max_items work ids (the slave's pull request —
        max_items is the paper's Table 7 queue-size knob).

        Ids completed late — after their expired lease was already reaped
        back into pending — are dropped here instead of re-delivered, so a
        straggler that finishes just past its deadline costs nothing."""
        with self.lock:
            self._reap_expired()
            out = []
            while self._pending and len(out) < max_items:
                wid = self._pending.pop()
                if wid in self._done:
                    continue
                self._leases[wid] = Lease(wid, worker,
                                          self.clock() + self.lease_timeout_s)
                out.append(wid)
            return out

    def complete(self, work_ids, worker=None):
        """Retire work ids. Returns the ids that were NEWLY retired: a late
        completion of already-done work (the at-least-once overlap) comes
        back empty, so callers can gate result emission on it and keep
        exactly-once output on top of at-least-once delivery.

        `worker` (optional) names who produced the winning result. It only
        matters for ids carrying a speculative duplicate lease: the OTHER
        incarnation lost the first-completion-wins race and is attributed
        via `on_redeliver(wid, loser, "speculated")`. Without a winner
        name the primary is presumed to have won (the historical path —
        only the emit loops that speculate pass it)."""
        with self.lock:
            newly = []
            for wid in work_ids:
                if wid in self._done:
                    continue
                primary = self._leases.pop(wid, None)
                spec = self._spec.pop(wid, None)
                self._done.add(wid)
                newly.append(wid)
                if spec is None:
                    continue
                if worker is None:
                    losers = [spec]
                else:
                    losers = [l for l in (primary, spec)
                              if l is not None and l.worker != worker]
                for l in losers:
                    self.speculations_lost += 1
                    if self.on_redeliver is not None:
                        self.on_redeliver(wid, l.worker, "speculated")
            if newly and self.on_complete is not None:
                self.on_complete(newly)
            return newly

    def speculate(self, worker, wid) -> bool:
        """Grant `worker` a SPECULATIVE duplicate lease on the in-flight
        id `wid` WITHOUT reaping the primary lease (the backup-task rule:
        near end-of-stream an idle worker re-runs the slowest in-flight
        item). Refused — returns False — when the id is not currently
        leased, already done, already has a backup, or `worker` is the
        primary holder itself. Exactly-once emission needs no new
        machinery: both incarnations push, `complete()` retires the id
        once, and the loser is attributed there."""
        with self.lock:
            self._reap_expired()
            lease = self._leases.get(wid)
            if (lease is None or wid in self._done or wid in self._spec
                    or lease.worker == worker):
                return False
            self._spec[wid] = Lease(wid, worker,
                                    self.clock() + self.lease_timeout_s)
            self.speculations += 1
            return True

    def speculated(self):
        """Work ids currently carrying a speculative duplicate lease."""
        with self.lock:
            return sorted(self._spec)

    def heartbeat_extend(self, worker):
        with self.lock:
            now = self.clock()
            for lease in self._leases.values():
                if lease.worker == worker:
                    lease.deadline = now + self.lease_timeout_s
            for lease in self._spec.values():
                if lease.worker == worker:
                    lease.deadline = now + self.lease_timeout_s

    def leases_held(self, worker):
        """Work ids currently leased by `worker`, speculative duplicates
        included (progress/busy reporting — a worker re-running a
        straggler's item is busy)."""
        with self.lock:
            held = {wid for wid, l in self._leases.items()
                    if l.worker == worker}
            held |= {wid for wid, l in self._spec.items()
                     if l.worker == worker}
            return sorted(held)

    def is_done(self, wid) -> bool:
        """True once `wid` is retired — lets a data plane refuse to serve
        (or regenerate) an item whose redelivered lease lost the race to a
        straggler's completion."""
        with self.lock:
            return wid in self._done

    # -- failure handling ---------------------------------------------------
    def _reap_expired(self):
        now = self.clock()
        # expired speculative copies just evaporate: the primary still
        # owns the id, nothing returns to pending, no redelivery counted
        for wid in [w for w, l in self._spec.items() if l.deadline < now]:
            del self._spec[wid]
        expired = [wid for wid, l in self._leases.items() if l.deadline < now]
        for wid in expired:
            worker = self._leases[wid].worker
            self.redelivered_from[worker] += 1
            del self._leases[wid]
            spec = self._spec.pop(wid, None)
            if spec is not None:
                # a live backup is already computing this id: promote it
                # to primary instead of re-queueing (third copies add
                # nothing but load)
                self._leases[wid] = spec
            else:
                self._pending.append(wid)
            self.redeliveries += 1
            if self.on_redeliver is not None:
                self.on_redeliver(wid, worker, "expired")

    def next_deadline(self):
        """Earliest outstanding lease deadline (None when nothing is
        leased) — lets a stalled consumer wait out exactly the time until
        the next reap can make progress."""
        with self.lock:
            return min((l.deadline for l in self._leases.values()),
                       default=None)

    def fail_worker(self, worker):
        """Immediately return a dead worker's leases (heartbeat said dead).
        Ids whose speculative copy is still alive are promoted to that
        copy instead of re-queued; the dead worker's own speculative
        copies evaporate (their primaries are alive and computing)."""
        with self.lock:
            for wid in [w for w, l in self._spec.items()
                        if l.worker == worker]:
                del self._spec[wid]
            back = [wid for wid, l in self._leases.items()
                    if l.worker == worker]
            for wid in back:
                del self._leases[wid]
                spec = self._spec.pop(wid, None)
                if spec is not None:
                    self._leases[wid] = spec
                else:
                    self._pending.append(wid)
                self.redeliveries += 1
                if self.on_redeliver is not None:
                    self.on_redeliver(wid, worker, "failed")
            if back:
                # attribute only real losses: `Counter[w] += 0` would
                # CREATE a phantom zero-count entry, polluting the
                # launcher's per-worker summary with workers that never
                # lost a lease
                self.redelivered_from[worker] += len(back)
            return back

    # -- checkpoint ---------------------------------------------------------
    def state(self):
        """Serializable snapshot: done ids plus the ids still leased at
        snapshot time. Leased ids are recorded so a journal shows what was
        in flight when the process died; on restore they re-enter pending
        (their lease holder died with the process)."""
        with self.lock:
            self._reap_expired()
            return {"n_items": self.n_items, "done": sorted(self._done),
                    "leased": sorted(self._leases)}

    @classmethod
    def from_state(cls, state, **kw):
        """Rebuild from a snapshot: everything not done — including ids the
        snapshot recorded as leased — re-enters pending, so outstanding
        leases are redelivered, never lost."""
        q = cls(state["n_items"], **kw)
        done = set(state["done"])
        q._done = done
        q._pending = [i for i in range(state["n_items"] - 1, -1, -1)
                      if i not in done]
        return q

    @property
    def finished(self):
        with self.lock:
            return len(self._done) == self.n_items

    def progress(self):
        with self.lock:
            return len(self._done), self.n_items


class StandingWorkQueue(WorkQueue):
    """Open-ended WorkQueue for a persistent serving pool.

    A batch run knows its item count up front; a serving pool does not —
    work arrives continuously (`add()`), and the pool's long-lived workers
    must keep polling through idle gaps instead of exiting the moment the
    queue momentarily drains. So `finished` only turns True after
    `close()` once every admitted item is done: the worker runtime's
    "lease came back empty AND finished" exit condition becomes the
    pool's graceful-drain signal, with zero worker-side changes.

    Items lease oldest-first (FIFO admission order); redelivered items
    (lease expiry, `fail_worker`) keep the base class's
    go-to-the-front-of-the-line priority, so a crashed worker's request
    is re-served before newer traffic."""

    def __init__(self, lease_timeout_s=60.0, clock=time.monotonic):
        super().__init__(0, lease_timeout_s, clock)
        self.closed = False

    def add(self) -> int:
        """Admit one new work item; returns its work id."""
        with self.lock:
            if self.closed:
                raise RuntimeError(
                    "standing queue is closed to new work (draining)")
            wid = self.n_items
            self.n_items += 1
            # pending is a stack popped from the END; oldest ids must sit
            # there, so new admissions go to the FRONT
            self._pending.insert(0, wid)
            return wid

    def close(self):
        """Stop admission; already-admitted work still drains."""
        with self.lock:
            self.closed = True

    def abort(self):
        """Hard stop: close AND discard all unfinished work, so workers
        polling for `finished` exit without draining. The pool's
        non-graceful shutdown path (in-proc worker threads have no pid to
        TERM — this is how they are told to stop)."""
        with self.lock:
            self.closed = True
            self._done = set(range(self.n_items))
            self._leases.clear()
            self._spec.clear()
            self._pending.clear()

    def depth(self):
        """(queued, leased): admitted items waiting for a worker vs
        currently in flight — the pool-level backlog gauges."""
        with self.lock:
            self._reap_expired()
            leased = len(self._leases)
            return self.n_items - len(self._done) - leased, leased

    @property
    def finished(self):
        with self.lock:
            return self.closed and len(self._done) == self.n_items
