"""Fault-tolerance primitives for the master/worker runtime (the port's
own copy of `CrashInjector`, `HeartbeatMonitor` and `StragglerDetector`
from the reference's `ft/failure.py`, which imports no JAX; the port
imports nothing of the reference package).

They run on the master's host; clocks are injectable, so that the logic
is tested without wall-time sleeps. The paper's master "re-sends files to
different slaves if a slave disconnects or crashes": here a heartbeat
timeout marks a worker dead, its queue leases come back (`data/queue.py`)
and another worker takes them. The reference's `MeshPlan` / `plan_mesh`
serve the LLM stack's elastic restart and come with it.
"""
from __future__ import annotations

import os
import signal
import time


class CrashInjector:
    """Scripted worker crashes — simulated shards AND real processes.

    `kill(shard, after_items=n)` arms a fuse: the shard detects n more
    pulled items normally, then dies while HOLDING its next lease — the
    lease is neither completed nor returned, so recovery exercises the real
    path (lease expiry or `WorkQueue.fail_worker`), mirroring the paper's
    master that "re-sends files to different slaves if a slave disconnects
    or crashes".

    Process mode: `attach(shard, pid)` binds the shard to a real worker
    process (the sharded plan's proc transport does this at spawn). When
    the fuse burns, the injected death is a genuine SIGKILL of that pid —
    no atexit, no socket shutdown, the worker just stops existing
    mid-lease, and the queue's redelivery machinery is observed end to
    end."""

    def __init__(self):
        self._fuse: dict[int, int] = {}
        self._dead: set[int] = set()
        self._pids: dict[int, int] = {}

    def kill(self, shard, after_items=0):
        self._fuse[shard] = int(after_items)

    def attach(self, shard, pid):
        """Bind `shard` to a live worker process id: its injected death
        becomes a real SIGKILL."""
        self._pids[shard] = int(pid)

    def revive(self, shard):
        """Forget `shard`'s death, fuse and pid: a respawned worker under
        the same shard id starts clean."""
        self._dead.discard(shard)
        self._fuse.pop(shard, None)
        self._pids.pop(shard, None)

    def alive(self, shard) -> bool:
        return shard not in self._dead

    def _die(self, shard):
        self._dead.add(shard)
        pid = self._pids.get(shard)
        if pid is not None:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:    # already gone — dead is dead
                pass

    def on_pull(self, shard) -> bool:
        """Called once per pulled work item BEFORE it is processed.
        Returns False exactly when the shard dies on this pull (its lease
        stays registered in the queue, un-completed). With an attached
        pid, dying means SIGKILL — the caller's return-value handling is
        then moot, the process is gone."""
        if shard in self._dead:
            return False
        fuse = self._fuse.get(shard)
        if fuse is not None:
            if fuse <= 0:
                self._die(shard)
                return False
            self._fuse[shard] = fuse - 1
        return True

    @property
    def crashed(self) -> frozenset:
        return frozenset(self._dead)


class HeartbeatMonitor:
    def __init__(self, timeout_s=30.0, clock=time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self._last = {}

    def beat(self, worker_id):
        self._last[worker_id] = self.clock()

    def forget(self, worker_id):
        """Drop a worker from liveness tracking entirely. A drained or
        departed worker stops heartbeating BY DESIGN — without this it
        would sit in `dead()` forever, and every elastic scale-down would
        permanently trip the dead-worker fast path (fail_worker storms on
        a worker that left cleanly holding nothing)."""
        self._last.pop(worker_id, None)

    def alive(self):
        now = self.clock()
        return {w for w, t in self._last.items()
                if now - t <= self.timeout_s}

    def dead(self):
        now = self.clock()
        return {w for w, t in self._last.items() if now - t > self.timeout_s}


class StragglerDetector:
    """Backup-task rule: a task is a straggler if it has run longer than
    `factor` x the rolling p95 of completed-task latencies (min history
    before firing). Mirrors the paper's observation that even load needs
    re-dispatch when a slave slows down."""

    def __init__(self, factor=2.0, min_history=20, clock=time.monotonic):
        self.factor = factor
        self.min_history = min_history
        self.clock = clock
        self._latencies = []
        self._inflight = {}

    def start(self, task_id):
        self._inflight[task_id] = self.clock()

    def complete(self, task_id):
        t0 = self._inflight.pop(task_id, None)
        if t0 is not None:
            self._latencies.append(self.clock() - t0)
            if len(self._latencies) > 1000:
                self._latencies = self._latencies[-500:]

    def p95(self):
        if not self._latencies:
            return float("inf")
        xs = sorted(self._latencies)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def stragglers(self):
        """In-flight task ids past the backup-task limit, LONGEST-running
        first — the speculation path re-leases from the front, so the
        slowest item gets the first idle backup worker."""
        if len(self._latencies) < self.min_history:
            return []
        limit = self.factor * self.p95()
        now = self.clock()
        return sorted((t for t, t0 in self._inflight.items()
                       if now - t0 > limit),
                      key=lambda t: self._inflight[t])
