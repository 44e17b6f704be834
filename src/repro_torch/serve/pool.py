"""Persistent worker pool: long-lived `repro_torch.dist` workers serving a
standing queue (the port's copy of the reference's `serve/pool.py`).

The batch runtime (`ShardedPlan` in process mode) spawns workers per run
and tears them down with the stream: right for archives, wrong for
serving, where every request wave would pay the spawn again. On the card
that spawn is a fresh interpreter, a CUDA context, the kernel libraries'
load and the first cuFFT plans: seconds per worker. `WorkerPool` spawns
the workers once, over the existing transports (`InProcTransport` threads
or `ProcTransport` processes running the same `dist.worker.run_worker`
loop), and they stay alive across submissions because the pool's
`StandingWorkQueue` reports `finished` only after `close()` drains it: an
idle worker's empty lease turns into a heartbeat and a poll, not an exit.
Wave 2 runs on the same pids as wave 1, each with its context, allocator
and cuFFT plans already made.

Work enters through `submit(chunks) -> wid` (any (B, C, S_long_src) batch;
the continuous batcher assembles those from single-chunk requests) and
leaves through `poll()` / `claim()` / `wait()` as the port's `BatchResult`:
workers run the `two_phase` path (detection, device compaction, survivor
tail) on the device the setup blob names, so pool output is bitwise equal
to a `two_phase` call on the same batch and device.

Faults: leases and completion gating give at-least-once delivery with
exactly-once results. A SIGKILLed worker's leases come back through
`fail_worker` (the pool notices the dead pid on its next pump) or lease
expiry, and the redelivered request goes to the front of the line.
`respawn=True` also replaces dead proc workers.

Observability: `worker_stats` is the per-worker `WorkerStats` ledger of
the batch runtime; `gauges()` adds the pool's serving view (busy and idle
workers, queue depth, leases in flight, oldest request's age), mirrored
into the metrics registry.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.core.graph import PipelineGraph
from repro_torch.core.plans import BatchResult, ShardedPlan
from repro_torch.data.queue import StandingWorkQueue
from repro_torch.device import resolve_device, to_host, worker_env
from repro_torch.dist.data_plane import StoreDataPlane
from repro_torch.dist.service import QueueService, unpack_result
from repro_torch.dist.transport import (InProcTransport, ProcTransport,
                                        TcpTransport)
from repro_torch.dist.worker import run_worker
from repro_torch.ft.failure import StragglerDetector
from repro_torch.obs import metrics as obs_metrics


class WorkerPool:
    """Long-lived preprocessing workers over a standing QueueService.

    Parameters:
      cfg              pipeline config (the setup blob workers build their
                       plan from: the facts ShardedPlan ships)
      workers          pool size
      transport        "proc" (real processes, SIGKILL-able), "tcp" (real
                       processes over a non-loopback bind, so that workers
                       may join from other hosts; pair with `store=`) or
                       "inproc" (daemon threads in this process driving the
                       same worker runtime: no spawn cost; on the card they
                       share this process's CUDA context)
      store            optional shared-store data plane (a ChunkStore,
                       directory path, or StoreDataPlane): request bytes
                       and result payloads move through the store, the
                       control socket carries only content keys
      stages           optional stage-name override (None: the config's)
      pad_multiple / bucket
                       the workers' tail policy; "pow2" bounds the tail
                       shapes a request mix produces
      lease_timeout_s  None: 300 s for worker processes (their first item
                       pays their start-up), 60 s for threads
      poll_s           worker sleep after an empty lease (the idle wake-up
                       latency for new work)
      respawn          replace dead proc workers (dead workers have their
                       leases reclaimed either way; respawn=False lets a
                       test prove the survivors absorb the load)
      min_workers /    queue-depth autoscaling band. max_workers arms it
      max_workers      (None: a fixed pool): sustained backlog (more than
                       autoscale_backlog_s with unleased work queued)
                       spawns a late joiner up to max_workers; a pool idle
                       for autoscale_idle_s drains one idle worker down to
                       min_workers (default `workers`); a drained worker
                       exits through bye, never reaped
      speculate        arm speculative re-lease: an idle worker whose lease
                       comes back empty may duplicate the slowest
                       straggling item in flight (first completion wins)
      straggler_factor / straggler_min_history
                       the StragglerDetector's dials when speculating
      monitor          optional ft.failure.HeartbeatMonitor
      telemetry        optional obs.telemetry.TelemetryWriter: the
                       service writes one record per accepted request
      device           where the workers compute: None is the card (and
                       raises without one), "cpu" the plain versions. The
                       reference takes a kernel backend mode here.
    """

    def __init__(self, cfg, workers=2, transport="proc", stages=None,
                 source_channels=2, pad_multiple=1, bucket="pow2",
                 lease_items=1, lease_timeout_s=None, poll_s=0.01,
                 respawn=True, monitor=None, telemetry=None,
                 min_workers=None, max_workers=None,
                 autoscale_backlog_s=0.75, autoscale_idle_s=5.0,
                 speculate=False, straggler_factor=2.0,
                 straggler_min_history=4, store=None, device=None):
        if transport not in ("proc", "tcp", "inproc"):
            raise ValueError(f"unknown transport {transport!r} "
                             "(expected 'proc', 'tcp' or 'inproc')")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.workers = max(1, int(workers))
        self.transport = transport
        self.lease_items = max(1, int(lease_items))
        self.poll_s = float(poll_s)
        self.respawn = bool(respawn)
        self.min_workers = (self.workers if min_workers is None
                            else max(1, int(min_workers)))
        self.max_workers = None if max_workers is None \
            else max(self.min_workers, int(max_workers))
        self.autoscale_backlog_s = float(autoscale_backlog_s)
        self.autoscale_idle_s = float(autoscale_idle_s)
        self.scale_ups = 0
        self.scale_downs = 0
        self._backlog_since = None      # monotonic ts backlog first seen
        self._idle_since = None         # monotonic ts full idle first seen
        self.monitor = monitor
        if lease_timeout_s is None:
            lease_timeout_s = ShardedPlan.default_lease_timeout(transport)
        self.queue = StandingWorkQueue(lease_timeout_s=lease_timeout_s)
        # the port's blob, as ShardedPlan._proc_setup ships it: the device
        # type to run on in place of the reference's backend mode
        self._setup = {"cfg": cfg,
                       "stages": list(stages) if stages else None,
                       "source_channels": int(source_channels),
                       "pad_multiple": int(pad_multiple),
                       "bucket": bucket,
                       "device": self.device.type}
        straggler = StragglerDetector(
            factor=float(straggler_factor),
            min_history=int(straggler_min_history)) if speculate else None
        if store is not None and not isinstance(store, StoreDataPlane):
            # CachedPlan's value identity, as ShardedPlan gives its plane:
            # a result computed on another device type is never reused
            graph = PipelineGraph(cfg, stages, source_channels)
            store = StoreDataPlane(
                store, graph_fingerprint=graph.fingerprint,
                framework_tag=f"torch-{self.device.type}")
        self.service = QueueService(self.queue, fetch_item=self._fetch,
                                    setup=self._setup, monitor=monitor,
                                    telemetry=telemetry,
                                    straggler=straggler, data_plane=store)
        self._items = {}        # wid -> chunk bytes (the data plane)
        self._submit_t = {}     # wid -> submit time (oldest-age gauge)
        self._completed = {}    # wid -> BatchResult awaiting claim
        self._claim_lock = threading.Lock()
        self._handles = {}      # shard -> WorkerHandle (proc)
        self._threads = {}      # shard -> Thread (inproc)
        self._dead = set()      # shards whose leases were reclaimed
        self._next_shard = self.workers   # late joiners get fresh ids
        self.respawns = 0
        self._tp = None
        self._started = False
        self._shut = False

    @property
    def _procs(self) -> bool:
        return self.transport in ("proc", "tcp")

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        """Spawn the workers once; they live until shutdown(). On the card
        the kernel libraries are built here, before the first spawn, so
        that every worker only loads them."""
        if self._started:
            raise RuntimeError("pool already started")
        self._started = True
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build()
        if self._procs:
            self._tp = TcpTransport() if self.transport == "tcp" \
                else ProcTransport()
        else:
            self._tp = InProcTransport()
        self._tp.serve(self.service)
        for k in range(self.workers):
            self._spawn_any(k)
        return self

    def _spawn_any(self, shard):
        if self._procs:
            self._handles[shard] = self._spawn(shard)
        else:
            self._threads[shard] = self._spawn_thread(shard)

    def _spawn(self, shard):
        # the shard id never rides argv: it is reserved with the registry,
        # so that the worker's announcing hello adopts it
        h = self._tp.spawn_worker(shard, lease_items=self.lease_items,
                                  poll_s=self.poll_s,
                                  env_extra=worker_env(self.device, shard))
        self.service.reserve(h.pid, shard)
        return h

    def _spawn_thread(self, shard):
        t = threading.Thread(
            target=run_worker, args=(self.service, shard),
            kwargs=dict(lease_items=self.lease_items, poll_s=self.poll_s,
                        transport=InProcTransport()),
            daemon=True, name=f"repro-pool-shard{shard}")
        t.start()
        return t

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(drain=exc_type is None)

    # -- work plane ---------------------------------------------------------
    def submit(self, chunks) -> int:
        """Admit one (B, C, S_long_src) batch (host f32; a tensor is copied
        to the host); returns its work id. The item is registered under
        the queue's own lock together with the admission, so that no lease
        can see a wid whose bytes are not fetchable yet."""
        x = np.asarray(to_host(chunks), np.float32)
        with self.queue.lock:
            wid = self.queue.add()
            self._items[wid] = x
            self._submit_t[wid] = time.monotonic()
        return wid

    def _fetch(self, wid):
        """Data plane. None answers a redelivered lease that lost the race
        to a straggler's completion: the worker skips it."""
        if self.queue.is_done(wid):
            return None
        with self.queue.lock:
            item = self._items.get(wid)
        if item is None:
            if self.queue.is_done(wid):
                return None
            raise KeyError(f"work id {wid} has no registered item")
        return item

    def _pump(self):
        """Drain worker pushes into the completed set, gated on
        `queue.complete` so that at-least-once pushes stay exactly-once
        results; then reclaim dead workers and autoscale."""
        for worker, wid, payload in self.service.pop_results():
            # the winner's name rides into complete(), so that a lost
            # speculation race is charged to the other incarnation
            if not self.queue.complete([wid], worker=worker):
                continue            # a redelivery raced a straggler
            # store plane: the push was a key ref, read here after the
            # gate (a loser never costs a store read)
            det, f = unpack_result(self.service.resolve_result(payload))
            self.service.note_done(worker, wid=wid,
                                   survivors=int(f["n_kept"]),
                                   bytes_out=f["cleaned"].nbytes)
            with self.queue.lock:
                self._items.pop(wid, None)
                self._submit_t.pop(wid, None)
            res = BatchResult(cleaned=f["cleaned"], det=det,
                              n_kept=f["n_kept"], wid=wid,
                              src_bytes=f["src_bytes"])
            with self._claim_lock:
                self._completed[wid] = res
        self._reap_dead()
        self._autoscale()

    def _departed(self, worker) -> bool:
        st = self.service.workers.get(worker)
        return st is not None and st.state in ("draining", "departed")

    def _reap_dead(self):
        """Return a dead worker's leases at once (the fail_worker fast
        path; lease expiry is the slow fallback) and, for a proc pool with
        respawn, replace the process. A worker that exited draining or
        departed left gracefully holding nothing: it is forgotten, never
        failed."""
        for k, h in list(self._handles.items()):
            if h.poll() is None:
                continue
            if self._departed(h.worker):
                del self._handles[k]
                self._dead.discard(k)
                continue
            if k in self._dead:
                continue
            self._dead.add(k)
            self.service.fail_worker(h.worker)
            if self.respawn and not self.queue.closed:
                self._handles[k] = self._spawn(k)
                self._dead.discard(k)
                self.respawns += 1
                obs_metrics.counter(
                    "pool_respawns_total",
                    "dead proc workers replaced").inc()
        for k, t in list(self._threads.items()):
            if t.is_alive():
                continue
            if self._departed(f"shard{k}"):
                del self._threads[k]
                self._dead.discard(k)
                continue
            if k not in self._dead and not self.queue.finished:
                self._dead.add(k)
                self.service.fail_worker(f"shard{k}")

    # -- elasticity ---------------------------------------------------------
    def _live_active(self):
        """Live workers not on their way out: the autoscaler's capacity."""
        out = [k for k, h in self._handles.items()
               if h.poll() is None and not self._departed(h.worker)]
        out += [k for k, t in self._threads.items()
                if t.is_alive() and not self._departed(f"shard{k}")]
        return sorted(out)

    def add_worker(self):
        """Spawn one late joiner on a fresh shard id (a manual scale-up;
        the autoscaler calls it too). Returns the new shard id."""
        k = self._next_shard
        self._next_shard += 1
        self._spawn_any(k)
        self.scale_ups += 1
        obs_metrics.counter(
            "pool_scale_ups_total",
            "late joiners spawned on sustained backlog").inc()
        return k

    def drain_worker(self, shard=None):
        """Ask one worker to leave gracefully: finish held leases, take no
        more, exit through bye (a manual scale-down; the autoscaler calls
        it with an idle pick). Returns the drained shard id, or None if no
        worker can be drained."""
        with self.queue.lock:
            if shard is None:
                for k in reversed(self._live_active()):
                    if not self.queue.leases_held(f"shard{k}"):
                        shard = k
                        break
            if shard is None:
                return None
            self.service.drain(f"shard{shard}")
        if self.monitor is not None:
            self.monitor.forget(f"shard{shard}")
        self.scale_downs += 1
        obs_metrics.counter(
            "pool_scale_downs_total",
            "idle workers drained out on sustained idleness").inc()
        return shard

    def _autoscale(self):
        """Queue-depth elasticity, armed by max_workers: sustained unleased
        backlog spawns a late joiner; a sustained idle pool drains one idle
        worker. One transition per sustain window: the timestamps re-arm
        after every action, so that the pool walks to the band's edge."""
        if self.max_workers is None or self._shut or self.queue.closed:
            return
        queued, leased = self.queue.depth()
        now = time.monotonic()
        live = len(self._live_active())
        if queued > 0:
            self._idle_since = None
            if self._backlog_since is None:
                self._backlog_since = now
            elif (now - self._backlog_since >= self.autoscale_backlog_s
                    and live < self.max_workers):
                self.add_worker()
                self._backlog_since = now
        elif queued == 0 and leased == 0:
            self._backlog_since = None
            if self._idle_since is None:
                self._idle_since = now
            elif (now - self._idle_since >= self.autoscale_idle_s
                    and live > self.min_workers):
                self.drain_worker()
                self._idle_since = now
        else:
            self._backlog_since = None
            self._idle_since = None

    def poll(self):
        """Non-blocking: drain and return every newly completed {wid:
        BatchResult}. Each result is handed over once; a claimed wid is
        forgotten."""
        self._pump()
        with self._claim_lock:
            out, self._completed = self._completed, {}
        return out

    def claim(self, wids):
        """Non-blocking targeted claim: drain, then return whichever of
        `wids` are done. Other submitters' results stay unclaimed, so that
        several front-ends can share one pool."""
        self._pump()
        out = {}
        with self._claim_lock:
            for wid in set(wids) & self._completed.keys():
                out[wid] = self._completed.pop(wid)
        return out

    def wait(self, wids, timeout_s=600.0):
        """Block until every wid in `wids` completes; returns {wid:
        BatchResult}, claiming only the asked-for wids."""
        want = set(wids)
        got = {}
        deadline = time.monotonic() + timeout_s
        while True:
            self._pump()
            with self._claim_lock:
                for wid in want & self._completed.keys():
                    got[wid] = self._completed.pop(wid)
                want -= got.keys()
            if not want:
                return got
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pool did not complete {sorted(want)} within "
                    f"{timeout_s:.0f}s (gauges: {self.gauges()})")
            time.sleep(0.002)

    # -- observability ------------------------------------------------------
    @property
    def pids(self):
        """shard -> pid of the live proc workers ({} for inproc): the
        same-workers-across-waves observable."""
        return {k: h.pid for k, h in self._handles.items()
                if h.poll() is None}

    @property
    def worker_stats(self):
        """The per-worker WorkerStats ledger (lease calls, chunks done,
        leases held, redeliveries charged, heartbeat age, bye report)."""
        return self.service.worker_report()

    def gauges(self):
        """Pool-level serving gauges: busy/idle workers, queue depth,
        leases in flight, oldest unserved request's age."""
        queued, leased = self.queue.depth()
        with self.queue.lock:
            busy = sum(1 for st in self.service.workers.values()
                       if self.queue.leases_held(st.worker))
            oldest = min(self._submit_t.values(), default=None)
        live = (len([h for h in self._handles.values()
                     if h.poll() is None])
                or len([t for t in self._threads.values() if t.is_alive()]))
        done, total = self.queue.progress()
        out = {"workers": live, "busy": busy,
               "idle": max(0, live - busy),
               "queue_depth": queued, "in_flight": leased,
               "oldest_age_s": (None if oldest is None
                                else time.monotonic() - oldest),
               "submitted": total, "completed": done,
               "epoch": self.service.epoch,
               "scale_ups": self.scale_ups,
               "scale_downs": self.scale_downs}
        reg = obs_metrics.get_registry()
        if reg.enabled:
            reg.gauge("pool_workers", "live workers").set(live)
            reg.gauge("pool_busy", "workers holding leases").set(busy)
            reg.gauge("pool_queue_depth", "unleased work ids").set(queued)
            reg.gauge("pool_in_flight", "leased, uncompleted ids").set(leased)
            reg.gauge("pool_oldest_age_s",
                      "age of the oldest unserved request").set(
                          out["oldest_age_s"] or 0.0)
            reg.gauge("pool_membership_epoch",
                      "pool membership version (joins/drains/deaths)").set(
                          self.service.epoch)
        return out

    def kill_worker(self, shard):
        """SIGKILL a proc worker (fault testing: the pool must redeliver its
        request in flight exactly once)."""
        self._handles[shard].kill()

    # -- teardown -----------------------------------------------------------
    def drain(self, timeout_s=600.0):
        """Close admission and pump until every admitted item completed."""
        self.queue.close()
        deadline = time.monotonic() + timeout_s
        while not self.queue.finished:
            self._pump()
            if self.queue.finished:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pool drain timed out (gauges: {self.gauges()})")
            time.sleep(0.005)

    def shutdown(self, drain=True, timeout_s=600.0):
        """Stop the pool. drain=True serves everything admitted first;
        drain=False abandons unfinished work (`queue.abort`). Workers see
        `finished`, sign off through `bye` (their stats land in the
        ledger) and exit; stragglers are TERMed, then KILLed."""
        if self._shut:
            return
        self._shut = True
        try:
            if drain:
                self.drain(timeout_s=timeout_s)
            else:
                self.queue.abort()
            deadline = time.monotonic() + 10.0
            for h in self._handles.values():
                try:
                    h.proc.wait(max(0.0, deadline - time.monotonic()))
                except Exception:
                    pass
            for t in self._threads.values():
                t.join(max(0.0, deadline - time.monotonic()))
        finally:
            for h in self._handles.values():
                h.shutdown()
            if self._tp is not None:
                self._tp.close()
