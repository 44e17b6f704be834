"""The worker runtime: one shard of the paper's slave loop, as a real
process (the port's copy of the reference's `dist/worker.py`).

  python -m repro_torch.dist.worker --master HOST:PORT --lease-items N

The worker announces itself, with no shard id on the command line:
`hello` returns its assigned identity with the setup blob (the port's
config, stage names, pad_multiple, tail bucket and the device type to run
on, "cuda" or "cpu"). It builds its own `PipelineGraph` and `TwoPhasePlan`
on that device, or fails: a worker told "cuda" on a machine without a card
raises and exits, it never runs the plain versions in its place. Then it
loops:

  lease      up to `lease_items` work ids in one round-trip (the paper's
             Table 7 `max_queue_size` knob). With the store data plane
             (the blob carries "data_plane") the grant arrives as (wid,
             content key) pairs via `lease_chunks`, and the fetch below
             leaves the master's socket
  fetch      the host chunk batches of the whole lease in one round-trip,
             or, on the store plane, read by key from the shared ChunkStore
  compute    detection -> keep-mask readback -> survivor tail on the
             device: the `two_phase` path, so the output bytes equal a
             `two_phase` run's on the same device
  push       one numpy payload per item (`pack_result`), each push a
             heartbeat; the master completes the work id, so a worker
             killed after its push still resolves exactly once. Store
             plane: the payload goes to the shared store under the result
             key paired with the lease's raw key, the push carries the key

A SIGKILL anywhere in that loop leaves leases registered and not
completed: recovery is the queue's lease expiry or the master's
`fail_worker`. At the end `bye` reports the idle/busy split, the chunks
done, the kernel launches this worker made (`kernels.launches()`), which
the master's own counters cannot see, the bytes its allocator holds on
the card, and its card (`device.card_record`: the card's index in the
master's numbering, its name and its peak of allocated memory from the
plan's set-up on). `run_worker` is importable, so that
tests drive the loop in-process over an `InProcTransport`.

The measured part: the reply to the heartbeat before each item may name
the start or the end of a part of the run (`QueueService.mark`). Inside
it the worker records its card's device operations
(`obs.tracing.CardRecorder`) and the work ids it computed, and, where the
mark carries the master's tracer context and no tracer runs here, its
spans as below; `bye` carries the part under "part" ({"window_s", "busy",
"ops", "batches"}: `CardRecorder.result()` and [[wid, source bytes]]) and
the spans under "spans". A part still open when the loop ends closes
there.

Tracing: when the master runs a tracer, `hello` carries its trace id and
run-span parent. The worker records `lease`, `fetch_many` or
`fetch_store`, `compute` and `push` as complete events of its own tracer
(only for iterations that got work) and ships them in `bye`; a SIGKILLed
worker loses its spans, never the run. In a worker process that tracer is
also installed as the process's, so that the plan's own spans land in it;
an in-process worker shares the master's tracer, which already catches
them.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


class _Part:
    """The measured part the master names, as this worker follows it."""

    def __init__(self, device):
        self.device = device
        self.seq = 0            # the last mark acted on
        self.on = False
        self.recorder = None
        self.tracer = None      # the part's own tracer while it records
        self.batches = []
        self.report = None      # the last part's, once it ended
        self.spans = []

    def follow(self, reply):
        """Act on a heartbeat's reply: True, or a mark not yet seen."""
        if not isinstance(reply, dict) or reply["seq"] == self.seq:
            return
        self.seq = reply["seq"]
        self.end()
        if reply["on"]:
            self._begin(reply)

    def _begin(self, mark):
        from repro_torch.obs import tracing as obs_tracing
        self.on = True
        self.batches = []
        if mark.get("trace") and not obs_tracing.get_tracer().enabled:
            self.tracer = obs_tracing.Tracer(**mark["trace"])
            obs_tracing.set_tracer(self.tracer)
        self.recorder = obs_tracing.CardRecorder(self.device)
        self.recorder.start()

    def note(self, wid, src_bytes):
        """One item computed: counted where a part is open."""
        if self.on:
            self.batches.append([int(wid), int(src_bytes)])

    def end(self):
        if not self.on:
            return
        from repro_torch.obs import tracing as obs_tracing
        self.on = False
        self.recorder.stop()
        rep = self.recorder.result()
        self.recorder = None
        rep["batches"] = self.batches
        self.report = rep
        if self.tracer is not None:
            obs_tracing.set_tracer(None)
            self.spans.extend(self.tracer.drain())
            self.tracer = None


def run_worker(master, shard=None, lease_items=1, poll_s=0.05,
               transport=None, max_items=None):
    """Run one worker against a served QueueService and return the stats
    dict it also reports through `bye`. `master` is an address for the
    transport (HOST:PORT for proc; the service itself for in-proc).
    `shard=None` (the spawned default) announces to the registry and takes
    the identity `hello` assigns; an explicit shard asserts its own name
    (tests). `max_items` caps the items processed (tests); None runs until
    the queue is finished."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.graph import PipelineGraph
    from repro_torch.kernels import backend
    from repro_torch.core.plans import TwoPhasePlan
    from repro_torch.device import card_record
    from repro_torch.dist.service import pack_result
    from repro_torch.dist.transport import ProcTransport
    from repro_torch.obs import tracing as obs_tracing

    if transport is None:
        transport = ProcTransport()
    proxy = transport.connect(master)
    if shard is None:
        spec = proxy.call("hello", None, os.getpid(), -1)
        assigned = spec.get("assigned") or {}
        worker, shard = assigned.get("worker"), assigned.get("shard", -1)
        if worker is None:
            raise RuntimeError("master assigned no identity at hello")
    else:
        worker = f"shard{int(shard)}"
        spec = proxy.call("hello", worker, os.getpid(), int(shard))
    tracer = obs_tracing.NULL_TRACER
    if spec.get("trace"):
        tracer = obs_tracing.Tracer(**spec["trace"])
        if not obs_tracing.get_tracer().enabled:
            obs_tracing.set_tracer(tracer)
    if spec.get("backend_mode"):
        backend.set_mode(spec["backend_mode"])
    if spec.get("device") == "cuda" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()   # the card's peak from here
    graph = PipelineGraph(spec["cfg"], spec.get("stages"),
                          spec.get("source_channels", 2))
    # the blob's device or an error: resolve_device raises on "cuda"
    # without a card, and None means the card
    plan = TwoPhasePlan(graph, pad_multiple=spec.get("pad_multiple", 1),
                        bucket=spec.get("bucket", "linear"),
                        device=spec.get("device"))

    plane = None
    dp_spec = spec.get("data_plane") or {}
    if dp_spec.get("kind") == "store":
        from repro_torch.dist.data_plane import StoreDataPlane
        plane = StoreDataPlane(dp_spec["dir"])

    part = _Part(plan.device)
    launches0 = kernels.launches()
    lease_items = max(1, int(lease_items))
    idle = busy = 0.0
    done = 0
    while max_items is None or done < max_items:
        t0 = time.perf_counter()
        w0 = time.time()
        if plane is None:
            ids = proxy.call("lease", worker, lease_items)
            keys = {}
        else:
            pairs = proxy.call("lease_chunks", worker, lease_items)
            ids = [wid for wid, _ in pairs]
            keys = dict(pairs)
        if not ids:
            # leave on the queue-wide signal (finished) or this worker's
            # own (drain): at the top of the loop everything leased before
            # is pushed, so leaving now is the graceful exit drain promises
            if proxy.call("finished") or proxy.call("draining", worker):
                idle += time.perf_counter() - t0
                break
            part.follow(proxy.call("heartbeat", worker))
            idle += time.perf_counter() - t0
            time.sleep(poll_s)
            continue
        spans = part.tracer or tracer       # a marked part's, if open
        spans.complete("lease", w0, worker=worker, ids=ids)
        w1 = time.time()
        if plane is None:
            items = list(zip(ids, proxy.call("fetch_many", worker, ids)))
            spans.complete("fetch_many", w1, worker=worker, n=len(ids))
        else:
            items = [(wid, None if keys[wid] is None
                      else plane.fetch_chunks(keys[wid])) for wid in ids]
            spans.complete("fetch_store", w1, worker=worker, n=len(ids))
        idle += time.perf_counter() - t0
        for wid, chunks in items:
            if chunks is None:
                # this lease lost a redelivery race: the id completed
                # before the fetch, the master already has its result
                continue
            # a heartbeat per item bounds the lease-expiry exposure to one
            # item's compute time, not the whole lease batch's; its reply
            # may start or end a measured part, outside the item's clocks
            th = time.perf_counter()
            part.follow(proxy.call("heartbeat", worker))
            t1 = time.perf_counter()
            idle += t1 - th
            w2 = time.time()
            res = plan(np.asarray(chunks, np.float32))
            payload = pack_result(res)
            busy += time.perf_counter() - t1
            part.note(wid, res.src_bytes)
            spans = part.tracer or tracer
            spans.complete("compute", w2, worker=worker, wid=wid,
                           n_kept=int(res.n_kept))
            t2 = time.perf_counter()
            w3 = time.time()
            if plane is None:
                proxy.call("push_result", worker, wid, payload)
            else:
                proxy.call("push_result", worker, wid,
                           plane.push(keys[wid], payload))
            spans.complete("push", w3, worker=worker, wid=wid)
            idle += time.perf_counter() - t2
            done += 1
    part.end()
    now = kernels.launches()
    stats = {"idle_s": idle, "busy_s": busy, "chunks": done,
             "device": plan.device.type,
             "launches": {k: now[k] - launches0[k] for k in now},
             # what this process's allocator holds on the card: freed at
             # its exit, with its context
             "cuda_reserved_bytes": torch.cuda.memory_reserved(plan.device)
             if plan.device.type == "cuda" else 0,
             "card": card_record(plan.device, spec.get("cards", ()))}
    if part.report is not None:
        stats["part"] = part.report
    events = part.spans + (tracer.drain() if tracer.enabled else [])
    if events:
        stats["spans"] = events
    try:
        proxy.call("bye", worker, stats)
    finally:
        proxy.close()
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="worker process of the sharded plan's proc and tcp "
                    "transports (authkey through the environment variable "
                    "REPRO_DIST_AUTHKEY)")
    ap.add_argument("--master", required=True, metavar="HOST:PORT")
    ap.add_argument("--lease-items", type=int, default=1,
                    help="work ids per queue round-trip (the paper's "
                         "max_queue_size knob)")
    ap.add_argument("--poll-s", type=float, default=0.05,
                    help="sleep between empty lease polls")
    args = ap.parse_args(argv)
    run_worker(args.master, lease_items=args.lease_items,
               poll_s=args.poll_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
