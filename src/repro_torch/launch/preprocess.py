"""End-to-end entry point: preprocess a stream of synthetic bird-acoustic
long chunks through any plan of `PLANS`, on the CUDA card by default.

  PYTHONPATH=src python -m repro_torch.launch.preprocess --minutes 8
  PYTHONPATH=src python -m repro_torch.launch.preprocess --plan async --depth 4
  PYTHONPATH=src python -m repro_torch.launch.preprocess --plan fused
  PYTHONPATH=src python -m repro_torch.launch.preprocess --store /tmp/st
  PYTHONPATH=src python -m repro_torch.launch.preprocess --plan sharded --shards 4
  PYTHONPATH=src python -m repro_torch.launch.preprocess --plan sharded --transport proc --shards 2 --lease-items 2
  PYTHONPATH=src python -m repro_torch.launch.preprocess --device cpu

Reports throughput in MB/s of source audio (the paper's headline metric),
the chunks kept and the survivor load imbalance over the card count;
plans with a pipeline window also report their per-stage host times
(dispatch / mask readback / compact / tail / emit) and the overlapped
dispatches. `--depth` is the async plan's dispatch-ahead window (default
4 here, as in the reference's launcher) and `--bucket` the survivor-count
quantization of the tail (default: the plan's own, pow2 for async, linear
elsewhere). `--store DIR` wraps the chosen plan in `CachedPlan` with a
content-addressed store and a run journal in DIR: a second run over the
same stream is all hits; `--resume` continues a killed `--store` run from
its journal, each batch emitted once across the kill; `--store-max-bytes`
evicts the least recently hit entries after the run. `--plan sharded`
runs the master/worker runtime over `--shards` shards: `--transport inproc`
simulates them in this process, `proc` spawns real worker processes
(`python -m repro_torch.dist.worker`, on this run's device) that lease
`--lease-items` work ids per round-trip (the paper's Table 7
`max_queue_size` knob), `tcp` binds the master non-loopback;
`--data-plane-store DIR` moves chunk and result bytes off the master's
socket into a shared store, `--no-speculate` turns off the speculative
re-lease of stragglers. It adds the queue's redeliveries, the last
survivor re-shard and one summary line per worker. The batches are
synthesised on the host as the loop asks for them (by the master, for
the sharded plan), and that time is inside the reported wall time.

`--telemetry DIR` writes one durable JSONL record per batch (the sharded
plan's QueueService writes them on the master at acceptance, so that a
killed worker cannot lose them; the other plans here, as each result is
emitted); `--trace FILE` writes a Chrome trace of the run, worker
processes' spans parented under the master's run span. Either adds one
`metrics:` line per non-zero series of the metrics registry. `--mode` is
another name for `--plan`, as in the reference.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import SERF_AUDIO
from repro_torch.core.plans import PLANS, Preprocessor, ShardedPlan, SizedIter
from repro_torch.core.scheduler import balance_stats
from repro_torch.data.loader import audio_batch_maker, audio_shard_pool
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs import tracing as obs_tracing

_FRAC_KEYS = ("frac_rain", "frac_silence", "frac_kept", "frac_cicada15")
_STAGES = ("dispatch", "readback", "compact", "tail", "emit")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=4.0)
    ap.add_argument("--batch-long-chunks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", "--mode", dest="plan", default="two_phase",
                    choices=sorted(PLANS))
    ap.add_argument("--shards", type=int, default=2,
                    help="shard / worker count for --plan sharded")
    ap.add_argument("--transport", choices=("inproc", "proc", "tcp"),
                    default="inproc",
                    help="sharded worker runtime: 'inproc' simulates every "
                         "shard in this process; 'proc' runs real worker "
                         "processes over an authenticated localhost "
                         "socket; 'tcp' binds non-loopback so that workers "
                         "can join from other hosts (pair with "
                         "--data-plane-store)")
    ap.add_argument("--lease-items", type=int, default=1,
                    help="work ids per queue round-trip (the paper's "
                         "Table 7 max_queue_size knob) for --plan sharded")
    ap.add_argument("--data-plane-store", default=None, metavar="DIR",
                    help="move the sharded plan's data plane off the "
                         "master's socket: chunk and result bytes through "
                         "a shared ChunkStore at DIR (proc/tcp transports)")
    ap.add_argument("--no-speculate", action="store_true",
                    help="disable speculative re-lease of end-of-stream "
                         "stragglers (sharded plan; on by default for "
                         "worker processes)")
    ap.add_argument("--depth", type=int, default=None,
                    help="detect dispatch-ahead window for --plan async "
                         "(default 4)")
    ap.add_argument("--bucket", choices=("pow2", "linear"), default=None,
                    help="survivor-count quantization of the tail (default: "
                         "the plan's own, pow2 for async, linear elsewhere)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="content-addressed result store: wraps the chosen "
                         "plan in CachedPlan + a resume journal")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed --store run from its journal "
                         "(exactly-once emission across the restart)")
    ap.add_argument("--store-max-bytes", type=int, default=None,
                    help="after the run, evict least-recently-hit store "
                         "entries until the payload fits this budget")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="write one durable JSONL telemetry record per "
                         "batch into DIR (sharded plan: on the master, at "
                         "acceptance, so that killed workers lose none)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="write a Chrome trace-event JSON of the run (load "
                         "in Perfetto); worker processes ship their spans "
                         "back at sign-off")
    args = ap.parse_args(argv)
    if args.resume and not args.store:
        ap.error("--resume requires --store")
    if args.store_max_bytes is not None and not args.store:
        ap.error("--store-max-bytes requires --store")

    sharded = args.plan == "sharded"
    if not sharded:
        if args.transport != "inproc":
            ap.error("--transport picks the sharded plan's worker "
                     f"runtime; plan '{args.plan}' has no workers")
        if args.lease_items != 1:
            ap.error("--lease-items batches the sharded plan's queue "
                     f"pulls; plan '{args.plan}' has no lease loop")
        if args.no_speculate:
            ap.error("--no-speculate disables the sharded plan's "
                     f"speculative re-lease; plan '{args.plan}' has none")
        if args.data_plane_store:
            ap.error("--data-plane-store moves the sharded plan's worker "
                     f"data plane; plan '{args.plan}' has no workers")
    if args.data_plane_store and args.transport == "inproc":
        ap.error("--data-plane-store rides the proc/tcp worker runtime "
                 "(the in-process loop never serialises chunks)")
    plan_kwargs = {"shards": args.shards, "transport": args.transport,
                   "lease_items": args.lease_items,
                   "data_plane": args.data_plane_store,
                   # None: the plan's default (on for worker processes)
                   "speculate": False if args.no_speculate else None} \
        if sharded else {}
    if args.plan == "async":
        plan_kwargs["depth"] = 4 if args.depth is None else args.depth
    elif args.depth is not None:
        ap.error(f"--depth is the async plan's dispatch-ahead window; "
                 f"plan '{args.plan}' has no use for it")
    if args.bucket is not None:
        if args.plan not in ("two_phase", "streaming", "async", "cached"):
            # sharded pads through its Rebalancer; fused has no tail
            ap.error(f"--bucket selects the tail-shape quantization of "
                     f"the single-stream two-phase-family plans; plan "
                     f"'{args.plan}' does not take it")
        plan_kwargs["bucket"] = args.bucket
    plan = args.plan
    if args.store:
        inner = "two_phase" if plan == "cached" else plan
        plan, plan_kwargs = "cached", {
            "inner": inner, "store": args.store, "journal": True,
            "resume": args.resume, **plan_kwargs}
    telem = (obs_telemetry.TelemetryWriter(args.telemetry)
             if args.telemetry else None)
    tracer = None
    if args.trace:
        tracer = obs_tracing.Tracer()
        obs_tracing.set_tracer(tracer)
        tracer.start_run("preprocess_run")
    if telem is not None and plan == "sharded":
        plan_kwargs["telemetry"] = telem
    pre = Preprocessor(SERF_AUDIO, plan=plan, device=args.device,
                       **plan_kwargs)
    n_batches = max(1, int(round(args.minutes / args.batch_long_chunks)))
    make = audio_batch_maker(args.seed, args.batch_long_chunks)
    if sharded and not args.store:
        # per-shard loaders over one shared leased queue, leased as long
        # as the plan leases a plain stream over this transport
        stream = audio_shard_pool(
            seed=args.seed, n_batches=n_batches, n_shards=args.shards,
            batch_long_chunks=args.batch_long_chunks,
            lease_items=args.lease_items,
            lease_timeout_s=ShardedPlan.default_lease_timeout(
                args.transport))
    else:
        stream = SizedIter(((wid, make(wid)) for wid in range(n_batches)),
                           n_batches)

    tot_bytes = tot_kept = tot_chunks = 0
    agg = {k: 0.0 for k in _FRAC_KEYS}
    last_keep = None
    timings = []
    t0 = time.time()
    for i, res in enumerate(pre.run(stream)):
        w = float(res.det.stats["n_chunks5"])
        for k in _FRAC_KEYS:
            agg[k] += float(res.det.stats[k]) * w
        tot_bytes += res.src_bytes
        tot_kept += res.n_kept
        tot_chunks += int(w)
        last_keep = res.det.keep
        if res.timings is not None:
            timings.append(res.timings)
        if telem is not None and plan != "sharded":
            # a single-process plan's acceptance point is this loop
            obs_telemetry.record_result(
                telem, res.wid if res.wid is not None else i, res)
    if pre.device.type == "cuda":
        torch.cuda.synchronize(pre.device)
    dt = time.time() - t0
    if tracer is not None:
        tracer.finish_run()
        tracer.save(args.trace)
        print(f"trace: {len(tracer.events)} events -> {args.trace}")
    if telem is not None:
        telem.close()
        print(f"telemetry: {telem.records_written} records -> "
              f"{args.telemetry}")
    if args.trace or args.telemetry:
        for line in obs_metrics.summary_lines():
            print("metrics:", line)
    cached = pre.plan if plan == "cached" else None
    if tot_chunks == 0:
        print("nothing left to emit: the journal shows every chunk of this "
              "stream was already emitted before the kill")
        return 0
    frac = {k: agg[k] / tot_chunks for k in _FRAC_KEYS}
    where = (torch.cuda.get_device_name(pre.device)
             if pre.device.type == "cuda" else "cpu")
    print(f"plan={args.plan} device={where}  {tot_bytes / 2**20:.0f} MB "
          f"source audio in {dt:.1f}s  ->  {tot_bytes / 2**20 / dt:.2f} MB/s")
    print(f"chunks kept {tot_kept}/{tot_chunks} "
          f"(rain {frac['frac_rain']:.1%}, "
          f"silence {frac['frac_silence']:.1%}, "
          f"cicada-filtered {frac['frac_cicada15']:.1%})")
    n_cards = torch.cuda.device_count() if pre.device.type == "cuda" else 1
    bs = balance_stats(last_keep, n_cards)
    print(f"survivor load imbalance (max/mean): "
          f"{float(bs['imbalance']):.3f} -> "
          f"{float(bs['imbalance_after_compact']):.3f} after compaction")
    exec_plan = cached.inner if cached is not None else pre.plan
    if exec_plan.name == "sharded":
        asg = exec_plan.last_assignment
        dp = " data_plane=store" if args.data_plane_store else ""
        print(f"shards={args.shards} transport={args.transport}{dp} "
              f"lease_items={args.lease_items} "
              f"redeliveries={exec_plan.redeliveries} "
              f"speculations={exec_plan.speculations} "
              f"(lost races {exec_plan.speculations_lost})")
        if asg is not None:
            st = asg.stats()
            print(f"last-round survivor re-shard: "
                  f"{st['loads_before'].tolist()} -> "
                  f"{st['loads_after'].tolist()} "
                  f"(max/min {st['max_min_before']:.2f} -> "
                  f"{st['max_min_after']:.2f}, moved {st['moved']})")
        for line in worker_summary(exec_plan.worker_stats):
            print(line)
    if timings and "in_flight" in timings[0]:
        n = len(timings)
        print("pipeline: " + "  ".join(
            f"{k} {1e3 * sum(t[k + '_s'] for t in timings) / n:.2f}ms"
            for k in _STAGES))
        print(f"pipeline: "
              f"{sum(1 for t in timings if t['in_flight'] >= 2)}/{n} "
              f"overlapped dispatches (max in-flight "
              f"{max(t['in_flight'] for t in timings)})")
    if cached is not None and cached.stats is not None:
        print(f"store: {cached.stats}")
    if args.store_max_bytes is not None:
        rep = cached.store.gc(args.store_max_bytes)
        print(f"store gc: {rep['evicted']} entries / "
              f"{rep['bytes_freed'] / 2**20:.1f} MB evicted -> "
              f"{rep['entries_after']} entries / "
              f"{rep['bytes_after'] / 2**20:.1f} MB retained")
    return tot_kept


def worker_summary(worker_stats):
    """Per-worker lines of the sharded plan's end-of-run summary: queue
    round-trips against work ids granted, chunks finished, leases still
    held, redeliveries charged to the worker, its membership state,
    heartbeat age, and (worker processes only) its idle/busy split."""
    lines = []
    for st in worker_stats or ():
        pid = f" pid={st.pid}" if st.pid else ""
        beat = ("never" if st.last_beat_age_s is None
                else f"{st.last_beat_age_s:.1f}s ago")
        split = (f"  idle {st.idle_s:.1f}s / busy {st.busy_s:.1f}s"
                 if (st.idle_s or st.busy_s) else "")
        lines.append(
            f"worker {st.worker}{pid} [{st.state}]: "
            f"{st.chunks_done} chunks done, "
            f"{st.leased_total} leased over {st.lease_calls} round-trips "
            f"({st.leases_held} still held), "
            f"{st.redeliveries} redelivered, last beat {beat}{split}")
    return lines


if __name__ == "__main__":
    main()
