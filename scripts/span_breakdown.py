#!/usr/bin/env python3
"""Where an archive cell's device idle time falls among the program's
spans, on the card.

    python3 scripts/span_breakdown.py [--workload serf_archive.chorus]
        [--seed N] [--seconds 12] [--cost-seconds 0]

Sets the cell up as `perfbench/run.py` does (its runner, its traffic, one
warm-up pass), records one traced window of `--seconds` and prints, a
traced batch: each `obs/` span's host ms, and the device's idle ms by the
innermost `obs/` span over each gap's middle ("(no obs span)": the
caller's loop) and, within that, by the innermost host operation there
(what `perfbench/trace.py`'s breakdown names on its own). Gaps are those
of `idle_in_plan_ms.archive`. With `--cost-seconds S` it then runs
untraced windows of S seconds with nothing recording, a `Tracer` installed
and a profiler recording, in turns (off, tracer, profiler, profiler,
tracer, off), and gives each window's MB/s: the spans' cost. Prints the
card's name and power limit first, then one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COST_MODES = ("off", "tracer", "profiler", "profiler", "tracer", "off")


def innermost(intervals, points):
    """For each point (sorted), the innermost of `intervals` covering it,
    or None: a sweep with a stack, exact where the intervals nest (one
    thread's host operations and spans do)."""
    ivs = sorted(intervals, key=lambda i: (i.start, -i.end))
    out, stack, j = [], [], 0
    for p in points:
        while j < len(ivs) and ivs[j].start <= p:
            while stack and stack[-1].end < ivs[j].start:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1].end < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def analyse(run):
    """The breakdown of one traced `harness.Run`, ms a traced batch."""
    from perfbench.spec import HERE, load_module
    gaps_of = load_module(HERE / "metrics" / "idle_in_plan_ms.archive.py",
                          "perfbench_idle_in_plan")._gaps
    tr = run.trace
    n = sum(1 for b in run.record["batches"] if b.get("facts"))
    obs = [iv for iv in tr.host if iv.name.startswith("obs/")]
    span_ms = {}
    for iv in obs:
        span_ms[iv.name] = span_ms.get(iv.name, 0.0) + iv.end - iv.start
    gaps = gaps_of(tr)
    mids = [(s + e) / 2 for s, e in gaps]
    by_span, by_op = {}, {}
    for (s, e), o, h in zip(gaps, innermost(obs, mids),
                            innermost(tr.host, mids)):
        span = o.name if o is not None else "(no obs span)"
        op = h.name if h is not None else "(no host op)"
        by_span[span] = by_span.get(span, 0.0) + e - s
        key = f"{span} | {op[:80]}"
        by_op[key] = by_op.get(key, 0.0) + e - s

    def per_batch(d, top=None):
        items = sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {k: 1e3 * v / n for k, v in items}

    return {"traced_batches": n, "window_s": tr.window_s,
            "busy_s": tr.busy_s(),
            "idle_ms": 1e3 * sum(e - s for s, e in gaps) / n,
            "span_ms": per_batch(span_ms),
            "idle_ms_by_span": per_batch(by_span),
            "idle_ms_by_span_and_op": per_batch(by_op, 40),
            "obs_in_device": sorted({iv.name for iv in tr.device
                                     if iv.name.startswith("obs/")
                                     or "user_annotation" in iv.name})}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="serf_archive.chorus")
    ap.add_argument("--seed", type=int, default=2_913_000_005)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness, traffic as T
    from perfbench.spec import Bench
    from perfbench.trace import Profiler, smi_query
    harness.cache_env(str(ROOT))
    import torch
    from repro_torch.obs import tracing as obs_tracing

    print(smi_query("name,power.limit"), torch.__version__, flush=True)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    if args.device == "cpu":                # a rehearsal at a small size
        traffic.update(pool_items=1, long_chunks_per_item=1)
    items = T.make_items(traffic, args.seed, args.device)
    drv = bench.runner(config["runner"]).Runner(config, args.device, torch)
    try:
        drv.warm(items, traffic, args.seed)
        rec = drv.window(items, traffic, args.seed, args.seconds, trace=True)
        rec.pop("compared")
        out = {"workload": args.workload, "seed": args.seed,
               **analyse(harness.Run(rec, bench, args.workload, config,
                                     traffic))}
        cost = []
        for mode in COST_MODES if args.cost_seconds else ():
            prof = Profiler(torch) if mode == "profiler" else None
            obs_tracing.set_tracer(obs_tracing.Tracer()
                                   if mode == "tracer" else None)
            if prof is not None:
                prof.start()
            try:
                r = drv.window(items, traffic, args.seed, args.cost_seconds)
            finally:
                if prof is not None:
                    prof.stop()
                obs_tracing.set_tracer(None)
            cost.append([mode, sum(b["src_bytes"] for b in r["batches"])
                         / r["window_s"] / 1e6])
        out["cost_audio_mb_s"] = cost
    finally:
        drv.close()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
