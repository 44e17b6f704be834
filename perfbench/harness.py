"""One run of one cell: set-up, the measured window, the check against
the reference, the metrics, and the result line.

`run_cell` is what `run.py` calls on the card; tests call it on the CPU
with smaller traffic (`overrides`), which is the only thing they change.
"""
from __future__ import annotations

import json
import os
import sys
import time

from perfbench import check
from perfbench.spec import ROOT, Bench

# what no module of the process that prints a result may hold once the
# window has closed, compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root):
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library loads JAX behind the program's back."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a metric's reader reads: the runner's record of the window and
    the cell's facts."""

    def __init__(self, record, bench, cell, config, traffic):
        self.record = record
        self.kind = record["kind"]
        self.window_s = record["window_s"]
        self.trace = record.get("trace")
        self.bench = bench
        self.cell = cell
        self.config = config
        self.traffic = traffic


def run_cell(workload, seed, seconds, trace, t_start, device="cuda",
             root=ROOT, overrides=None, runner=None):
    """The result dict of one run (the last line `run.py` prints).
    `runner`: a runner already set up for the cell, which the run then
    leaves open (the readings reuse one over many seeds)."""
    import torch

    bench = Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    for part, changes in (overrides or {}).items():
        (traffic if part == "traffic" else config if part == "config"
         else config[part]).update(changes)
    mod = bench.runner(config["runner"])

    phases = {"imports": time.monotonic() - t_start}
    items = mod.make_items(traffic, seed, device)
    phases["inputs"] = time.monotonic() - t_start
    drv = runner
    try:
        if drv is None:
            drv = mod.Runner(config, device, torch)
        phases["program"] = time.monotonic() - t_start
        drv.warm(items, traffic, seed)
        setup_s = time.monotonic() - t_start
        record = drv.window(items, traffic, seed, seconds, trace=bool(trace))
        cards = drv.devices()
    finally:
        if runner is None and drv is not None:
            drv.close()
    record["setup_s"] = setup_s

    # the check: the reference on the compared items, once the program is
    # gone
    tally = mod.Tally()
    refs = {}
    for k, arr in record["compared"]:
        if k not in refs:
            refs[k] = mod.reference(items[k], config, mod.PRECISION, device)
        tally.add(arr, refs[k])
    numbers = tally.numbers(record["repeat_mismatch"])
    correct, table = check.judge(numbers, config["limits"])
    record.pop("compared")

    info = device_block(cards, device, trace)
    from perfbench.trace import smi_query
    power = smi_query("power.limit")
    run = Run(record, bench, workload, config, traffic)
    metrics_spec = (bench.per_layer(workload) if trace
                    else bench.end_to_end(workload))
    metrics = {}
    for m in metrics_spec:
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": info}
    if trace and record.get("trace") is not None:
        tr = record["trace"]
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["diagnostics"] = {
        "power_limit_w": power, "coverage": tally.coverage(),
        "setup_phases_end_s": phases,
        "window_s": record["window_s"],
        "warm_batch_s": record.get("warm_batch_s"),
        "cards": cards}
    result["check"] = table
    return result


def device_block(cards, device, trace):
    """The result's `device` from the runner's records of the cards that
    did work in the window: their number, their common name, the fullest
    card's peak and, traced, the mean card's busy seconds and window,
    written only where every card was traced."""
    names = sorted({c["name"] for c in cards})
    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": " / ".join(names), "count": len(cards),
            "memory_peak_bytes": max((int(c["memory_peak_bytes"])
                                      for c in cards), default=0)}
    if trace and cards and all("busy_s" in c for c in cards):
        info["busy_s"] = sum(c["busy_s"] for c in cards) / len(cards)
        info["window_s"] = sum(c["window_s"] for c in cards) / len(cards)
    return info


def device_faults(cards, chips, trace):
    """Why a run on cards may not print a result, from the runner's
    records: another number of cards than the cell asks for, cards of
    different names, or a card that reports no work (no memory allocated,
    or, traced, no device time)."""
    faults = []
    if len(cards) != chips:
        faults.append(f"{len(cards)} card(s) did work, the cell asks for "
                      f"{chips}")
    names = sorted({c["name"] for c in cards})
    if len(names) > 1:
        faults.append(f"cards of different kinds: {names}")
    for c in cards:
        if c["memory_peak_bytes"] <= 0:
            faults.append(f"card {c['index']} allocated no memory")
        if trace and not c.get("busy_s", 0) > 0:
            faults.append(f"card {c['index']} shows no device time in the "
                          f"traced window")
    return faults


def print_result(result):
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
