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

from perfbench import check, traffic as T
from perfbench.reference import serf as reference
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
        {"config": config, "traffic": traffic,
         "deployment": config["deployment"]}[part].update(changes)
    pipeline = config["pipeline"]

    phases = {"imports": time.monotonic() - t_start}
    items = T.make_items(traffic, seed, device)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    phases["inputs"] = time.monotonic() - t_start
    drv = runner
    try:
        if drv is None:
            drv = bench.runner(config["runner"]).Runner(config, device,
                                                        torch)
        phases["program"] = time.monotonic() - t_start
        drv.warm(items, traffic, seed)
        setup_s = time.monotonic() - t_start
        record = drv.window(items, traffic, seed, seconds, trace=bool(trace))
        peak = drv.memory_peak()
    finally:
        if runner is None and drv is not None:
            drv.close()
    record["setup_s"] = setup_s

    # the check: the reference on the compared items, once the program is
    # gone
    tally = check.Tally()
    refs = {}
    for k, arr in record["compared"]:
        if k not in refs:
            refs[k] = reference.run(items[k], pipeline, "f32",
                                    device=device)
        tally.add(arr, refs[k])
    numbers = tally.numbers(record["repeat_mismatch"])
    correct, table = check.judge(numbers, config["limits"])
    record.pop("compared")

    info = {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
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
    if trace and record.get("trace") is not None:
        info["busy_s"] = record["trace"].busy_s()
        info["window_s"] = record["trace"].window_s
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
        "warm_batch_s": record.get("warm_batch_s")}
    result["check"] = table
    return result


def print_result(result):
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
