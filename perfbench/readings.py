"""The readings a cell's limits are set from, on the card, in one process:

  program   the cell's own run (`harness.run_cell`, a short window) on each
            seed: the numbers its check compares
  control   the reference at the control's precision (the runner's
            `CONTROL`; the archive's: TF32, the step below the
            configuration's float32) put in the program's place, on every
            pool item, judged against the reference at the runner's
            `PRECISION`

    python3 perfbench/readings.py --workload serf_archive.chorus \
        --seeds 101,102,103 --control-seeds 101,102,103 --seconds 3

One JSON line a reading, then a summary line: the largest program reading
and the smallest control reading of each number.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(bench, workload, seed, device):
    """The control's numbers and coverage on one seed, through the cell's
    runner module (its inputs, reference and tally)."""
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    mod = bench.runner(config["runner"])
    items = mod.make_items(traffic, seed, device)
    tally = mod.Tally()
    for item in items:
        want = mod.reference(item, config, mod.PRECISION, device)
        got = mod.reference(item, config, mod.CONTROL, device)
        tally.add(got, want)
    return tally.numbers(), tally.coverage()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    harness.cache_env(str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    prog, ctrl = [], []
    # one program for every seed: set-up is most of a run
    config = bench.config(bench.cell(args.workload)["config"])
    mod = bench.runner(config["runner"])
    drv = mod.Runner(config, "cuda", torch)
    try:
        for s in seeds:
            r = harness.run_cell(args.workload, s, args.seconds, 0,
                                 time.monotonic(), runner=drv)
            nums = {k: v["value"] for k, v in r["check"].items()}
            prog.append(nums)
            print(json.dumps({"program": s, "numbers": nums,
                              "coverage": r["diagnostics"]["coverage"],
                              "correct": r["correct"]}), flush=True)
    finally:
        drv.close()
    for s in [int(s) for s in args.control_seeds.split(",") if s]:
        nums, cov = control_numbers(bench, args.workload, s, "cuda")
        ctrl.append(nums)
        print(json.dumps({f"control_{mod.CONTROL}": s, "numbers": nums,
                          "coverage": cov}), flush=True)
    summary = {}
    for k in mod.NUMBERS:
        summary[k] = {
            "program_max": max((p[k] for p in prog), default=None),
            "control_min": min((c[k] for c in ctrl), default=None)}
    print(json.dumps({"summary": summary, "workload": args.workload}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
