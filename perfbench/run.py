"""Run one cell of the benchmark once on the card this process finds.

    python3 perfbench/run.py --workload serf_archive.chorus --seed 7 \
        --seconds 30 --trace 0

The cell, its configuration, its traffic and its metrics are named in
`BENCHMARK.json` and found under `perfbench/` (see `perfbench/spec.py`).
Prints the result as one JSON object on the last line of standard output
and the numbers `correct` was decided by, each beside its limit, as the
last lines of standard error. Exits 2, printing no result, without a CUDA
card, 3 when a module of JAX or of the JAX package was loaded, and 4 when
the cards the run used (the runner's `devices()`) are not the cell's:
another number than its "chips", cards of different names, or a card that
reports no work.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    harness.cache_env(str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    need = harness.Bench(ROOT).cell(args.workload)["chips"]
    if torch.cuda.device_count() < need:
        print(f"perfbench: {args.workload} needs {need} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the run may not hold: "
              f"{bad}", file=sys.stderr)
        return 3
    faults = harness.device_faults(result["diagnostics"]["cards"], need,
                                   args.trace)
    if faults:
        print(f"perfbench: the cards the run used: {'; '.join(faults)}",
              file=sys.stderr)
        return 4
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
