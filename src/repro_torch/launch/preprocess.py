"""End-to-end entry point: preprocess a stream of synthetic bird-acoustic
long chunks through a two-phase-family plan, on the CUDA card by default.

  PYTHONPATH=src python -m repro_torch.launch.preprocess --minutes 8
  PYTHONPATH=src python -m repro_torch.launch.preprocess --plan async --depth 4
  PYTHONPATH=src python -m repro_torch.launch.preprocess --device cpu

Reports throughput in MB/s of source audio (the paper's headline metric)
and the chunks kept; plans with a pipeline window also report their
per-stage host times (dispatch / mask readback / compact / tail / emit) and
the overlapped dispatches. `--plan` choices come from the `PLANS` registry;
`--depth` is the async plan's dispatch-ahead window (default 4 here, as in
the reference's launcher) and `--bucket` the survivor-count quantization of
the tail (default: the plan's own, pow2 for async, linear elsewhere). The
batches are synthesised on the host as the loop asks for them, and that
time is inside the reported wall time.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import SERF_AUDIO
from repro_torch.core.plans import PLANS, Preprocessor
from repro_torch.data.loader import audio_batch_maker

_FRAC_KEYS = ("frac_rain", "frac_silence", "frac_kept", "frac_cicada15")
_STAGES = ("dispatch", "readback", "compact", "tail", "emit")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=4.0)
    ap.add_argument("--batch-long-chunks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default="two_phase", choices=sorted(PLANS))
    ap.add_argument("--depth", type=int, default=None,
                    help="detect dispatch-ahead window for --plan async "
                         "(default 4)")
    ap.add_argument("--bucket", choices=("pow2", "linear"), default=None,
                    help="survivor-count quantization of the tail (default: "
                         "the plan's own, pow2 for async, linear elsewhere)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    plan_kwargs = {}
    if args.plan == "async":
        plan_kwargs["depth"] = 4 if args.depth is None else args.depth
    elif args.depth is not None:
        ap.error(f"--depth is the async plan's dispatch-ahead window; "
                 f"plan '{args.plan}' has no use for it")
    if args.bucket is not None:
        plan_kwargs["bucket"] = args.bucket
    pre = Preprocessor(SERF_AUDIO, plan=args.plan, device=args.device,
                       **plan_kwargs)
    n_batches = max(1, int(round(args.minutes / args.batch_long_chunks)))
    make = audio_batch_maker(args.seed, args.batch_long_chunks)
    stream = ((wid, make(wid)) for wid in range(n_batches))

    tot_bytes = tot_kept = tot_chunks = 0
    agg = {k: 0.0 for k in _FRAC_KEYS}
    timings = []
    t0 = time.time()
    for res in pre.run(stream):
        w = float(res.det.stats["n_chunks5"])
        for k in _FRAC_KEYS:
            agg[k] += float(res.det.stats[k]) * w
        tot_bytes += res.src_bytes
        tot_kept += res.n_kept
        tot_chunks += int(w)
        timings.append(res.timings)
    if pre.device.type == "cuda":
        torch.cuda.synchronize(pre.device)
    dt = time.time() - t0
    frac = {k: agg[k] / tot_chunks for k in _FRAC_KEYS}
    where = (torch.cuda.get_device_name(pre.device)
             if pre.device.type == "cuda" else "cpu")
    print(f"plan={args.plan} device={where}  {tot_bytes / 2**20:.0f} MB "
          f"source audio in {dt:.1f}s  ->  {tot_bytes / 2**20 / dt:.2f} MB/s")
    print(f"chunks kept {tot_kept}/{tot_chunks} "
          f"(rain {frac['frac_rain']:.1%}, "
          f"silence {frac['frac_silence']:.1%}, "
          f"cicada-filtered {frac['frac_cicada15']:.1%})")
    if "in_flight" in timings[0]:
        n = len(timings)
        print("pipeline: " + "  ".join(
            f"{k} {1e3 * sum(t[k + '_s'] for t in timings) / n:.2f}ms"
            for k in _STAGES))
        print(f"pipeline: "
              f"{sum(1 for t in timings if t['in_flight'] >= 2)}/{n} "
              f"overlapped dispatches (max in-flight "
              f"{max(t['in_flight'] for t in timings)})")
    return tot_kept


if __name__ == "__main__":
    main()
