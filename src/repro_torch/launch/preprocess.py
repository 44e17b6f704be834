"""End-to-end entry point: preprocess a stream of synthetic bird-acoustic
long chunks through the two-phase pipeline, on the CUDA card by default.

  PYTHONPATH=src python -m repro_torch.launch.preprocess --minutes 8
  PYTHONPATH=src python -m repro_torch.launch.preprocess --device cpu

Reports throughput in MB/s of source audio (the paper's headline metric)
and the chunks kept. The batches are synthesised on the host as the loop
asks for them, and that time is inside the reported wall time.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import SERF_AUDIO
from repro_torch.core.plans import Preprocessor
from repro_torch.data.loader import audio_batch_maker

_FRAC_KEYS = ("frac_rain", "frac_silence", "frac_kept", "frac_cicada15")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=4.0)
    ap.add_argument("--batch-long-chunks", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    pre = Preprocessor(SERF_AUDIO, plan="two_phase", device=args.device)
    n_batches = max(1, int(round(args.minutes / args.batch_long_chunks)))
    make = audio_batch_maker(args.seed, args.batch_long_chunks)
    stream = ((wid, make(wid)) for wid in range(n_batches))

    tot_bytes = tot_kept = tot_chunks = 0
    agg = {k: 0.0 for k in _FRAC_KEYS}
    t0 = time.time()
    for res in pre.run(stream):
        w = float(res.det.stats["n_chunks5"])
        for k in _FRAC_KEYS:
            agg[k] += float(res.det.stats[k]) * w
        tot_bytes += res.src_bytes
        tot_kept += res.n_kept
        tot_chunks += int(w)
    if pre.device.type == "cuda":
        torch.cuda.synchronize(pre.device)
    dt = time.time() - t0
    frac = {k: agg[k] / tot_chunks for k in _FRAC_KEYS}
    where = (torch.cuda.get_device_name(pre.device)
             if pre.device.type == "cuda" else "cpu")
    print(f"plan=two_phase device={where}  {tot_bytes / 2**20:.0f} MB "
          f"source audio in {dt:.1f}s  ->  {tot_bytes / 2**20 / dt:.2f} MB/s")
    print(f"chunks kept {tot_kept}/{tot_chunks} "
          f"(rain {frac['frac_rain']:.1%}, "
          f"silence {frac['frac_silence']:.1%}, "
          f"cicada-filtered {frac['frac_cicada15']:.1%})")
    return tot_kept


if __name__ == "__main__":
    main()
