#!/usr/bin/env python3
"""llama3.2-3b's loss at init against depth, on the card and the CPU.

    python3 scripts/init_loss_depth.py [--layers 2 4 8 16 28]
        [--seeds 0 1 2] [--cpu-layers 28] [--batch 4] [--seq 128]

For each depth and seed, the arch at its published widths cut to that
many layers gets its bf16 weights drawn on the card as `launch.train`
draws them (`build_model`, a CUDA generator seeded `seed`), and its loss,
forward only, on the first `TokenLoader` batch (seed 0) is read three
ways: in bf16 on the card, in f32 on the card (the same weights cast), and
for seed 0 at `--cpu-layers` in f32 on the CPU (the same weights, the
plain PyTorch path the CPU tests hold against the reference). Seed 0 at 28
layers is the full-width run's first step in `chip_smoke.py` (B = 4, S =
128). Prints the card's name and power limit, one line a model, then one
JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8, 16,
                                                              28])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--cpu-layers", type=int, nargs="*", default=[28])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.loader import TokenLoader
    from repro_torch.distributed.sharding import NULL_RULES
    from repro_torch.models.zoo import build_model

    if not torch.cuda.is_available():
        print("init_loss_depth: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    base = ARCHS["llama3.2-3b"]
    _, batch = next(iter(TokenLoader(base.vocab_size, args.batch, args.seq,
                                     n_batches=1)))

    def loss(model):
        with torch.no_grad():
            return float(model.loss_fn(batch, NULL_RULES)[0])

    out = {}
    for n in args.layers:
        cfg = dataclasses.replace(base, num_layers=n)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        for seed in args.seeds:
            bf16 = build_model(cfg, generator=torch.Generator(
                "cuda").manual_seed(seed))
            rec = {"bfloat16": loss(bf16)}
            f32 = build_model(cfg32)
            f32.load_state_dict(bf16.state_dict())
            del bf16
            rec["float32"] = loss(f32)
            if seed == 0 and n in args.cpu_layers:
                cpu = build_model(cfg32, device="cpu")
                cpu.load_state_dict(f32.state_dict())
                rec["float32_cpu"] = loss(cpu)
                del cpu
            del f32
            torch.cuda.empty_cache()
            out.setdefault(n, {})[seed] = rec
            print(f"{n} layers, seed {seed}: {rec}", flush=True)
    print(json.dumps({"arch": base.name, "batch": args.batch,
                      "seq": args.seq, "ln_vocab": math.log(base.vocab_size),
                      "layers": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
