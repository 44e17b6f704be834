#!/usr/bin/env python3
"""Where a language-model training step's time goes, on the card.

    python3 scripts/train_profile.py [--arch llama3.2-3b] [--batch 4]
        [--seq 2048] [--steps 2] [--trace FILE]

Builds the arch at its published widths in its configured dtype (bf16)
with weights drawn from a seed and the optimizer state of
`train.train_step.init_train_state`, then runs `make_train_step`'s step on
`TokenLoader` batches, timed with CUDA events (median of 5 steps after 2
warm-up steps), and 5 more through the step's own two halves
(`train_step.compute_grads`: forward and backward; `train_step.update`:
global norm, clip and AdamW, leaf by leaf), each half timed. Then
`--steps` whole steps are traced with `torch.profiler`: the device-busy
share of the traced window
(kernel time over wall), the kernels launched a step, the top kernels by
device time, and the bytes a parameter the update's kernels move, counted
from its expressions. `--trace FILE` also writes the Chrome trace. Prints
the card's name and power limit first, then one JSON object. Unless
PYTORCH_CUDA_ALLOC_CONF is set, it runs with the allocator's expandable
segments: at B = 4, S = 2048 a step's 3.9 GiB f32 logits find no free
block otherwise, with 17 GiB cached and unused.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
# bytes a parameter the update's unfused kernels read and write, bf16
# parameters and gradients, f32 state (`train/optimizer.py`): global norm
# (cast 6, square 8, sum 4), clip (g * scale 4, cast 6), m (8, 8, 12),
# v (8, 8, 8, 12), bias corrections (8, 8), sqrt 8, + eps 8, divide 12,
# decay (8, 12), times lr 8, master minus 12, the cast into the bf16
# parameter 6
UPDATE_BYTES_PER_PARAM = 18 + 10 + 28 + 36 + 16 + 8 + 8 + 12 + 20 + 8 + 12 + 6


def _device_us(e):
    """An averaged event's self device time (the attribute's name moved
    between torch releases)."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0.0))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--trace", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    # read when CUDA starts, so before torch touches the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.loader import TokenLoader
    from repro_torch.distributed.sharding import NULL_RULES
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    opt_cfg = O.OptConfig(lr=3e-4, warmup_steps=1, decay_steps=100,
                          quantize_state=cfg.quantize_opt_state)
    state = init_train_state(model, opt_cfg)
    params = dict(model.named_parameters())
    n = args.steps
    batches = [b for _, b in TokenLoader(cfg.vocab_size, args.batch,
                                         args.seq, n_batches=12 + n)]

    step = make_train_step(model, NULL_RULES, opt_cfg)

    def timed(fn, batches):
        """CUDA events around each call of fn(batch): [[start, ...], ...]."""
        marks = []
        for b in batches:
            ev = [torch.cuda.Event(enable_timing=True)]
            ev[0].record()
            fn(b, ev)
            marks.append(ev)
        torch.cuda.synchronize()
        return marks

    def whole(batch, ev):
        nonlocal state
        state, _ = step(state, batch)
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()

    def halves(batch, ev):
        nonlocal state
        _, metrics, grads = step.compute_grads(batch)
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()
        state, _ = step.update(state, metrics, grads)
        del grads
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()

    timed(whole, batches[:2])
    step_ms = [a.elapsed_time(b) for a, b in timed(whole, batches[2:7])]
    marks = timed(halves, batches[7:12])
    fwd_bwd = [a.elapsed_time(b) for a, b, _ in marks]
    update = [b.elapsed_time(c) for _, b, c in marks]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[12:]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avg = prof.key_averages()
    kernels = [e for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    n_params = sum(p.numel() for p in params.values())
    update_ms = statistics.median(update)
    rec = {"arch": args.arch, "dtype": cfg.dtype, "params": n_params,
           "leaves": len(params), "batch": args.batch, "seq": args.seq,
           "step_ms": statistics.median(step_ms),
           "trained_tok_per_s": args.batch * args.seq
           / statistics.median(step_ms) * 1e3,
           "forward_backward_ms": statistics.median(fwd_bwd),
           "update_ms": update_ms,
           "update_bytes_per_param_counted": UPDATE_BYTES_PER_PARAM,
           "update_bytes_bound_ms": UPDATE_BYTES_PER_PARAM * n_params
           / HBM_BYTES_PER_S * 1e3,
           "update_achieved_bytes_per_s": UPDATE_BYTES_PER_PARAM * n_params
           / (update_ms / 1e3),
           "traced_steps": n, "traced_wall_ms_per_step": wall_us / n / 1e3,
           "device_busy_ms_per_step": busy_us / n / 1e3,
           "device_busy_share": busy_us / wall_us,
           "kernels_per_step": sum(e.count for e in kernels) / n,
           "top_device_kernels": [
               {"name": e.key[:80], "calls_per_step": e.count / n,
                "ms_per_step": _device_us(e) / n / 1e3}
               for e in sorted(kernels, key=_device_us, reverse=True)[:15]],
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "alloc_conf": os.environ["PYTORCH_CUDA_ALLOC_CONF"]}
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
