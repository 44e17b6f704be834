#!/usr/bin/env python3
"""Where a language-model decode step's time goes, on the card.

    python3 scripts/lm_profile.py [--arch llama3.2-3b] [--batch 4]
        [--prompt-len 128] [--steps 8] [--trace FILE]

Builds the arch (any of the ten, the recurrent zamba2-1.2b and xlstm-125m
included) at its published widths in bf16 with weights drawn from a seed,
prefills `--batch` random prompts of `--prompt-len` tokens and builds the
decode caches from the prefill's as the engine does (`decode_caches`),
then times one decode step (CUDA events, median of 10) and traces
`--steps` steps with `torch.profiler`: the device-busy share of the traced
window (kernel time over wall), the kernels launched a step, and the top
operators by host time and by device time. `--trace FILE` also writes the
Chrome trace. Prints the card's name and power limit first, then one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _device_us(e, self_only=False):
    """An averaged event's device time (the attribute's name moved between
    torch releases)."""
    name = "self_device_time_total" if self_only else "device_time_total"
    old = "self_cuda_time_total" if self_only else "cuda_time_total"
    return getattr(e, name, None) or getattr(e, old, 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trace", default=None, metavar="FILE")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import decode_caches

    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    model = build_model(cfg)
    B, S, n = args.batch, args.prompt_len, args.steps
    prompts = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    with torch.inference_mode():
        logits, pf = model.prefill({"tokens": prompts})
        caches = decode_caches(model, pf, S + n + 1)
        tok = logits[:, :cfg.vocab_size].argmax(-1)

        def step(i=0):
            return model.decode_step(caches, tok, S + i)[0]

        for _ in range(3):
            step()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    avg = prof.key_averages()
    kernels = [e for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e, self_only=True) for e in kernels)
    ops = [e for e in avg if e.device_type == torch.autograd.DeviceType.CPU]

    def top(key, rows):
        return [{"name": e.key[:80], "calls_per_step": e.count / n,
                 "ms_per_step": key(e) / n / 1e3}
                for e in sorted(rows, key=key, reverse=True)[:12]]

    rec = {"arch": args.arch, "dtype": cfg.dtype, "batch": B,
           "prompt_len": S, "decode_ms_per_step": statistics.median(times),
           "traced_steps": n, "traced_wall_ms_per_step": wall_us / n / 1e3,
           "device_busy_ms_per_step": busy_us / n / 1e3,
           "device_busy_share": busy_us / wall_us,
           "kernels_per_step": sum(e.count for e in kernels) / n,
           "top_host_ops": top(lambda e: e.self_cpu_time_total, ops),
           "top_device_kernels": top(lambda e: _device_us(e, True),
                                     kernels)}
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
