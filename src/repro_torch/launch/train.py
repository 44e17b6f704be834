"""Training launcher, on the CUDA card by default (the port's copy of the
reference's `launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
Resume after an interruption (the fault-tolerance path):
  ... --resume
On a machine without a card:
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

It builds the arch (`--reduced`: the family-preserving small config), draws
its parameters from `--seed`, and trains on `TokenLoader`'s synthetic Zipf
corpus with the hand-rolled AdamW (`train.optimizer`; 8-bit state where the
config asks for it), printing one line per logged step: loss, grad norm,
learning rate and trained tokens a second. `--ckpt-dir` saves the
parameters (by name), the optimizer state and the loader's cursor every
`--ckpt-every` steps (asynchronously) and at the end, keeping the last 3;
`--resume` restores the latest and goes on from its step and batch.

As the reference's, it builds `make_local_mesh(--model-parallel)` over the
ranks of the process group and `ShardingRules(mesh, cfg.sharding_mode)`.
Alone, the process is a one-rank group of its own; under torchrun-style
ranks (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT` in the
environment) or in a group the caller started, the mesh spans every rank
and `--model-parallel N` shards the model N ways: the parameters and the
optimizer state are DTensors placed by the rules, each rank draws the same
batch and keeps its rows, checkpoints are gathered and written by rank 0,
and a resume re-shards them onto this run's mesh. On a mesh of one device
the state stays plain tensors (`--distribute` makes it DTensors there too).
Rank 0 alone prints. `--device cpu` runs the plain PyTorch versions;
without a card and without it, the launcher fails.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data.loader import TokenLoader
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (ShardingRules, is_dtensor,
                                              tree_shardings)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          train_state_specs)


def _stamp(device):
    """Now, on the clock that times a step: a recorded CUDA event on the
    card (the device's timeline, no synchronisation), the host's clock on
    the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _elapsed_ms(a, b):
    if isinstance(a, float):
        return (b - a) * 1e3
    return a.elapsed_time(b)


def main(argv=None):
    """Train; returns {"step": the last step, "model", "opt_state",
    "losses": each step's loss, "step_ms": each step's time (CUDA events
    on the card)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; fails without a card) or cpu")
    ap.add_argument("--distribute", action="store_true",
                    help="DTensor state even on a one-device mesh")
    args = ap.parse_args(argv)

    own_group = not dist.is_initialized()
    if own_group and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # torchrun-style ranks: the group comes from the environment
        cuda = args.device != "cpu" and torch.cuda.is_available()
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if cuda else "gloo")
    try:
        return _train(args)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args):
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=device)
    mesh = make_local_mesh(args.model_parallel, device)
    rules = ShardingRules(mesh, cfg.sharding_mode)
    lead = dist.get_rank() == 0
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                        decay_steps=args.steps,
                        quantize_state=cfg.quantize_opt_state)
    # None: DTensor state over more than one device only
    opt_state = init_train_state(
        model, opt_cfg, torch.Generator(device).manual_seed(args.seed),
        compress_grads=args.compress_grads, rules=rules,
        distribute=args.distribute or None)
    params = dict(model.named_parameters())
    shardings = None
    if any(is_dtensor(p) for p in params.values()):
        pspecs, ospecs = train_state_specs(model, opt_cfg,
                                           args.compress_grads)
        shardings = (tree_shardings(rules, pspecs),
                     tree_shardings(rules, ospecs))

    start_step = 0
    loader_start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            (saved, opt_state), meta = ckpt.restore(
                args.ckpt_dir, last, like=(params, opt_state),
                shardings=shardings)
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(saved[name])
            start_step = meta["step"]
            loader_start = meta["cursor_done"]
            if lead:
                print(f"resumed from step {start_step}")

    step_fn = make_train_step(model, rules, opt_cfg, args.microbatches,
                              args.compress_grads)
    loader = TokenLoader(cfg.vocab_size, args.batch, args.seq,
                         n_batches=args.steps, seed=args.seed,
                         start_at=loader_start)
    t0 = time.time()
    handle = None
    step, cursor_done = start_step, loader_start
    losses, stamps = [], []
    try:
        for wid, batch in loader:
            before = _stamp(device)
            opt_state, metrics = step_fn(opt_state, batch)
            stamps.append((before, _stamp(device)))
            losses.append(metrics["loss"])
            step += 1
            # the batch is consumed; the loader retires its id only when
            # asked for the next one
            cursor_done = wid + 1
            if lead and (step % args.log_every == 0
                         or step == start_step + 1):
                m = {k: float(v) for k, v in metrics.items()}
                toks = args.batch * args.seq * (step - start_step)
                print(f"step {step:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                      f"tok/s {toks / (time.time() - t0):,.0f}", flush=True)
            if args.ckpt_dir and step % args.ckpt_every == 0:
                if handle:
                    handle.wait()
                handle = ckpt.save(args.ckpt_dir, step, (params, opt_state),
                                   meta={"step": step,
                                         "cursor_done": cursor_done},
                                   async_save=True)
            if step >= args.steps:
                break
    finally:
        if handle:
            handle.wait()
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, step, (params, opt_state),
                  meta={"step": step, "cursor_done": cursor_done})
        if lead:
            ckpt.prune_old(args.ckpt_dir, keep=3)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if lead:
        print("done")
    return {"step": step, "model": model, "opt_state": opt_state,
            "losses": [float(v) for v in losses],
            "step_ms": [_elapsed_ms(a, b) for a, b in stamps]}


if __name__ == "__main__":
    main()
