#!/usr/bin/env python3
"""The JAX reference's loss at init for llama3.2-3b at its published widths
cut to a few layers, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 scripts/reference_init_loss.py \
        [--layers 2 4] [--batch 4] [--seq 128]

Parameters from `init(jax.random.key(0))` in the config's dtype (bf16),
the first batch of the reference's `TokenLoader` (seed 0), forward only
(`loss_fn` under `jax.jit`); then the same weights cast to f32. The
full depth (3.2 B parameters, 6.4 GB in bf16 and 12.9 GB in f32 before
any activation) is not run here: on a CPU that size is left out, and the
port's `chip_smoke.py` reads its own loss at 28 layers on the card, in bf16
and in f32 on the same weights. Prints one JSON object:
{"layers": {n: {"bfloat16": loss, "float32": loss}}, "ln_vocab": ...}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS
    from repro.data.loader import TokenLoader
    from repro.distributed.sharding import NULL_RULES
    from repro.models.zoo import build_model

    base = ARCHS["llama3.2-3b"]
    _, batch = next(iter(TokenLoader(base.vocab_size, args.batch, args.seq,
                                     n_batches=1)))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for n in args.layers:
        model = build_model(dataclasses.replace(base, num_layers=n))
        params = model.init(jax.random.key(0))
        model32 = build_model(dataclasses.replace(base, num_layers=n,
                                                  dtype="float32"))
        out[n] = {}
        for dt, m in (("bfloat16", model), ("float32", model32)):
            if dt == "float32":
                params = jax.tree.map(lambda x: x.astype(jnp.float32),
                                      params)
            out[n][dt] = float(jax.jit(
                lambda p: m.loss_fn(p, batch, NULL_RULES)[0])(params))
        del params
        print(f"{n} layers: {out[n]}", flush=True)
    print(json.dumps({"arch": base.name, "batch": args.batch,
                      "seq": args.seq, "layers": out,
                      "ln_vocab": math.log(base.vocab_size)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
