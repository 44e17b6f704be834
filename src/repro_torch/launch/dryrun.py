"""Multi-pod dry-run (the port's copy of the reference's `launch/dryrun.py`):
run every (arch x shape x mesh) cell once on meta tensors over a fake
process group of the production mesh's size, and record what one device
computes, moves and holds.

The reference forces 512 host devices and lowers each cell with XLA. Here
the mesh is a `DeviceMesh` over a fake group (backend "fake" over
`torch.testing._internal.distributed.fake_pg.FakeStore`): 256 ranks for
`single_pod_16x16`, 512 for `multi_pod_2x16x16`, one world size a process
(`--mesh both` destroys the group and starts the next). Parameters,
optimizer state, caches and inputs are DTensors over meta local shards,
placed by the port's `ShardingRules` from the models' `param_specs()` /
`cache_specs()` / `train_state_specs`; the model is built on meta
(`models.zoo.build_meta_model`: nothing drawn, nothing allocated). "Lower"
is one run of the cell's step on them, eagerly and whole (every layer,
every attention block pair, every microbatch), under
`launch.hlo_analysis.CostCounter`; `lower_s` is its wall time.

Records carry the reference's keys. Those only XLA can give are None:
`compile_s`, `xla_flops_per_device`, `xla_bytes_per_device` and
`flat_collective_bytes`. `flops_per_device` / `bytes_per_device` are the
counter's matmul FLOPs and streams, `collective_bytes_per_device` /
`collectives_by_op` its ring-model bytes. `memory`: `argument_bytes` and
`output_bytes` are the local bytes of the step's inputs and outputs,
`alias_bytes` those the reference donates (parameters and optimizer state
for train, caches for decode), `temp_bytes` the peak of the bytes the step
allocates less its outputs; `peak_estimate_gb` is the reference's formula.
The audio cells run under backend mode "matmul" through
`Preprocessor.phase_fn`, as the reference's do, on a CPU mesh of the same
ranks (the plans run on their mesh's device); the model cells on a mesh
of cards, where DTensor exchanges all to all as it would there (a CPU
mesh gathers and slices instead).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, cell_is_runnable, get_config, \
    list_archs
from repro_torch.distributed.sharding import (ShardingRules, is_dtensor,
                                              tree_map, tree_shardings)
from repro_torch.launch.hlo_analysis import CostCounter, nbytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.reference_params import specs_by_name
from repro_torch.models.zoo import WHISPER_ENC_LEN, build_meta_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (make_train_step, place_params,
                                          place_tree, train_state)

MESHES = {"single_pod_16x16": (256, False), "multi_pod_2x16x16": (512, True)}
DECODE_POS = -1         # the cache's last row: every row is attended to


# ----------------------------------------------------------- the fake group
@contextlib.contextmanager
def fake_group(world):
    """A fake process group of `world` ranks (this process rank 0) for the
    body of the block, destroyed after it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(mesh_name):
    """The mesh `mesh_name` over the current (fake) group, a mesh of cards
    (its tensors are meta): DTensor redistributes there as on the card,
    where a CPU mesh would gather and slice in place of an all-to-all."""
    return make_production_mesh(multi_pod=MESHES[mesh_name][1],
                                device_type="cuda")


def _cpu_mesh(mesh):
    """`mesh`'s ranks and names as a CPU mesh: the preprocessing plans
    run on the device of their mesh, and on meta tensors that is the
    CPU."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh.device_type == "cpu":
        return mesh
    return DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)


# ----------------------------------------------------------- input specs
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape):
    """Meta stand-ins for every model input of the cell (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            batch["targets"] = _meta((B, S), torch.int32)
        if cfg.num_prefix_tokens:
            batch["prefix"] = _meta((B, cfg.num_prefix_tokens, cfg.d_model),
                                    torch.bfloat16)
        if cfg.is_enc_dec:
            batch["enc_frames"] = _meta((B, WHISPER_ENC_LEN, cfg.d_model),
                                        torch.bfloat16)
        return batch
    # decode: one new token against a seq_len cache
    return {"tokens": _meta((B,), torch.int32),
            "pos": shape.seq_len + DECODE_POS}


def batch_spec_tree(cfg, shape, rules):
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": rules.sharding("batch", None)}
        if shape.kind == "train":
            spec["targets"] = rules.sharding("batch", None)
        if cfg.num_prefix_tokens:
            spec["prefix"] = rules.sharding("batch", None, None)
        if cfg.is_enc_dec:
            spec["enc_frames"] = rules.sharding("batch", None, None)
        return spec
    return {"tokens": rules.sharding("batch"), "pos": rules.sharding()}


def decode_overrides(cfg, shape):
    """Sharding-rule overrides for decode cells: KV caches are
    sequence-sharded so every arch shards evenly regardless of kv_heads;
    batch=1 long-context replicates batch and spreads seq over both
    axes."""
    if shape.name == "long_500k":
        return {"batch": (), "kv_seq": ("data", "model"),
                "heads": ("model",)}
    return {"kv_seq": ("model",), "heads": ()}


def _place_inputs(batch, shardings):
    return {k: (shardings[k].place(v) if torch.is_tensor(v) else v)
            for k, v in batch.items()}


# ------------------------------------------------------------- accounting
def _local_bytes(tree) -> int:
    """Local bytes of every tensor in `tree` (a DTensor's local shard)."""
    total = 0

    def add(t):
        nonlocal total
        if torch.is_tensor(t):
            total += nbytes(t.to_local() if is_dtensor(t) else t)
        return t

    tree_map(add, tree)
    return total


def _memory(arg_b, out_b, counter, alias_b):
    temp_b = max(0, counter.peak_bytes - out_b)
    return {"argument_bytes": arg_b, "output_bytes": out_b,
            "temp_bytes": temp_b, "alias_bytes": alias_b,
            "peak_estimate_gb": round(
                (arg_b + out_b + temp_b - alias_b) / 2**30, 3)}


def _record(walk):
    return {"flops_per_device": walk["dot_flops"],
            "bytes_per_device": walk["dot_bytes"],
            "collective_bytes_per_device": walk["coll_bytes"],
            "collectives_by_op": walk["coll_by_op"]}


# ----------------------------------------------- the paper's own workload
def lower_audio_cell(mesh, mesh_name, variant="fused", n_chunks=512):
    """Run the SERF preprocessing pipeline itself as a dry-run cell.

    variant:
      fused     — detection + masked MMSE on ALL chunks (no early exit —
                  the paper's baseline)
      detect    — detection phase only (phase A of the paper's early exit)
      mmse45    — MMSE phase on a 45% survivor batch (phase B; 0.45 is the
                  measured mean survivor fraction)
    """
    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.kernels import backend
    cfg = SERF_AUDIO
    rules = ShardingRules(_cpu_mesh(mesh))
    pre = Preprocessor(cfg, rules, device="cpu")
    S60 = int(12 * 5.0 * cfg.source_rate_hz)
    # the matmul-DFT path: the reference's computation shape
    with backend.use("matmul"):
        if variant in ("fused", "detect"):
            x = rules.sharding("chunks", None, None).place(
                _meta((n_chunks, 2, S60), torch.float32))
            fn = pre.phase_fn("fused" if variant == "fused" else "detect")
        else:
            n5 = int(round(n_chunks * 12 * 0.45))
            n5 -= n5 % mesh.size()
            x = rules.sharding("chunks", None).place(
                _meta((n5, cfg.final_split_samples), torch.float32))
            fn = pre.phase_fn("mmse")
        t0 = time.time()
        with CostCounter() as counter:
            out = fn(x)
        t_lower = time.time() - t0
    walk = counter.result()
    audio_s = n_chunks * 60.0
    return {
        "arch": "serf-audio", "shape": f"pipeline_{variant}",
        "mesh": mesh_name, "kind": "pipeline", "mode": "dp",
        "microbatches": None, "n_devices": int(mesh.size()),
        "audio_hours": audio_s / 3600.0,
        "lower_s": round(t_lower, 2), "compile_s": None,
        **_record(walk),
        "memory": _memory(_local_bytes(x), _local_bytes(_outputs(out)),
                          counter, 0),
        # "useful" work = the paper's two-phase cost: detection on all
        # chunks + MMSE on the measured survivor fraction (0.45)
        "model_flops": None,
    }


def _outputs(out):
    """The tensors of a phase's output (a PipelineOutput or a tensor)."""
    if dataclasses.is_dataclass(out):
        return [v for v in vars(out).values() if torch.is_tensor(v)]
    return out


# ------------------------------------------------------------- cell lowering
def lower_cell(arch, shape_name, mesh, mesh_name, opt_cfg=None,
               num_microbatches=1, mode=None, q_block=None, kv_block=None):
    """One (arch, shape) cell on `mesh`: its record, or {"skipped": why}.
    `q_block` / `kv_block` are accepted for the reference's signature; the
    attention takes its own blocks, as the reference's does."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    runnable, why = cell_is_runnable(cfg, shape)
    if not runnable:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": why}
    if mode is not None:
        cfg = dataclasses.replace(cfg, sharding_mode=mode,
                                  train_sharding_mode=mode)
    used_mode = cfg.sharding_mode
    model = build_meta_model(cfg)

    if shape.kind == "train":
        train_mode = cfg.train_sharding_mode or cfg.sharding_mode
        if cfg.train_microbatches:
            num_microbatches = cfg.train_microbatches
        rules = ShardingRules(mesh, train_mode)
        # zero3-style modes shard batch over every axis; fall back when the
        # global batch doesn't divide (e.g. 256 over a 512-chip multi-pod)
        names = mesh.mesh_dim_names
        bt = 1
        for a in rules._table["batch"]:
            if a in names:
                bt *= mesh.size(names.index(a))
        if shape.global_batch % max(bt, 1):
            train_mode = cfg.sharding_mode
            rules = ShardingRules(mesh, train_mode)
        used_mode = train_mode
        opt_cfg = opt_cfg or OptConfig(quantize_state=cfg.quantize_opt_state)
        opt_state = train_state(model, opt_cfg, rules=rules, distribute=True)
        params = dict(model.named_parameters())
        batch = _place_inputs(input_specs(cfg, shape),
                              batch_spec_tree(cfg, shape, rules))
        step = make_train_step(model, rules, opt_cfg,
                               num_microbatches=num_microbatches)
        arg_b = _local_bytes((params, opt_state, batch))
        alias_b = _local_bytes((params, opt_state))
        t0 = time.time()
        with CostCounter() as counter:
            new_state, metrics = step(opt_state, batch)
        t_lower = time.time() - t0
        out_b = _local_bytes((params, new_state, metrics))
    elif shape.kind == "prefill":
        rules = ShardingRules(mesh, cfg.sharding_mode)
        place_params(model, tree_shardings(rules, specs_by_name(model)))
        batch = _place_inputs(input_specs(cfg, shape),
                              batch_spec_tree(cfg, shape, rules))
        arg_b = _local_bytes((dict(model.named_parameters()), batch))
        alias_b = 0
        t0 = time.time()
        with _no_grad_scope(), CostCounter() as counter:
            out = model.prefill(batch, rules)
        t_lower = time.time() - t0
        out_b = _local_bytes(out)
    else:  # decode
        rules = ShardingRules(mesh, cfg.sharding_mode,
                              overrides=decode_overrides(cfg, shape))
        place_params(model, tree_shardings(rules, specs_by_name(model)))
        kwargs = {"enc_len": WHISPER_ENC_LEN} if cfg.is_enc_dec else {}
        caches = place_tree(
            model.init_cache(shape.global_batch, shape.seq_len, **kwargs),
            tree_shardings(rules, model.cache_specs()))
        ins = input_specs(cfg, shape)
        tokens = batch_spec_tree(cfg, shape, rules)["tokens"].place(
            ins["tokens"])
        arg_b = _local_bytes((dict(model.named_parameters()), caches,
                              tokens))
        alias_b = _local_bytes(caches)
        t0 = time.time()
        with _no_grad_scope(), CostCounter() as counter:
            out = model.decode_step(caches, tokens, ins["pos"], rules)
        t_lower = time.time() - t0
        out_b = _local_bytes(out)

    walk = counter.result()
    pc = cfg.param_counts()
    tokens_n = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = {"train": 6, "prefill": 2, "decode": 2}[shape.kind]
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind,
        "mode": (used_mode if shape.kind == "train" else cfg.sharding_mode),
        "microbatches": num_microbatches if shape.kind == "train" else None,
        "n_devices": int(mesh.size()),
        "lower_s": round(t_lower, 2), "compile_s": None,
        **_record(walk),
        # XLA's own numbers: no counterpart without XLA
        "xla_flops_per_device": None,
        "xla_bytes_per_device": None,
        "flat_collective_bytes": None,
        "memory": _memory(arg_b, out_b, counter, alias_b),
        "model_params_total": pc["total"],
        "model_params_active": pc["active"],
        "model_flops": mult * pc["active"] * tokens_n,
    }


@contextlib.contextmanager
def _no_grad_scope():
    """No autograd, and plain tensors (positions, masks) treated as
    replicated next to DTensors, as the port's meshed steps run."""
    from torch.distributed.tensor.experimental import implicit_replication
    with torch.no_grad(), implicit_replication():
        yield


def run_mesh(mesh_name, archs, shapes, audio=False, microbatches=4,
             mode=None, n_chunks=512, log=print):
    """Every requested cell on one mesh, inside its own fake group: a list
    of records (an `error` key where a cell failed)."""
    results = []
    world = MESHES[mesh_name][0]
    with fake_group(world):
        mesh = production_mesh(mesh_name)
        if audio:
            # the paper's own workload, as dry-run cells
            for variant in ("fused", "detect", "mmse45"):
                try:
                    rec = lower_audio_cell(mesh, mesh_name, variant,
                                           n_chunks)
                    log(f"OK   serf-audio x {variant} x {mesh_name}: "
                        f"lower {rec['lower_s']}s "
                        f"flops/dev {rec['flops_per_device']:.3e} "
                        f"coll/dev {rec['collective_bytes_per_device']:.3e}")
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": "serf-audio", "shape": variant,
                           "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    log(f"FAIL serf-audio x {variant}: {rec['error']}")
                results.append(rec)
        for arch in archs:
            for shape_name in shapes:
                tag = f"{arch} x {shape_name} x {mesh_name}"
                try:
                    rec = lower_cell(arch, shape_name, mesh, mesh_name,
                                     num_microbatches=microbatches,
                                     mode=mode)
                    if "skipped" in rec:
                        log(f"SKIP {tag}: {rec['skipped']}")
                    else:
                        log(f"OK   {tag}: lower {rec['lower_s']}s "
                            f"flops/dev {rec['flops_per_device']:.3e} "
                            f"coll/dev "
                            f"{rec['collective_bytes_per_device']:.3e} "
                            f"peak {rec['memory']['peak_estimate_gb']} GB")
                except Exception as e:  # noqa: BLE001 — record and go on
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    log(f"FAIL {tag}: {rec['error']}")
                results.append(rec)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="grad-accum microbatches for train cells")
    ap.add_argument("--mode", default=None,
                    help="override sharding mode (tp|fsdp_tp|zero3)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append("single_pod_16x16")
    if args.mesh in ("multi", "both"):
        meshes.append("multi_pod_2x16x16")
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]

    results = []
    for mesh_name in meshes:
        results += run_mesh(mesh_name, archs, shapes, audio=args.all,
                            microbatches=args.microbatches, mode=args.mode,
                            log=lambda s: print(s, flush=True))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out if args.out.endswith(".json")
                  else args.out + ".json", "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records")
    n_fail = sum(1 for r in results if "error" in r)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
