"""Multi-rank harness for the port's CPU tests: `run_ranks(fn, world, tmp)`
spawns `world` processes, each a gloo rank of a process group over a
`FileStore` in `tmp` (no TCP port, so parallel test workers cannot
collide), runs `fn(rank, world, *args)` and returns each rank's result.

Every rank has a deadline: a rank still alive at `timeout` seconds is
killed and the call fails, as it does when a rank raises (its traceback
comes back in the error). The rank bodies live in this module, which
imports no JAX: a child process imports only what its body needs.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback


def _child(fn, rank, world, tmp, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world, tmp, *args, timeout=240.0):
    """[fn(rank, world, *args) for each rank], each rank in its own
    process. Raises AssertionError when a rank raises or outlives
    `timeout`."""
    tmp = os.fspath(tmp)
    ctx = multiprocessing.get_context("spawn")
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_child, args=(fn, r, world, tmp, args),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} still running after {timeout} s"
    results = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pkl")
        assert os.path.exists(path), \
            f"rank {r} exited {procs[r].exitcode} with no result"
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        assert status == "ok", f"rank {r} failed:\n{value}"
        results.append(value)
    return results


# ------------------------------------------------------------ rank bodies

def _mesh(shape, names=("data", "model")):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for d in shape:
        n *= d
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def _f32_model(arch, ref_params):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.reference_params import load_reference_params
    from repro_torch.models.zoo import build_model
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    return load_reference_params(build_model(cfg, device="cpu"), ref_params)


def _host(t):
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(t):
        t = t.full_tensor()
    return t.detach().float().cpu().numpy().copy()


def rank_ag_matmul(rank, world, x, w):
    """ag_matmul on a (world,) "model" mesh: the whole product."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed.collective_matmul import ag_matmul
    mesh = _mesh((world,), ("model",))
    xd = distribute_tensor(torch.from_numpy(x), mesh, [Shard(0)],
                           src_data_rank=None)
    wd = distribute_tensor(torch.from_numpy(w), mesh, [Shard(1)],
                           src_data_rank=None)
    y = ag_matmul(xd, wd, mesh)
    return {"placements": [str(p) for p in y.placements],
            "local_shape": tuple(y.to_local().shape), "y": _host(y),
            "heads": _heads_local_cases(mesh)}


def _heads_local_cases(mesh):
    """`heads_local(blockwise_attention)` on the (world,) "model" mesh, its
    result and the gradients of q, k, v (of the output against a fixed
    random weight) gathered whole, beside the plain attention's, for (Hkv,
    G) that the mesh divides by KV heads, by query heads and neither (6
    heads over 4 ranks: 2, 2, 2, 0)."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed.sharding import heads_local
    from repro_torch.models.attention import blockwise_attention
    out = {}
    for hkv, g in ((4, 2), (1, 4), (2, 3)):
        gen = torch.Generator().manual_seed(hkv * 10 + g)
        q = torch.randn(2, 16, hkv, g, 8, generator=gen)
        k = torch.randn(2, 16, hkv, 8, generator=gen)
        v = torch.randn(2, 16, hkv, 8, generator=gen)
        w = torch.randn(2, 16, hkv, g, 8, generator=gen)
        d = [distribute_tensor(t, mesh, [Replicate()], src_data_rank=None)
             .requires_grad_() for t in (q, k, v)]
        got = heads_local(blockwise_attention, *d, causal=True, q_block=8,
                          kv_block=8)
        (got * distribute_tensor(w, mesh, [Replicate()],
                                 src_data_rank=None)).sum().backward()
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        want = blockwise_attention(*plain, causal=True, q_block=8,
                                   kv_block=8)
        (want * w).sum().backward()
        out[(hkv, g)] = ([_host(got)] + [_host(t.grad) for t in d],
                         [want.detach().numpy()]
                         + [t.grad.numpy() for t in plain],
                         tuple(got.to_local().shape))
    return out


def rank_losses(rank, world, cases, tokens, grad_modes=()):
    """[(arch, mode, ref_params)] -> per case (unsharded loss, loss with
    the parameters and the batch placed by `mode` over a (2, 2) mesh); with
    `grad_modes`, as its last item, the first case's model's gradients
    under each of those modes against the unsharded ones: {mode: largest
    error over the leaves, relative to the leaf's largest gradient}."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import (NULL_RULES, ShardingRules,
                                                  tree_shardings)
    from repro_torch.models.reference_params import specs_by_name
    from repro_torch.train.train_step import _place_batch, place_params
    mesh = _mesh((2, 2))
    out = []
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(tokens)}
    for arch, mode, ref_params in cases:
        model = _f32_model(arch, ref_params)
        with torch.no_grad():
            plain = float(model.loss_fn(batch, NULL_RULES)[0])
        rules = ShardingRules(mesh, mode)
        place_params(model, tree_shardings(rules, specs_by_name(model)))
        with torch.no_grad(), implicit_replication():
            loss = model.loss_fn(_place_batch(batch, rules, "cpu"), rules)[0]
        out.append((plain, float(loss.full_tensor())))
    if grad_modes:
        out.append(_grad_errors(cases[0][0], cases[0][2], tokens, grad_modes))
    return out


def _grad_errors(arch, ref_params, tokens, modes):
    """{mode: max over leaves of |g_mesh - g| / max |g|}: the gradients of
    one step's loss with the state placed by `mode` over a (2, 2) mesh
    against the unsharded ones."""
    from repro_torch.distributed.sharding import NULL_RULES, ShardingRules
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step, train_state
    opt = OptConfig()
    batch = {"tokens": tokens, "targets": tokens}
    m1 = _f32_model(arch, ref_params)
    train_state(m1, opt)
    _, _, g1 = make_train_step(m1, NULL_RULES, opt).compute_grads(batch)
    g1 = {n: _host(g) for n, g in g1.items()}
    out = {}
    for mode in modes:
        rules = ShardingRules(_mesh((2, 2)), mode)
        m2 = _f32_model(arch, ref_params)
        train_state(m2, opt, rules=rules)
        _, _, g2 = make_train_step(m2, rules, opt).compute_grads(batch)
        out[mode] = max(float(abs(_host(g2[n]) - a).max())
                        / max(float(abs(a).max()), 1e-30)
                        for n, a in g1.items())
    return out


def rank_train_step(rank, world, ref_params, tokens, grad=None):
    """One step of llama3.2-3b reduced f32 in tp mode without a mesh and
    over a (2, 2) mesh, without and with int8 error-feedback gradients:
    {"plain": ..., "compressed": ...}, each (losses, largest parameter
    difference). With `grad`, also the error-feedback round trip of that
    one gradient as a plain tensor and as a DTensor `Shard(1)` over a
    (world,) "model" mesh ("ef")."""
    out = {"plain": _train_step_case(ref_params, tokens, False),
           "compressed": _train_step_case(ref_params, tokens, True)}
    if grad is not None:
        out["ef"] = _ef_round_trip(world, grad)
    return out


def _train_step_case(ref_params, tokens, compress_grads):
    from repro_torch.distributed.sharding import (NULL_RULES, ShardingRules,
                                                  is_dtensor)
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_step, train_state
    opt = OptConfig(lr=1e-2)
    batch = {"tokens": tokens, "targets": tokens}
    m1 = _f32_model("llama3.2-3b", ref_params)
    s1 = train_state(m1, opt, compress_grads)
    s1, met1 = make_train_step(m1, NULL_RULES, opt,
                               compress_grads=compress_grads)(s1, batch)
    rules = ShardingRules(_mesh((2, 2)))
    m2 = _f32_model("llama3.2-3b", ref_params)
    s2 = train_state(m2, opt, compress_grads, rules=rules)
    s2, met2 = make_train_step(m2, rules, opt,
                               compress_grads=compress_grads)(s2, batch)
    p2 = dict(m2.named_parameters())
    diff = max(float(abs(_host(p) - _host(p2[n])).max())
               for n, p in m1.named_parameters())
    sharded = sorted(n for n, p in p2.items()
                     if is_dtensor(p) and any(pl.is_shard()
                                              for pl in p.placements))
    out = {"loss": (float(met1["loss"]), float(met2["loss"])),
           "grad_norm": (float(met1["grad_norm"]),
                         float(met2["grad_norm"])),
           "param_diff": diff, "sharded": sharded,
           "metrics_plain": not any(is_dtensor(v) for v in met2.values())}
    if compress_grads:
        r1, r2 = s1["ef_residual"], s2["ef_residual"]
        # a residual lies within half a code step of zero; an element
        # whose gradient rounds to the neighbouring code moves by one step
        steps = []
        for n in r1:
            a, b = _host(r1[n]), _host(r2[n])
            steps.append(float(abs(a - b).max())
                         / max(2.0 * float(abs(a).max()), 1e-30))
        out["residual_steps"] = max(steps)
        out["residual_sharded"] = is_dtensor(r2["emb.tok"]) and any(
            pl.is_shard() for pl in r2["emb.tok"].placements)
    return out


def _ef_round_trip(world, grad):
    """compress_grads_ef of `grad` (numpy) with a zero residual, plain and
    as a DTensor `Shard(1)` over a (world,) "model" mesh: each result
    gathered whole, and the sharded results' placements."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.train.compression import compress_grads_ef
    g = torch.from_numpy(grad)
    r = torch.from_numpy(np.random.RandomState(1).randn(*grad.shape)
                         .astype(np.float32) * 1e-3)
    plain_g, plain_r = compress_grads_ef({"w": g}, {"w": r})
    mesh = _mesh((world,), ("model",))
    gd = distribute_tensor(g, mesh, [Shard(1)], src_data_rank=None)
    rd = distribute_tensor(r, mesh, [Shard(1)], src_data_rank=None)
    sh_g, sh_r = compress_grads_ef({"w": gd}, {"w": rd})
    return {"plain": (_host(plain_g["w"]), _host(plain_r["w"])),
            "sharded": (_host(sh_g["w"]), _host(sh_r["w"])),
            "placements": [str(p) for p in sh_g["w"].placements]
            + [str(p) for p in sh_r["w"].placements]}


def rank_pipeline(rank, world, seed):
    """Preprocessing over a (world, 1) mesh: the detection of 4 long
    chunks placed over "data" and `Preprocessor(cfg, rules)(audio)`."""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.data.synthetic import generate_labelled
    from repro_torch.distributed.sharding import ShardingRules
    audio, _ = generate_labelled(seed, 4 * 12, segment_s=5.0)
    s5 = audio.shape[-1]
    chunks = (audio.reshape(4, 12, 2, s5).transpose(0, 2, 1, 3)
              .reshape(4, 2, 12 * s5))
    mesh = _mesh((world, 1))
    rules = ShardingRules(mesh)
    x = distribute_tensor(torch.from_numpy(chunks), mesh,
                          [Shard(0), Replicate()], src_data_rank=None)
    pre = Preprocessor(SERF_AUDIO, rules)
    det = pre.detect(x)
    res = pre(chunks)
    return {"device": str(pre.device), "pad": pre.plan.pad_multiple,
            "keep": det.keep.numpy(), "wave5": det.wave5.numpy(),
            "stats": {k: float(v) for k, v in det.stats.items()},
            "res_keep": res.det.keep.numpy(), "cleaned": res.cleaned,
            "n_kept": res.n_kept}


def rank_elastic_restart(rank, world, arch, ref_params, tokens, ckpt_dir):
    """Two steps over a (2, 2) mesh, a checkpoint, two more steps (the
    straight run); then the checkpoint restored with `shardings=` onto
    `mesh_from_plan(plan_mesh(world, model_parallel=1))` and the same two
    steps there."""
    import numpy as np
    import torch

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.distributed.sharding import ShardingRules, tree_shardings
    from repro_torch.ft.failure import plan_mesh
    from repro_torch.launch.mesh import mesh_from_plan
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (make_train_step, train_state,
                                              train_state_specs)
    opt = OptConfig(lr=1e-2, warmup_steps=2, decay_steps=10,
                    quantize_state=arch.startswith("granite"))
    batches = [{"tokens": t, "targets": t} for t in tokens]
    rules = ShardingRules(_mesh((2, 2)))
    model = _f32_model(arch, ref_params)
    state = train_state(model, opt, rules=rules)
    step = make_train_step(model, rules, opt)
    for b in batches[:2]:
        state, _ = step(state, b)
    params = dict(model.named_parameters())
    ckpt.save(ckpt_dir, 2, (params, state), meta={"step": 2})
    at_save = _host_tree((params, state))
    straight, small, rounded = [], {}, []
    for b in batches[2:]:
        loss, metrics, grads = step.compute_grads(b)
        for n, g in grads.items():
            # elements whose gradient is near zero in either step: Adam's
            # update there is a sign decision, which reduction order moves
            g = np.abs(_host(g))
            s = g < 1e-4 * g.max()
            small[n] = s | small[n] if n in small else s
        state, _ = step.update(state, metrics, grads)
        rounded.append(_lossy_state(state, opt))
        straight.append(float(loss))
    plan = plan_mesh(world, model_parallel=1)
    rules2 = ShardingRules(mesh_from_plan(plan))
    model2 = _f32_model(arch, ref_params)
    state2 = train_state(model2, opt, rules=rules2)
    pspecs, ospecs = train_state_specs(model2, opt)
    params2 = dict(model2.named_parameters())
    (saved, state2), meta = ckpt.restore(
        ckpt_dir, 2, like=(params2, state2),
        shardings=(tree_shardings(rules2, pspecs),
                   tree_shardings(rules2, ospecs)))
    with torch.no_grad():
        for n, p in params2.items():
            p.copy_(saved[n])
    restored = _host_tree((params2, state2))
    restore_diff = max(float(abs(a.astype(np.float64) - b).max())
                       for a, b in zip(at_save, restored))
    step2 = make_train_step(model2, rules2, opt)
    resumed = []
    exempt = {n: s.copy() for n, s in small.items()}
    n_rounded = 0
    for b, was in zip(batches[2:], rounded):
        state2, met = step2(state2, b)
        resumed.append(float(met["loss"]))
        # elements whose 8-bit m code or bf16 v rounded to a neighbour of
        # the straight run's value: a rounding decision, as the sign is
        for n, (m1, v1) in was.items():
            m2, v2 = _lossy_state(state2, opt)[n]
            moved = (m1 != m2) | (v1 != v2)
            n_rounded += int((moved & ~exempt[n]).sum())
            exempt[n] |= moved
    diff, diff_exempt, n_small = 0.0, 0.0, 0
    for n, p in params.items():
        d = abs(_host(p) - _host(params2[n]))
        diff = max(diff, float(d[~exempt[n]].max(initial=0.0)))
        diff_exempt = max(diff_exempt, float(d[exempt[n]].max(initial=0.0)))
        n_small += int(small[n].sum())
    return {"plan": (plan.shape, plan.axes), "meta": meta,
            "straight": straight, "resumed": resumed,
            "restore_diff": restore_diff, "leaves": len(restored),
            "param_diff": diff, "param_diff_exempt": diff_exempt,
            "small_grad_elements": n_small,
            "rounded_state_elements": n_rounded,
            "meshes": sorted({tuple(p.device_mesh.shape)
                              for p in params2.values()})}


def _lossy_state(state, opt):
    """{name: (m codes, bf16 v)} as numpy of an 8-bit optimizer state
    (`quantize_state`); {} for an f32 state, which rounds nothing."""
    if not opt.quantize_state:
        return {}
    return {n: (_host(m["codes"]), _host(state["v"][n]))
            for n, m in state["m"].items()}


def _host_tree(tree):
    """Every tensor leaf of `tree` gathered whole, as numpy, in order."""
    from repro_torch.ckpt.checkpoint import _leaves
    return [_host(t) for _, t in _leaves(tree)]


def rank_launch_train(rank, world, ckpt_dir):
    """`launch.train --model-parallel 2` in this group of ranks."""
    from repro_torch.distributed.sharding import is_dtensor
    from repro_torch.launch import train
    out = train.main(["--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "4", "--seq", "16", "--log-every", "1",
                      "--model-parallel", "2", "--ckpt-dir", ckpt_dir,
                      "--ckpt-every", "1"])
    p = out["model"].emb["tok"]
    return {"step": out["step"], "losses": out["losses"],
            "dtensor": is_dtensor(p), "mesh": tuple(p.device_mesh.shape),
            "local": tuple(p.to_local().shape), "global": tuple(p.shape)}
