#!/usr/bin/env python3
"""The port's multi-rank paths over 4 gloo ranks on the CPU, without JAX:
for a machine whose torch is not the one the tests ran on (the card's).

    PYTHONPATH=src python3 scripts/multirank_check.py

Runs the rank bodies of `tests/torch_ranks.py` with parameters the port
draws itself (seed 0, written in the reference's layout by
`to_reference_tree`) in place of the reference's, each held against the
port's own unsharded run at the tests' tolerances: `ag_matmul`, the
pipeline with its batch over "data", a TP + DP step (also with int8
error-feedback gradients, and the error-feedback round trip of one
`Shard(1)` gradient bitwise), the zero3 and sp_ep
losses and llama's gradients under zero3, sp_ep and tp, an elastic
restart; then the production meshes over a fake group
of 256 and 512 ranks and `launch.train --model-parallel 2` under
`torchrun` over 4 ranks. Prints one JSON line per check and exits 1 if
any failed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def _params(arch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.reference_params import to_reference_tree
    from repro_torch.models.zoo import build_model
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg, device="cpu")
    return to_reference_tree(model, dict(model.named_parameters()))


def _tokens(seed, shape):
    import numpy as np
    return np.random.RandomState(seed).randint(0, 512, shape).astype(
        np.int64)


def check_ag_matmul(R, tmp):
    import numpy as np
    rng = np.random.RandomState(0)
    x, w = rng.randn(16, 8).astype(np.float32), \
        rng.randn(8, 12).astype(np.float32)
    out = R.run_ranks(R.rank_ag_matmul, 4, tmp, x, w)
    err = max(float(abs(r["y"] - x @ w).max()) for r in out)
    heads = max(float(abs(a - b).max()) for r in out
                for got, want, _ in r["heads"].values()
                for a, b in zip(got, want))
    return err <= 1e-5 and heads <= 1e-5, {
        "max_abs_err": err, "heads_local_max_abs_err": heads}


def check_pipeline(R, tmp):
    import numpy as np

    from repro_torch.configs import SERF_AUDIO
    from repro_torch.core.plans import Preprocessor
    from repro_torch.data.synthetic import generate_labelled
    out = R.run_ranks(R.rank_pipeline, 4, tmp, 3, timeout=300)
    audio, _ = generate_labelled(3, 48, segment_s=5.0)
    s5 = audio.shape[-1]
    chunks = (audio.reshape(4, 12, 2, s5).transpose(0, 2, 1, 3)
              .reshape(4, 2, 12 * s5))
    one = Preprocessor(SERF_AUDIO, device="cpu")
    det, res = one.detect(chunks), one(chunks)
    ok = all((r["keep"] == det.keep.numpy()).all()
             and (r["res_keep"] == res.det.keep.numpy()).all()
             and r["n_kept"] == res.n_kept for r in out)
    wave = max(float(abs(r["wave5"] - det.wave5.numpy()).max())
               for r in out)
    cleaned = max(float(abs(r["cleaned"] - res.cleaned).max())
                  for r in out)
    return ok and wave <= 2e-4 and cleaned <= 2e-4, {
        "masks_equal": ok, "wave5_max_abs_err": wave,
        "cleaned_max_abs_err": cleaned, "kept": res.n_kept}


def check_train_step(R, tmp):
    import numpy as np
    grad = np.random.RandomState(7).randn(12, 40).astype(np.float32)
    grad[:, :10] *= 50.0
    out = R.run_ranks(R.rank_train_step, 4, tmp, _params("llama3.2-3b"),
                      _tokens(1, (4, 16)), grad)
    rec, ok = {}, True
    for case in ("plain", "compressed"):
        loss = max(abs(a - b) for a, b in (r[case]["loss"] for r in out))
        diff = max(r[case]["param_diff"] for r in out)
        ok = ok and loss < 1e-4 and diff < 1e-3
        rec[case] = {"loss_abs_err": loss, "param_max_abs_err": diff}
    rec["compressed"]["residual_code_steps"] = res = max(
        r["compressed"]["residual_steps"] for r in out)
    bitwise = all((a == b).all() for r in out
                  for a, b in zip(r["ef"]["plain"], r["ef"]["sharded"]))
    rec["ef_round_trip_bitwise"] = bitwise
    return ok and res <= 1.01 and bitwise, rec


def check_losses(R, tmp):
    cases = [("llama3.2-3b", "zero3", _params("llama3.2-3b")),
             ("granite-moe-3b-a800m", "sp_ep",
              _params("granite-moe-3b-a800m"))]
    out = R.run_ranks(R.rank_losses, 4, tmp, cases, _tokens(1, (4, 32)),
                      ("zero3", "sp_ep", "tp"))
    errs = [abs(a - b) for r in out for a, b in r[:2]]
    grads = {m: max(r[2][m] for r in out) for m in out[0][2]}
    return max(errs) < 2e-3 and max(grads.values()) < 1e-4, {
        "loss_abs_err": max(errs), "grad_rel_err": grads}


def check_elastic(R, tmp):
    arch = "llama3.2-3b"
    out = R.run_ranks(R.rank_elastic_restart, 4, tmp, arch, _params(arch),
                      [_tokens(s, (4, 16)) for s in (1, 2, 3, 4)],
                      str(Path(tmp) / "ckpt"))
    restore = max(r["restore_diff"] for r in out)
    loss = max(abs(a - b) for r in out
               for a, b in zip(r["resumed"], r["straight"]))
    diff = max(r["param_diff"] for r in out)
    exempt = max(r["param_diff_exempt"] for r in out)
    return restore == 0.0 and loss <= 1e-5 and diff < 1e-5 \
        and exempt < 1e-2, {"restore_diff": restore, "loss_abs_err": loss,
                            "param_max_abs_err": diff,
                            "param_max_abs_err_exempt": exempt}


FAKE = """
import json, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_production_mesh
out = {}
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    m = make_production_mesh(multi_pod=multi)
    out[world] = [list(m.mesh.shape),
                  [str(p) for p in ShardingRules(m).sharding("batch",
                                                            "vocab")]]
    dist.destroy_process_group()
print(json.dumps(out))
"""


def check_fake_group(R, tmp):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", FAKE], capture_output=True,
                          text=True, timeout=120, env=env)
    if proc.returncode:
        return False, {"stderr": proc.stderr[-1500:]}
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ok = got == {"256": [[16, 16], ["S(0)", "S(1)"]],
                 "512": [[2, 16, 16], ["S(0)", "S(0)", "S(1)"]]}
    return ok, got


def check_torchrun(R, tmp):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--model-parallel", "2", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env=env)
    steps = [ln for ln in proc.stdout.splitlines() if ln.startswith("step")]
    return proc.returncode == 0 and len(steps) == 2, {
        "steps": steps, "stderr": proc.stderr[-1500:] if proc.returncode
        else ""}


def main():
    import torch
    import torch_ranks as R
    print(json.dumps({"torch": torch.__version__}), flush=True)
    failed = []
    for name, fn in (("ag_matmul", check_ag_matmul),
                     ("pipeline", check_pipeline),
                     ("train_step", check_train_step),
                     ("zero3_sp_ep", check_losses),
                     ("elastic_restart", check_elastic),
                     ("fake_group", check_fake_group),
                     ("torchrun", check_torchrun)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            try:
                ok, rec = fn(R, tmp)
            except Exception:
                ok, rec = False, {"error": traceback.format_exc()[-2000:]}
        rec["wall_s"] = time.perf_counter() - t0
        print(json.dumps({name: {"ok": ok, **rec}}, default=str),
              flush=True)
        if not ok:
            failed.append(name)
    print(json.dumps({"multirank_check": "failed" if failed else "ok",
                      "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
