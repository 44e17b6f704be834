"""Training through the port's ten archs against the JAX package, and the
port's training launcher.

Each arch at its `reduced` config and f32 with the reference's
`init(jax.random.key(0))` parameters loaded into the port: the loss within
rtol 1e-5 and every gradient within rtol 1e-4 and atol 1e-5 x its leaf's
largest |g| of the reference's `value_and_grad` (the port of
`tests/test_models.py::test_arch_smoke_train_step`, whose own checks come
along); one `make_train_step` step of each arch at its configured dtype
(bf16). `TokenLoader` batches bitwise equal to the reference's;
`launch.train --reduced --device cpu` resumed from the step-2 checkpoint
of a 4-step run is bitwise equal to that run."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks

from repro.configs import ARCHS as RARCHS, reduced as rreduced
from repro.data.loader import TokenLoader as RTokenLoader
from repro.distributed.sharding import NULL_RULES as RR
from repro.models.zoo import build_model as rbuild
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCHS, reduced
from repro_torch.data.loader import TokenLoader
from repro_torch.distributed.sharding import NULL_RULES as R
from repro_torch.launch import train
from repro_torch.models.reference_params import (load_reference_params,
                                                 to_reference_tree)
from repro_torch.models.zoo import build_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step

B, S = 2, 32


def _batch(cfg, seed=1):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.num_prefix_tokens:
        batch["prefix"] = rng.randn(B, cfg.num_prefix_tokens,
                                    cfg.d_model).astype(np.float32)
    if cfg.is_enc_dec:
        batch["enc_frames"] = rng.randn(B, 16, cfg.d_model).astype(np.float32)
    return batch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_gradients_match_reference(arch):
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    rcfg = dataclasses.replace(rreduced(RARCHS[arch]), dtype="float32")
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.key(0))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        lambda p: rmodel.loss_fn(p, jbatch, RR), has_aux=True))(params)

    model = load_reference_params(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    model.requires_grad_(True)
    loss, metrics = model.loss_fn(batch)
    loss.backward()
    loss = float(loss.detach())
    assert np.isfinite(loss) and 2.0 < loss < 12.0   # ~ln(vocab) at init
    np.testing.assert_allclose(loss, float(rloss), rtol=1e-5)
    assert set(metrics) == set(rmetrics)
    grads = {n: p.grad for n, p in model.named_parameters()}
    gn = sum(float(g.abs().sum()) for g in grads.values())
    assert np.isfinite(gn) and gn > 0
    got = dict(_leaves(to_reference_tree(model, grads)))
    want = {k: np.asarray(v, np.float32) for k, v in _leaves(
        jax.tree.map(np.asarray, rgrads))}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg="/".join(k))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_train_step_in_its_dtype(arch):
    """One step of the arch as configured (bf16 parameters, f32 masters):
    a finite loss near ln(vocab), every master moved, the parameters in
    their dtypes, no gradient left behind."""
    cfg = reduced(ARCHS[arch])
    model = build_model(cfg, device="cpu")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1,
                        quantize_state=cfg.quantize_opt_state)
    state = init_train_state(model, opt_cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, metrics = make_train_step(model, R, opt_cfg)(state, _batch(cfg))
    assert 2.0 < float(metrics["loss"]) < 12.0
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["lr"]) == pytest.approx(1e-3)
    # a bf16 parameter may round back to its old value; its master moves
    moved = [n for n, m in state["master"].items()
             if not torch.equal(m, before[n].float())]
    assert len(moved) == len(before)
    for n, p in model.named_parameters():
        assert p.grad is None
        assert state["master"][n].dtype == torch.float32
        assert p.dtype == before[n].dtype


# ------------------------------------------------------------ TokenLoader

@pytest.mark.parametrize("vocab,batch,seq,seed,start", [
    (512, 2, 16, 3, 0), (128_256, 4, 128, 0, 2), (50_304, 3, 33, 7, 1)])
def test_token_loader_bitwise_equal_reference(vocab, batch, seq, seed,
                                              start):
    got = list(TokenLoader(vocab, batch, seq, n_batches=4, seed=seed,
                           start_at=start))
    want = list(RTokenLoader(vocab, batch, seq, n_batches=4, seed=seed,
                             start_at=start))
    assert [w for w, _ in got] == [w for w, _ in want] == list(
        range(start, 4))
    for (_, g), (_, w) in zip(got, want):
        assert set(g) == set(w) == {"tokens", "targets"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_token_loader_deterministic_resume():
    mk = lambda start: TokenLoader(512, 2, 16, n_batches=5, seed=3,  # noqa
                                   start_at=start)
    full = {wid: b["tokens"].copy() for wid, b in mk(0)}
    resumed = {wid: b["tokens"].copy() for wid, b in mk(3)}
    assert sorted(resumed) == [3, 4]
    for wid in resumed:
        np.testing.assert_array_equal(full[wid], resumed[wid])


# ---------------------------------------------------------- the launcher

def _state_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _state_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("extra", [[], ["--compress-grads",
                                        "--microbatches", "2"]])
def test_launch_train_resume_bitwise_equal_straight_run(tmp_path, extra):
    base = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "32", "--log-every", "1"] + extra
    d = str(tmp_path / "ck")
    # a straight run keeps its step-2 and step-4 checkpoints; without the
    # last, --resume goes on from step 2 as a job killed after it would
    straight = train.main(base + ["--ckpt-dir", d, "--ckpt-every", "2"])
    assert straight["step"] == 4 and ckpt.latest_step(d) == 4
    shutil.rmtree(os.path.join(d, "step_4"))
    assert ckpt.latest_step(d) == 2
    resumed = train.main(base + ["--ckpt-dir", d, "--resume"])
    assert resumed["step"] == 4
    assert resumed["losses"] == straight["losses"][2:]
    assert ckpt.latest_step(d) == 4
    for (n, p), (n2, q) in zip(straight["model"].named_parameters(),
                               resumed["model"].named_parameters()):
        assert n == n2 and torch.equal(p, q), n
    a = dict(_state_leaves(straight["opt_state"]))
    b = dict(_state_leaves(resumed["opt_state"]))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_launch_train_checkpoint_restart(tmp_path, capsys):
    """The reference's checkpoint-restart test of its launcher
    (`tests/test_ckpt_ft.py`): a run of 6 steps, then --resume with
    --steps 9 goes on from step 6."""
    d = str(tmp_path / "ck")
    out = train.main(["--arch", "xlstm-125m", "--reduced", "--device", "cpu",
                      "--steps", "6", "--batch", "2", "--seq", "32",
                      "--ckpt-dir", d, "--ckpt-every", "3",
                      "--log-every", "100"])
    assert out["step"] == 6 and ckpt.latest_step(d) == 6
    final = train.main(["--arch", "xlstm-125m", "--reduced", "--device",
                        "cpu", "--steps", "9", "--batch", "2", "--seq", "32",
                        "--ckpt-dir", d, "--resume", "--log-every", "100"])
    assert final["step"] == 9 and len(final["losses"]) == 3
    assert "resumed from step 6" in capsys.readouterr().out


def test_launch_train_prints_the_reference_line(capsys):
    out = train.main(["--reduced", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--log-every", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert len(lines) == 2 and len(out["step_ms"]) == 2
    for ln in lines:
        f = ln.split()
        assert f[2] == "loss" and f[4] == "gnorm" and f[6] == "lr"
        assert f[8] == "tok/s"
    assert all(np.isfinite(out["losses"]))


def test_launch_train_model_parallel_over_four_ranks(tmp_path):
    """`launch.train --model-parallel 2` in a group of 4 gloo ranks: a
    (2, 2) mesh, the vocab-sharded embedding a DTensor, two steps with the
    same finite losses on every rank, a checkpoint written by rank 0."""
    out = torch_ranks.run_ranks(torch_ranks.rank_launch_train, 4, tmp_path,
                                str(tmp_path / "ckpt"))
    for r in out:
        assert r["step"] == 2 and r["dtensor"] and r["mesh"] == (2, 2)
        assert r["global"] == (512, 64) and r["local"] == (256, 64)
        assert r["losses"] == out[0]["losses"]
        assert all(np.isfinite(r["losses"]))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_1", "step_2"]
