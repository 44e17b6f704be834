"""The port's training machinery (`repro_torch.train`) against the JAX
package's (`repro.train`): the ports of the seven tests of
`tests/test_train.py`, then the same seeded numpy inputs through both
frameworks: the schedule within 1e-7, int8 codes equal (block and
row-wise; both round half to even) with scales within 1e-7, error-feedback
residuals within 1e-6, and `apply_updates` (f32 and 8-bit state, bf16 and
f32 parameters) within 1e-6 in the new parameters, masters and moments.
Last, one whole `make_train_step` step against the reference's on the
same weights and batch (`test_train_step_matches_reference`)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, reduced as rreduced
from repro.distributed.sharding import NULL_RULES as RR
from repro.models.zoo import build_model as rbuild
from repro.train import compression as RC
from repro.train import optimizer as RO
from repro.train.train_step import make_train_step as rmake_train_step
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.sharding import NULL_RULES as R
from repro_torch.models.reference_params import (load_reference_params,
                                                 to_reference_tree)
from repro_torch.models.zoo import build_model
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import init_train_state, make_train_step


def _quadratic_run(opt_cfg, steps=150, compress=False):
    """Minimize ||Wx - y||^2 over W with the full train machinery stubbed to
    a quadratic: checks optimization plumbing end to end."""
    rng = np.random.RandomState(0)
    Wtrue = torch.as_tensor(rng.randn(8, 8).astype(np.float32))
    X = torch.as_tensor(rng.randn(64, 8).astype(np.float32))
    Y = X @ Wtrue.T
    params = {"w": torch.zeros((8, 8), requires_grad=True)}
    state = O.init_opt_state(opt_cfg, params)
    residual = C.init_residuals(params) if compress else None
    losses = []
    for _ in range(steps):
        params["w"].grad = None
        loss = ((X @ params["w"].T - Y) ** 2).mean()
        loss.backward()
        grads = {"w": params["w"].grad}
        if residual is not None:
            grads, residual = C.compress_grads_ef(grads, residual)
        state, _ = O.apply_updates(opt_cfg, params, state, grads)
        losses.append(float(loss.detach()))
    return losses


def test_adamw_converges_on_quadratic():
    cfg = O.OptConfig(lr=0.1, warmup_steps=5, decay_steps=150,
                      weight_decay=0.0)
    losses = _quadratic_run(cfg)
    assert losses[-1] < 0.02 * losses[0]


def test_quantized_state_tracks_f32():
    base = O.OptConfig(lr=0.1, warmup_steps=5, decay_steps=150,
                       weight_decay=0.0)
    l32 = _quadratic_run(base)
    l8 = _quadratic_run(dataclasses.replace(base, quantize_state=True))
    assert l8[-1] < 0.05 * l8[0]
    assert abs(l8[-1] - l32[-1]) < 0.1 * max(l32[0], 1e-9)


def test_compressed_grads_with_error_feedback_converge():
    cfg = O.OptConfig(lr=0.1, warmup_steps=5, decay_steps=150,
                      weight_decay=0.0)
    lc = _quadratic_run(cfg, compress=True)
    assert lc[-1] < 0.05 * lc[0]


def test_grad_clip():
    grads = {"a": torch.full((4,), 100.0)}
    clipped, gn = O.clip_by_global_norm(grads, 1.0)
    assert float(gn) > 100
    np.testing.assert_allclose(float(O.global_norm(clipped)), 1.0, rtol=1e-5)


def test_schedule_warmup_and_decay():
    cfg = O.OptConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(O.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 50, 100, 1000]]
    assert lrs[0] == 0.0 and lrs[1] == 0.5
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6 and abs(lrs[5] - 0.1) < 1e-6


def test_microbatch_equivalence():
    """Grad accumulation over microbatches == full-batch gradients."""
    cfg = dataclasses.replace(reduced(ARCHS["llama3.2-3b"]), dtype="float32")
    model = build_model(cfg, device="cpu")
    opt_cfg = O.OptConfig(lr=1e-3)
    init_train_state(model, opt_cfg)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 16))
    batch = {"tokens": tokens, "targets": tokens}
    outs = {}
    for mb in (1, 4):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        state = O.init_opt_state(opt_cfg, dict(model.named_parameters()))
        step = make_train_step(model, R, opt_cfg, num_microbatches=mb)
        _, metrics = step(state, batch)
        outs[mb] = ({n: p.detach().clone()
                     for n, p in model.named_parameters()},
                    float(metrics["loss"]))
    assert abs(outs[1][1] - outs[4][1]) < 1e-4
    d = max(float((outs[1][0][n] - outs[4][0][n]).abs().max())
            for n in start)
    assert d < 5e-3


def test_train_step_moe_runs():
    cfg = reduced(ARCHS["granite-moe-3b-a800m"])
    model = build_model(cfg, device="cpu")
    opt_cfg = O.OptConfig(lr=1e-3, quantize_state=True)
    state = init_train_state(model, opt_cfg)
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16))
    step = make_train_step(model, R, opt_cfg)
    s, metrics = step(state, {"tokens": tokens, "targets": tokens})
    assert np.isfinite(float(metrics["loss"]))
    assert int(s["step"]) == 1
    leaf = next(iter(s["m"].values()))
    assert leaf["codes"].dtype == torch.int8
    assert leaf["scale"].dtype == torch.float32
    assert next(iter(s["v"].values())).dtype == torch.bfloat16


# ------------------------------------------------ against the JAX package

def test_schedule_matches_reference():
    cfg = O.OptConfig(lr=3e-3, warmup_steps=10, decay_steps=100,
                      min_lr_frac=0.1)
    rcfg = RO.OptConfig(**dataclasses.asdict(cfg))
    for s in [0, 5, 10, 50, 100, 1000]:
        got = O.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = RO.schedule(rcfg, jnp.asarray(s, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=1e-7)


def _arrays(seed, shape, scale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.standard_cauchy(shape) * scale).astype(np.float32)
    x.flat[::7] = 0.0                        # exact zeros: code 0
    return x


SHAPES = [(256,), (1000,), (3, 5, 7), (64, 130), (1,)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_int8_codes_equal_reference(shape, dtype):
    x = _arrays(sum(shape), shape)
    xt = torch.as_tensor(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    codes, scale = C.quantize_block_int8(xt)
    rcodes, rscale = RC.quantize_block_int8(xj)
    assert codes.dtype == torch.int8 and codes.shape == rcodes.shape
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rcodes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(rscale),
                               rtol=1e-7, atol=0)
    deq = C.dequantize_block_int8(codes, scale, shape)
    rdeq = RC.dequantize_block_int8(rcodes, rscale, shape)
    assert tuple(deq.shape) == shape
    np.testing.assert_allclose(deq.numpy(), np.asarray(rdeq), rtol=1e-7,
                               atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_rowwise_int8_codes_equal_reference(shape):
    x = _arrays(sum(shape) + 1, shape, 1e-3)
    codes, scale = C.quantize_rowwise_int8(torch.as_tensor(x))
    rcodes, rscale = RC.quantize_rowwise_int8(jnp.asarray(x))
    assert tuple(codes.shape) == shape and codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rcodes))
    np.testing.assert_allclose(scale.numpy(), np.asarray(rscale),
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        C.dequantize_rowwise_int8(codes, scale).numpy(),
        np.asarray(RC.dequantize_rowwise_int8(rcodes, rscale)),
        rtol=1e-7, atol=0)


def test_compress_grads_ef_matches_reference():
    """Three rounds of error feedback on the same gradients: dequantized
    gradients and residuals within 1e-6 at every round."""
    shapes = {"a": (300,), "b": (8, 33), "c": (2, 3, 256)}
    grads = {k: _arrays(i, s, 1e-2) for i, (k, s) in
             enumerate(sorted(shapes.items()))}
    res = C.init_residuals({k: torch.as_tensor(v) for k, v in grads.items()})
    rres = RC.init_residuals({k: jnp.asarray(v) for k, v in grads.items()})
    for r in range(3):
        g = {k: torch.as_tensor(v * (r + 1)) for k, v in grads.items()}
        rg = {k: jnp.asarray(v * (r + 1)) for k, v in grads.items()}
        out, res = C.compress_grads_ef(g, res)
        rout, rres = RC.compress_grads_ef(rg, rres)
        for k in grads:
            assert out[k].shape == g[k].shape
            np.testing.assert_allclose(out[k].numpy(), np.asarray(rout[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(res[k].numpy(), np.asarray(rres[k]),
                                       rtol=0, atol=1e-6)


def _leaf_np(x):
    if isinstance(x, dict):
        return {k: _leaf_np(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(quantize, dtype):
    """Three AdamW steps (clip active at the first) from the same
    parameters and gradients: new parameters, masters, m and v within 1e-6,
    the quantized m's codes equal, the step count and metrics equal.

    The reference runs op by op, not under `jax.jit`: jitted on the CPU,
    XLA drops the round trip through bf16 of the clipped gradient
    (`g * scale.astype(g.dtype)`, then `.astype(float32)`) and keeps it in
    f32, where the text of the update, and the port, round it to bf16."""
    shapes = {"emb": (40, 16), "w": (16, 24), "scale": (16,),
              "experts": (3, 8, 5)}
    rng = np.random.RandomState(3)
    p0 = {k: (rng.randn(*s) * 0.1).astype(np.float32)
          for k, s in shapes.items()}
    cfg = O.OptConfig(lr=1e-2, warmup_steps=2, decay_steps=10,
                      quantize_state=quantize)
    rcfg = RO.OptConfig(**dataclasses.asdict(cfg))
    params = {k: torch.as_tensor(v).to(getattr(torch, dtype))
              for k, v in p0.items()}
    rparams = {k: jnp.asarray(v).astype(getattr(jnp, dtype))
               for k, v in p0.items()}
    state = O.init_opt_state(cfg, params)
    rstate = RO.init_opt_state(rcfg, rparams)
    assert state["master"]["w"].data_ptr() != params["w"].data_ptr()
    rapply = functools.partial(RO.apply_updates, rcfg)
    for it, gscale in enumerate([30.0, 0.05, 0.01]):
        g0 = {k: (rng.randn(*s) * gscale).astype(np.float32)
              for k, s in shapes.items()}
        grads = {k: torch.as_tensor(v).to(getattr(torch, dtype))
                 for k, v in g0.items()}
        rgrads = {k: jnp.asarray(v).astype(getattr(jnp, dtype))
                  for k, v in g0.items()}
        state, metrics = O.apply_updates(cfg, params, state, grads)
        rparams, rstate, rmetrics = rapply(rparams, rstate, rgrads)
        assert int(state["step"]) == int(rstate["step"]) == it + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), float(rmetrics[k]),
                                       rtol=1e-6)
        for k in shapes:
            assert params[k].dtype == getattr(torch, dtype)
            np.testing.assert_allclose(_leaf_np(params[k]),
                                       _leaf_np(rparams[k]), rtol=0,
                                       atol=1e-6)
            for part in ("master", "m", "v"):
                got, want = _leaf_np(state[part][k]), _leaf_np(
                    rstate[part][k])
                if isinstance(want, dict):
                    assert state[part][k]["codes"].dtype == torch.int8
                    np.testing.assert_array_equal(got["codes"],
                                                  want["codes"])
                    got, want = got["scale"], want["scale"]
                elif part == "v" and quantize:
                    assert state[part][k].dtype == torch.bfloat16
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree, np.float32)


def _ref_moments(tree):
    """A reference tree as numpy, each quantized moment ({"codes",
    "scale"}) dequantized."""
    if isinstance(tree, dict) and "codes" in tree:
        return np.asarray(RC.dequantize_rowwise_int8(tree["codes"],
                                                     tree["scale"]))
    if isinstance(tree, dict):
        return {k: _ref_moments(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("arch,quantize,microbatches,compress", [
    ("llama3.2-3b", False, 1, False),
    ("granite-moe-3b-a800m", True, 1, False),
    ("llama3.2-3b", False, 4, True)])
def test_train_step_matches_reference(arch, quantize, microbatches,
                                      compress):
    """One step of `make_train_step` against the reference's (jitted), f32,
    the reference's weights loaded into the port, B = 4, S = 16.

    Adam's first step is sign(g) for every element, so an element whose
    gradient is at rounding-noise level may step the other way in the other
    framework, 2 lr apart. So: the loss within rtol 1e-5, the grad norm
    1e-4, the new parameters and masters within 1e-5, except elements whose
    gradient is below 1e-4 of its leaf's largest on either side, which may
    differ by up to 2 lr. After one step m is (1 - b1) times the gradient
    Adam saw (clipped, and compressed with `compress`), so m gives that
    gradient; m and v within rtol 1e-4, atol 1e-5 x their leaf's largest.
    Where int8 codes are in play (8-bit m; int8 gradients) a code may round
    the other way in the other framework: m then within one code (its
    leaf's largest / 127), v (the square of a compressed gradient) within
    two, and bf16 v within one bf16 step (rtol 2^-7).
    (The gradients themselves are held against the reference's
    `value_and_grad` in `tests/test_torch_train_archs.py`, and
    `apply_updates` on identical inputs above.)"""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    rcfg = dataclasses.replace(rreduced(RARCHS[arch]), dtype="float32")
    opt_cfg = O.OptConfig(lr=1e-3, warmup_steps=1, decay_steps=10,
                          quantize_state=quantize)
    ropt = RO.OptConfig(**dataclasses.asdict(opt_cfg))
    rmodel = rbuild(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    model = load_reference_params(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, rparams))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = O.init_opt_state(opt_cfg, params)
    rstate = RO.init_opt_state(ropt, rparams)
    if compress:
        state["ef_residual"] = C.init_residuals(params)
        rstate["ef_residual"] = RC.init_residuals(rparams)
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": tokens, "targets": tokens}
    rstep = jax.jit(rmake_train_step(rmodel, RR, ropt, microbatches,
                                     compress))
    rparams, rstate, rmetrics = rstep(rparams, rstate, {
        k: jnp.asarray(v) for k, v in batch.items()})
    state, metrics = make_train_step(model, R, opt_cfg, microbatches,
                                     compress)(state, batch)

    np.testing.assert_allclose(float(metrics["loss"]),
                               float(rmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(rmetrics["grad_norm"]), rtol=1e-4)
    lr = float(rmetrics["lr"])
    assert lr == pytest.approx(1e-3)

    def port(values):
        return dict(_tree_leaves(to_reference_tree(model, values)))

    def ref(tree):
        return dict(_tree_leaves(_ref_moments(tree)))

    got_m = port({n: C.dequantize_rowwise_int8(m["codes"], m["scale"])
                  if isinstance(m, dict) else m
                  for n, m in state["m"].items()})
    want_m = ref(rstate["m"])
    assert set(got_m) == set(want_m)
    got_p, got_master = port(params), port(state["master"])
    want_p, want_master = ref(rparams), ref(rstate["master"])
    # one int8 code of a leaf is at most its largest |value| / 127
    code = 1 / 127 if quantize or compress else 1e-5
    for path, wm in want_m.items():
        gm = got_m[path]
        peak = max(np.abs(wm).max(), 1e-30)
        np.testing.assert_allclose(gm, wm, rtol=1e-4, atol=code * peak)
        small = ((np.abs(wm) < 1e-4 * peak)
                 | (np.abs(gm) < 1e-4 * np.abs(gm).max()))
        for got, want in ((got_p[path], want_p[path]),
                          (got_master[path], want_master[path])):
            err = np.abs(got - want)
            allowed = np.where(small, 2 * lr, 0.0) + 1e-5 * (
                1 + np.abs(want))
            assert (err <= allowed).all(), (path, float(err.max()))
    got_v = port(state["v"])
    for path, wv in ref(rstate["v"]).items():
        np.testing.assert_allclose(
            got_v[path], wv, rtol=2.0 ** -7 if quantize else 1e-4,
            atol=(2 * code if compress else 1e-5) * max(np.abs(wv).max(),
                                                        1e-30))
