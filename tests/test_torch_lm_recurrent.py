"""The port's recurrent language-model families against the JAX package's:
Mamba2 (the zamba2-1.2b hybrid) and mLSTM / sLSTM (xlstm-125m).

Module level, at the `reduced` widths and f32, rtol = atol = 1e-5: the
chunked SSD scan (S = 32, 24 and 31 with chunk 16, so Q = 16, 8 and 1; with
and without a carried-in state), the causal conv, `apply_mamba` with its
cache and `decode_mamba` from it, both xLSTM scans, and each cell's apply
and decode with its states. Arch level, with the reference's
`init(jax.random.key(0))` loaded by `load_reference_params`: loss rtol
1e-5, prefill logits 1e-4, every cache leaf 1e-5, one decode step's logits
1e-4. Then the port alone: decoding against the prefill cache reproduces
prefill's next-token logits within the reference's 5e-3, and serving:
greedy tokens equal the reference engine's, the request queue, the
launcher."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, reduced as rreduced
from repro.distributed.sharding import NULL_RULES as RR
from repro.models import mamba2 as RM
from repro.models import xlstm as RX
from repro.models.zoo import build_model as rbuild
from repro.serve.engine import ServeEngine as RServeEngine
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.sharding import NULL_RULES
from repro_torch.models import mamba2 as M
from repro_torch.models import xlstm as X
from repro_torch.models.reference_params import load_reference_params
from repro_torch.models.zoo import HybridLM, XLSTMLM, build_model
from repro_torch.serve.engine import RequestQueue, ServeEngine, decode_caches

RECURRENT_ARCHS = ["xlstm-125m", "zamba2-1.2b"]
B, S = 2, 32
MOD_TOL = 1e-5
NEAR_TIE = 1e-4        # the logit tolerance between the frameworks


def _cfgs(arch):
    return (dataclasses.replace(reduced(ARCHS[arch]), dtype="float32"),
            dataclasses.replace(rreduced(RARCHS[arch]), dtype="float32"))


def _close(got, want, tol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _close_trees(got, want, tol):
    """Two trees of the same structure (dicts / tuples; torch and jax
    leaves), leaf by leaf."""
    g = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        _close(a, b, tol)


def _load(pd, tree):
    """One layer's reference parameters into the port's ParameterDict."""
    assert set(pd) == set(tree)
    with torch.no_grad():
        for k, a in tree.items():
            assert tuple(pd[k].shape) == a.shape
            pd[k].copy_(torch.tensor(np.asarray(a)))
    return pd


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------------ Mamba2
@pytest.mark.parametrize("seq", [32, 24, 31])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(seq, with_state):
    rng = np.random.RandomState(seq)
    H, P, N = 2, 64, 16
    xdt = rng.randn(B, seq, H, P).astype(np.float32)
    a = -rng.uniform(1e-3, 0.5, (B, seq, H)).astype(np.float32)
    Bm = rng.randn(B, seq, N).astype(np.float32)
    Cm = rng.randn(B, seq, N).astype(np.float32)
    s0 = rng.randn(B, H, P, N).astype(np.float32) if with_state else None
    ry, rs = jax.jit(functools.partial(RM._ssd_chunked, chunk=16))(
        xdt, a, Bm, Cm, state0=s0)
    y, s = M._ssd_chunked(_t(xdt), _t(a), _t(Bm), _t(Cm), 16,
                          None if s0 is None else _t(s0))
    assert y.dtype == torch.float32 and y.shape == (B, seq, H, P)
    _close(y, ry, MOD_TOL)
    _close(s, rs, MOD_TOL)


def test_causal_conv_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(B, 9, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    _close(M._causal_conv(_t(x), _t(w)), RM._causal_conv(x, w), MOD_TOL)


def _mamba_layer(cfg, rcfg):
    tree = jax.tree.map(np.asarray, RM.init_mamba(rcfg, jax.random.key(4)))
    g = torch.Generator().manual_seed(0)
    return _load(M.init_mamba(cfg, g), tree), tree


def test_apply_mamba_cache_then_decode_match_reference():
    cfg, rcfg = _cfgs("zamba2-1.2b")
    p, rp = _mamba_layer(cfg, rcfg)
    rng = np.random.RandomState(5)
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    xt = rng.randn(B, cfg.d_model).astype(np.float32)
    rout, rcache = RM.apply_mamba(rcfg, rp, x, RR, return_cache=True)
    rdec, rnew = RM.decode_mamba(rcfg, rp, xt, rcache, RR)
    with torch.no_grad():
        out, cache = M.apply_mamba(cfg, p, _t(x), NULL_RULES,
                                   return_cache=True)
        assert set(cache) == {"state", "conv_x", "conv_B", "conv_C"}
        _close(out, rout, MOD_TOL)
        _close_trees(cache, rcache, MOD_TOL)
        dec, new = M.decode_mamba(cfg, p, _t(xt), cache, NULL_RULES)
    assert new is cache                      # written in place
    _close(dec, rdec, MOD_TOL)
    _close_trees(new, rnew, MOD_TOL)


def test_apply_mamba_from_a_state_and_zero_cache_decode():
    """`state0` / `return_state`, and a decode step from
    `init_mamba_cache`'s zeros (f32 state, conv tails in the given dtype)."""
    cfg, rcfg = _cfgs("zamba2-1.2b")
    p, rp = _mamba_layer(cfg, rcfg)
    d_inner, H, P, N = M.mamba_dims(cfg)
    assert (d_inner, H, P, N) == RM.mamba_dims(rcfg)
    rng = np.random.RandomState(6)
    x = rng.randn(B, 24, cfg.d_model).astype(np.float32)
    s0 = rng.randn(B, H, P, N).astype(np.float32)
    xt = rng.randn(B, cfg.d_model).astype(np.float32)
    rout, rs = RM.apply_mamba(rcfg, rp, x, RR, state0=s0, return_state=True)
    rdec, rnew = RM.decode_mamba(rcfg, rp, xt, RM.init_mamba_cache(rcfg, B),
                                 RR)
    with torch.no_grad():
        out, s = M.apply_mamba(cfg, p, _t(x), NULL_RULES, state0=_t(s0),
                               return_state=True)
        zero = M.init_mamba_cache(cfg, B, torch.bfloat16)
        assert zero["state"].dtype == torch.float32
        assert zero["conv_x"].dtype == torch.bfloat16
        dec, new = M.decode_mamba(cfg, p, _t(xt), M.init_mamba_cache(cfg, B),
                                  NULL_RULES)
    _close(out, rout, MOD_TOL)
    _close(s, rs, MOD_TOL)
    _close(dec, rdec, MOD_TOL)
    _close_trees(new, rnew, MOD_TOL)


def test_mamba_init_matches_reference_constants():
    """dt_bias is the reference's numpy draw; A_log 0, D 1, norm 0; the
    SSM leaves f32 in a bf16 model."""
    cfg = reduced(ARCHS["zamba2-1.2b"])
    rp = RM.init_mamba(rreduced(RARCHS["zamba2-1.2b"]), jax.random.key(0))
    p = M.init_mamba(cfg, torch.Generator().manual_seed(0))
    for k in ("dt_bias", "A_log", "D"):
        assert p[k].dtype == torch.float32
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(rp[k]))
    assert p["w_z"].dtype == p["norm"].dtype == torch.bfloat16
    assert not p["norm"].float().any()
    assert set(M.MAMBA_SPECS) == set(RM.MAMBA_SPECS) == set(p)


def test_softplus_is_logaddexp():
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 40.0], np.float32)
    _close(M.softplus(_t(x)), jax.nn.softplus(x), 1e-7)


# ------------------------------------------------------------------- xLSTM
def _gate_inputs(rng, seq, H, dh):
    q, k, v = (rng.randn(B, seq, H, dh).astype(np.float32) for _ in range(3))
    li = rng.randn(B, seq, H).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-rng.randn(B, seq, H)))).astype(np.float32)
    return q, k, v, li, lf


def test_mlstm_scan_matches_reference():
    cfg, rcfg = _cfgs("xlstm-125m")
    _, H, dh = X.xlstm_dims(cfg)
    rng = np.random.RandomState(7)
    ins = _gate_inputs(rng, 12, H, dh)
    st = (rng.randn(B, H, dh, dh).astype(np.float32),
          rng.randn(B, H, dh).astype(np.float32),
          rng.randn(B, H).astype(np.float32))
    for s0 in (RX.mlstm_state0(rcfg, B), st):
        rh, rs = jax.jit(RX._mlstm_scan)(*ins, s0)
        h, s = X._mlstm_scan(*map(_t, ins), tuple(map(_t, s0)))
        _close(h, rh, MOD_TOL)
        _close_trees(s, rs, MOD_TOL)


def test_slstm_scan_matches_reference():
    cfg, rcfg = _cfgs("xlstm-125m")
    d_inner, H, dh = X.xlstm_dims(cfg)
    rng = np.random.RandomState(8)
    wx = rng.randn(B, 12, 4 * d_inner).astype(np.float32)
    r_g = (rng.randn(H, dh, 4 * dh) / np.sqrt(dh)).astype(np.float32)
    st = tuple(rng.randn(B, H, dh).astype(np.float32) for _ in range(4))
    st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
    for s0 in (RX.slstm_state0(rcfg, B), st):
        rh, rs = jax.jit(RX._slstm_scan)(wx, r_g, s0)
        h, s = X._slstm_scan(_t(wx), _t(r_g), tuple(map(_t, s0)))
        _close(h, rh, MOD_TOL)
        _close_trees(s, rs, MOD_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_apply_and_decode_match_reference(kind):
    cfg, rcfg = _cfgs("xlstm-125m")
    init, rinit = getattr(X, f"init_{kind}"), getattr(RX, f"init_{kind}")
    apply, rapply = getattr(X, f"apply_{kind}"), getattr(RX, f"apply_{kind}")
    decode = getattr(X, f"decode_{kind}")
    rdecode = getattr(RX, f"decode_{kind}")
    rp = jax.tree.map(np.asarray, rinit(rcfg, jax.random.key(9)))
    p = _load(init(cfg, torch.Generator().manual_seed(0)), rp)
    assert set(getattr(X, f"{kind.upper()}_SPECS")) == set(p)
    rng = np.random.RandomState(10)
    x = rng.randn(B, 16, cfg.d_model).astype(np.float32)
    xt = rng.randn(B, cfg.d_model).astype(np.float32)
    rout, rst = rapply(rcfg, rp, x, RR, return_state=True)
    rdec, rnew = rdecode(rcfg, rp, xt, rst, RR)
    with torch.no_grad():
        out, st = apply(cfg, p, _t(x), NULL_RULES, return_state=True)
        _close(out, rout, MOD_TOL)
        _close_trees(st, rst, MOD_TOL)
        _close(apply(cfg, p, _t(x), NULL_RULES), rout, MOD_TOL)
        dec, new = decode(cfg, p, _t(xt), st, NULL_RULES)
    _close(dec, rdec, MOD_TOL)
    _close_trees(new, rnew, MOD_TOL)
    assert all(s.dtype == torch.float32 for s in new)


def test_xlstm_init_keeps_f32_gates_and_m0():
    cfg = reduced(ARCHS["xlstm-125m"])
    g = torch.Generator().manual_seed(0)
    m, s = X.init_mlstm(cfg, g), X.init_slstm(cfg, g)
    H = cfg.num_heads
    for t in (m["w_if"], m["b_if"], s["w_g"], s["r_g"], s["b_g"]):
        assert t.dtype == torch.float32
    np.testing.assert_array_equal(m["b_if"].numpy(), [0.0] * H + [3.0] * H)
    for st in (X.mlstm_state0(cfg, 2), X.slstm_state0(cfg, 2)):
        assert all(t.dtype == torch.float32 for t in st)
        assert (st[2] == -1e30).all()


# --------------------------------------------------------------- the archs
def _loaded(arch):
    cfg, rcfg = _cfgs(arch)
    rmodel = rbuild(rcfg)
    params = rmodel.init(jax.random.key(0))
    model = load_reference_params(build_model(cfg, device="cpu"),
                                  jax.tree.map(np.asarray, params))
    return cfg, model, rmodel, params


def _ref_decode_caches(rmodel, pf, max_seq, dtype=jnp.float32):
    """The reference engine's cache branch (`serve/engine.py`)."""
    if rmodel.cfg.family == "ssm":
        return pf
    caches = rmodel.init_cache(pf["k"].shape[1], max_seq, dtype=dtype)
    for k in pf:
        if k in ("k", "v"):
            caches[k] = jax.lax.dynamic_update_slice(
                caches[k], pf[k].astype(caches[k].dtype), (0,) * 5)
        else:
            caches[k] = pf[k]
    return caches


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_arch_matches_reference(arch):
    cfg, model, rmodel, params = _loaded(arch)
    assert isinstance(model, {"hybrid": HybridLM, "ssm": XLSTMLM}[
        cfg.family])
    tokens = _tokens(cfg)
    batch = {"tokens": tokens, "targets": tokens}
    k = S - 1
    tok = tokens[:, k]

    @jax.jit
    def reference(p, b, head):
        loss, metrics = rmodel.loss_fn(p, b, RR)
        logits, caches = rmodel.prefill(p, b, RR)
        _, hc = rmodel.prefill(p, {"tokens": head}, RR)
        dlogits, _ = rmodel.decode_step(
            p, _ref_decode_caches(rmodel, hc, S), jnp.asarray(tok), k, RR)
        zero = (rmodel.init_cache(B, S, dtype=jnp.float32)
                if cfg.family == "hybrid" else rmodel.init_cache(B))
        zlogits, _ = rmodel.decode_step(p, zero, jnp.asarray(tok), 3, RR)
        return loss, metrics, logits, caches, dlogits, zlogits

    rloss, rmetrics, rlogits, rcaches, rdlogits, rzlogits = reference(
        params, {kk: jnp.asarray(v) for kk, v in batch.items()},
        jnp.asarray(tokens[:, :k]))
    with torch.inference_mode():
        loss, metrics = model.loss_fn(batch)
        logits, caches = model.prefill(batch)
        _, hc = model.prefill({"tokens": tokens[:, :k]})
        cache = decode_caches(model, hc, S, dtype=torch.float32)
        dlogits, cache2 = model.decode_step(cache, torch.as_tensor(tok), k)
        zero = model.init_cache(B, S, dtype=torch.float32)
        zlogits, _ = model.decode_step(zero, torch.as_tensor(tok), 3)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    assert set(metrics) == set(rmetrics) == {"loss", "xent"}
    assert logits.shape == (B, cfg.padded_vocab)
    _close(logits, rlogits, 1e-4)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, caches)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, rcaches))
    _close_trees(caches, rcaches, 1e-5)
    _close(dlogits, rdlogits, 1e-4)
    assert cache2 is cache                      # written in place
    _close(zlogits, rzlogits, 1e-4)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_specs_mirror_reference(arch):
    cfg, rcfg = _cfgs(arch)
    model = build_model(cfg, device="cpu")
    rmodel = rbuild(rcfg)
    assert model.param_specs() == rmodel.param_specs()
    assert model.cache_specs() == rmodel.cache_specs()
    shapes = jax.eval_shape(rmodel.init, jax.random.key(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_reference_params_keep_f32_leaves_in_bf16(arch):
    """A bf16 model: the leaves the reference keeps f32 stay f32 after the
    copy; a missing, extra or mis-shaped leaf raises."""
    cfg = reduced(ARCHS[arch])
    assert cfg.dtype == "bfloat16"
    rmodel = rbuild(rreduced(RARCHS[arch]))
    tree = jax.tree.map(np.asarray, rmodel.init(jax.random.key(0)))
    model = load_reference_params(build_model(cfg, device="cpu"), tree)
    f32 = {"dt_bias", "A_log", "D", "w_if", "b_if", "w_g", "r_g", "b_g"}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[1]
        assert p.dtype == (torch.float32 if leaf in f32 else torch.bfloat16), \
            name
    group = "layers" if arch == "zamba2-1.2b" else "mlstm"
    inner = "mamba" if arch == "zamba2-1.2b" else "cell"
    leaf = "D" if arch == "zamba2-1.2b" else "b_if"
    bad = jax.tree.map(lambda a: a, tree)
    del bad[group][inner][leaf]
    with pytest.raises(ValueError, match="missing"):
        load_reference_params(build_model(cfg, device="cpu"), bad)
    bad = jax.tree.map(lambda a: a, tree)
    bad[group][inner]["extra"] = bad[group][inner][leaf]
    with pytest.raises(ValueError, match="not in the model"):
        load_reference_params(build_model(cfg, device="cpu"), bad)
    bad = jax.tree.map(lambda a: a, tree)
    bad[group][inner][leaf] = bad[group][inner][leaf][..., :1]
    with pytest.raises(ValueError, match=f"{inner}\\.{leaf}: reference"):
        load_reference_params(build_model(cfg, device="cpu"), bad)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
@pytest.mark.parametrize("cache_dtype", [None, torch.float32])
def test_decode_matches_prefill(arch, cache_dtype):
    """Decoding token k against the prefill cache of tokens[:k] reproduces
    prefill(tokens[:k+1])'s next-token logits (the reference's
    `test_decode_matches_prefill`, 5e-3), with the caches' default dtype
    (bf16 K/V for the hybrid) and with f32."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tokens = _tokens(cfg)
    k = S - 1
    with torch.inference_mode():
        want, _ = model.prefill({"tokens": tokens})
        _, pf = model.prefill({"tokens": tokens[:, :k]})
        caches = decode_caches(model, pf, S, dtype=cache_dtype)
        if cfg.family == "hybrid":
            assert caches["k"].dtype == (cache_dtype or torch.bfloat16)
            assert caches["mamba"] is pf["mamba"]
        else:
            assert caches is pf
        got, _ = model.decode_step(caches, torch.as_tensor(tokens[:, k]), k)
    assert got.shape == (B, cfg.padded_vocab) and torch.isfinite(got).all()
    _close(got, want, 5e-3)


# ----------------------------------------------------------------- serving
def _reference_margins(eng, prompts, n):
    """The reference engine's own loop, keeping each step's gap between
    the top two logits: (tokens, gaps)."""
    cfg = eng.cfg
    logits, pf = eng._prefill(eng.params, {"tokens": jnp.asarray(prompts)})
    caches = _ref_decode_caches(eng.model, pf, eng.max_seq,
                                dtype=jnp.bfloat16)
    toks, gaps = [], []
    for i in range(n):
        lg = np.asarray(logits)[:, :cfg.vocab_size]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        toks.append(lg.argmax(-1).astype(np.int32))
        if i + 1 < n:
            logits, caches = eng._decode(eng.params, caches,
                                         jnp.asarray(toks[-1]),
                                         jnp.int32(prompts.shape[1] + i))
    return np.stack(toks, 1), np.stack(gaps, 1)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_greedy_tokens_equal_reference(arch):
    """Same parameters, same prompts: the same greedy tokens. A row stops
    being compared from the first step whose top two reference logits lie
    within NEAR_TIE."""
    cfg, model, rmodel, params = _loaded(arch)
    prompts = _tokens(cfg, seed=11, shape=(4, 8))
    n = 8
    reng = RServeEngine(rmodel, params, max_seq=48)
    want = reng.generate(prompts, n)
    loop, gaps = _reference_margins(reng, prompts, n)
    np.testing.assert_array_equal(loop, want)
    got = ServeEngine(model, max_seq=48, device="cpu").generate(prompts, n)
    assert got.shape == (4, n) and got.dtype == np.int32
    stopped = 0
    for b in range(4):
        tie = np.flatnonzero(gaps[b] < NEAR_TIE)
        upto = tie[0] if tie.size else n
        stopped += upto < n
        np.testing.assert_array_equal(got[b, :upto], want[b, :upto])
    assert stopped <= 1, f"{stopped} of 4 rows hit a near-tie"


def test_request_queue_serves_all():
    """The reference's `test_request_queue_serves_all`, on xlstm-125m as it
    has it."""
    cfg = reduced(ARCHS["xlstm-125m"])
    model = build_model(cfg, device="cpu")
    eng = ServeEngine(model, max_seq=32, device="cpu")
    q = RequestQueue(eng, batch_size=3, prompt_len=8, n_tokens=4)
    rng = np.random.RandomState(1)
    rids = [q.submit(rng.randint(0, cfg.vocab_size, 8)) for _ in range(5)]
    done = {}
    while len(done) < len(rids):
        for r in q.pump():
            assert r not in done
            done[r] = q.result(r)
    assert q.pump() == []
    for r in rids:
        assert done[r].shape == (4,)
        assert q.result(r) is None   # popped: handed over exactly once


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_launch_serve_lm_mode_is_seeded(arch, capsys):
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", "--requests", "3", "--seed",
            "3"]
    lines = []
    for _ in range(2):
        assert sorted(serve.main(argv)) == [0, 1, 2]
        out = capsys.readouterr().out
        assert "served 3 requests, 12 tokens in" in out and "on cpu" in out
        lines.append(out.splitlines()[-1])
    assert lines[0] == lines[1] and lines[0].startswith(
        "sample output tokens: [")
    toks = json.loads(lines[0].split(": ", 1)[1])
    assert len(toks) == 4 and all(0 <= t < 512 for t in toks)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_entry_points_raise_without_a_card(arch):
    """No fallback to the CPU: the models, the engine and the launcher
    raise without a card unless device="cpu" is passed."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    from repro_torch.launch import serve
    cfg = reduced(ARCHS[arch])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--reduced"])
