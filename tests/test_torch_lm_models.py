"""The port's language-model building blocks against the JAX package's,
module by module, at f32 on the same numpy inputs: attention (blockwise,
context-parallel, decode), RoPE, norms, positions, embeddings, the four
MLPs, the MoE block (with capacity drops), the loss, and the carrying of
the reference's parameters into a port model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS, reduced as rreduced
from repro.distributed.sharding import NULL_RULES as RR
from repro.models import attention as RA
from repro.models import common as RCm
from repro.models import mlp as RM
from repro.models import moe as RMoE
from repro.models import transformer as RT
from repro.models import zoo as RZ
from repro_torch.configs import ARCHS, reduced
from repro_torch.distributed.sharding import NULL_RULES as R
from repro_torch.models import attention as A
from repro_torch.models import common as Cm
from repro_torch.models import mlp as M
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as T
from repro_torch.models import zoo as Z
from repro_torch.models.reference_params import load_reference_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _f32(name):
    return dataclasses.replace(reduced(ARCHS[name]), dtype="float32")


def _rf32(name):
    return dataclasses.replace(rreduced(RARCHS[name]), dtype="float32")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _t(a):
    return torch.tensor(np.asarray(a))


def _qkv(B, Sq, Skv, Hkv, G, D, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, Hkv, G, D).astype(np.float32),
            rng.randn(B, Skv, Hkv, D).astype(np.float32),
            rng.randn(B, Skv, Hkv, D).astype(np.float32))


@pytest.mark.parametrize("kw,blocks", [
    (dict(causal=True), (16, 8)),                 # several q and kv blocks
    (dict(causal=True, prefix_len=12), (16, 8)),  # the VLM's prefix
    (dict(causal=False), (24, 16)),               # the encoder
    (dict(causal=True, q_offset=8, kv_offset=0), (8, 16)),
    (dict(causal=True), (1024, 512)),             # one block each
], ids=["causal", "prefix", "full", "offsets", "one_block"])
def test_blockwise_attention(kw, blocks):
    q, k, v = _qkv(2, 40, 40, 2, 3, 16)
    qb, kb = blocks
    want = RA.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_block=qb, kv_block=kb,
                                  **kw)
    got = A.blockwise_attention(_t(q), _t(k), _t(v), q_block=qb,
                                kv_block=kb, **kw)
    assert got.shape == (2, 40, 2, 3, 16)
    _close(got, want)


@pytest.mark.parametrize("prefix_len", [0, 5])
def test_cp_attention(prefix_len):
    q, k, v = _qkv(2, 24, 24, 2, 2, 8, seed=1)
    want = RA.cp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, prefix_len=prefix_len, rules=RR)
    got = A.cp_attention(_t(q), _t(k), _t(v), causal=True,
                         prefix_len=prefix_len, rules=R)
    _close(got, want)


@pytest.mark.parametrize("pos", [0, 7, 31])
def test_decode_attention(pos):
    q, k, v = _qkv(2, 1, 32, 2, 4, 16, seed=2)
    q = q[:, 0]
    want = RA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), pos)
    got = A.decode_attention(_t(q), _t(k), _t(v), pos)
    _close(got, want)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(theta):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, 4, 32).astype(np.float32)
    pos = (rng.permutation(24)[None] + np.array([[0], [100]])).astype(
        np.int32)
    _close(Cm.apply_rope(_t(x), _t(pos), theta),
           RCm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_array_equal(Cm.rope_freqs(32, theta),
                                  RCm.rope_freqs(32, theta))


def test_norms_and_positions():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 64).astype(np.float32) * 3
    s, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    _close(Cm.rms_norm(_t(x), _t(s), 1e-6),
           RCm.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))
    _close(Cm.layer_norm(_t(x), _t(s), _t(b), 1e-5),
           RCm.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                          1e-5))
    _close(Cm.sinusoidal_positions(20, 64, offset=7),
           RCm.sinusoidal_positions(20, 64, offset=7))


@pytest.mark.parametrize("arch,softcap", [
    ("gemma-7b", 0.0), ("paligemma-3b", 0.0), ("llama3.2-3b", 30.0)])
def test_embed_tokens_and_logits(arch, softcap):
    """gemma-family and VLM embeddings scale by sqrt(d); softcapped logits."""
    cfg = dataclasses.replace(_f32(arch), logit_softcap=softcap)
    rcfg = dataclasses.replace(_rf32(arch), logit_softcap=softcap)
    rng = np.random.RandomState(5)
    tab = rng.randn(cfg.padded_vocab, cfg.d_model).astype(np.float32)
    tok = rng.randint(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    x = Cm.embed_tokens(cfg, {"tok": _t(tab)}, _t(tok), R)
    _close(x, RCm.embed_tokens(rcfg, {"tok": jnp.asarray(tab)},
                               jnp.asarray(tok), RR))
    h = rng.randn(2, 9, cfg.d_model).astype(np.float32)
    _close(Cm.logits_from_hidden(cfg, {"tok": _t(tab)}, _t(h)),
           RCm.logits_from_hidden(rcfg, {"tok": jnp.asarray(tab)},
                                  jnp.asarray(h)))


def _params_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "squared_relu", "gelu"])
def test_mlp(mlp):
    """geglu and gelu use the tanh GELU, `jax.nn.gelu`'s default."""
    rcfg = dataclasses.replace(_rf32("llama3.2-3b"), mlp=mlp)
    cfg = dataclasses.replace(_f32("llama3.2-3b"), mlp=mlp)
    rp = RM.init_mlp(rcfg, jax.random.key(1))
    x = np.random.RandomState(6).randn(2, 7, cfg.d_model).astype(
        np.float32) * 2
    want = RM.apply_mlp(rcfg, rp, jnp.asarray(x), RR)
    p = {k: _t(v) for k, v in _params_np(rp).items()}
    assert set(p) == set(M.init_mlp(cfg, torch.Generator()).keys())
    _close(M.apply_mlp(cfg, p, _t(x), R), want)


def test_top_k_puts_the_lower_index_first_among_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    want_w, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_w, got_i = MoE.top_k(_t(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "arctic-480b"])
def test_apply_moe_with_capacity_drops(arch):
    """Capacity factor 1.25: tokens are dropped. Expert choices, the dropped
    share and the expert load are equal; output and losses within 1e-5."""
    rcfg, cfg = _rf32(arch), _f32(arch)
    assert cfg.moe_capacity_factor == 1.25
    rp = RMoE.init_moe(rcfg, jax.random.key(2))
    rng = np.random.RandomState(7)
    # a shared direction skews the routing, so that experts overflow
    x = (rng.randn(2, 32, cfg.d_model) + 2 * rng.randn(cfg.d_model)).astype(
        np.float32)
    want, waux = RMoE.apply_moe(rcfg, rp, jnp.asarray(x), RR)
    p = {k: _t(v) for k, v in _params_np(rp).items()}
    got, aux = MoE.apply_moe(cfg, p, _t(x), R)
    assert float(aux["dropped_frac"]) > 0          # drops happened
    assert float(aux["dropped_frac"]) == float(waux["dropped_frac"])
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  np.asarray(waux["expert_load"]))
    _close(got, want)
    for k in ("lb_loss", "router_z"):
        _close(aux[k], waux[k])
    # the expert indices themselves, from the same router probabilities
    probs = jax.nn.softmax(jnp.einsum("bse,ex->bsx", jnp.asarray(x),
                                      rp["router"]), axis=-1)
    _, want_i = jax.lax.top_k(probs, cfg.top_k)
    _, got_i = MoE.top_k(torch.softmax(torch.einsum(
        "bse,ex->bsx", _t(x), p["router"]), -1), cfg.top_k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    for S_ in (1, 32, 4096):
        assert MoE.moe_capacity(S_, 40, 8) == RMoE.moe_capacity(S_, 40, 8)


def test_softmax_xent_masks_padded_vocab_and_targets():
    cfg = dataclasses.replace(_f32("llama3.2-3b"), vocab_size=500)
    rcfg = dataclasses.replace(_rf32("llama3.2-3b"), vocab_size=500)
    assert cfg.padded_vocab == 512
    rng = np.random.RandomState(8)
    logits = rng.randn(2, 6, 512).astype(np.float32) * 4
    tgt = rng.randint(0, 500, (2, 6)).astype(np.int32)
    tgt[0, :2] = -1
    _close(Z.softmax_xent(cfg, _t(logits), _t(tgt), R),
           RZ.softmax_xent(rcfg, jnp.asarray(logits), jnp.asarray(tgt), RR))


def test_dense_layer_and_decode_sublayer_in_place():
    """One layer (with cross-attention) on the reference's parameters, and
    a decode step writing its K/V row into the cache in place at pos."""
    rcfg, cfg = _rf32("whisper-small"), _f32("whisper-small")
    rp = _params_np(RT.init_dense_layer(rcfg, jax.random.key(3), cross=True))
    layer = T.init_dense_layer(cfg, torch.Generator(), cross=True)
    for g, leaves in rp.items():
        for k, v in leaves.items():
            layer[g][k].copy_(_t(v))
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    enc = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    epos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    want, _, wkv = RT.apply_dense_layer(
        rcfg, rp, jnp.asarray(x), jnp.asarray(pos), RR,
        enc_out=jnp.asarray(enc), enc_positions=jnp.asarray(epos),
        return_kv=True)
    with torch.no_grad():
        got, _, kv = T.apply_dense_layer(
            cfg, layer, _t(x), _t(pos), R, enc_out=_t(enc),
            enc_positions=_t(epos), return_kv=True)
        _close(got, want)
        for a, b in zip(kv, wkv):
            _close(a, b)
        kc = torch.zeros(2, 10, cfg.num_kv_heads, cfg.head_dim)
        vc = torch.zeros_like(kc)
        out, kc2, vc2 = T.attn_decode_sublayer(cfg, layer["attn"],
                                               _t(x[:, :1]), kc, vc, 3, R)
    assert kc2 is kc and vc2 is vc
    rout, rk, rv = RT.attn_decode_sublayer(
        rcfg, rp["attn"], jnp.asarray(x[:, :1]), jnp.zeros(kc.shape),
        jnp.zeros(kc.shape), 3, RR)
    _close(out, rout)
    _close(kc, rk)
    _close(vc, rv)
    assert kc[:, 3].abs().sum() > 0 and kc[:, :3].abs().sum() == 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "arctic-480b",
                                  "whisper-small"])
def test_param_and_cache_specs_equal_reference(arch):
    rm = RZ.build_model(_rf32(arch))
    m = Z.build_model(_f32(arch), device="cpu")
    assert m.param_specs() == rm.param_specs()
    assert m.cache_specs() == rm.cache_specs()
    shapes = jax.eval_shape(rm.init, jax.random.key(0))
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in m.parameters()) == n


def _tree(arch):
    return _params_np(RZ.build_model(_rf32(arch)).init(jax.random.key(0)))


def test_load_reference_params_raises_on_a_missing_leaf():
    tree = _tree("llama3.2-3b")
    del tree["layers"]["mlp"]["w_gate"]
    with pytest.raises(ValueError, match="missing.*layers.0.mlp.w_gate"):
        load_reference_params(Z.build_model(_f32("llama3.2-3b"), "cpu"), tree)


def test_load_reference_params_raises_on_an_extra_leaf():
    tree = _tree("llama3.2-3b")
    tree["unemb"] = np.zeros((512, 64), np.float32)
    with pytest.raises(ValueError, match="not in the model.*unemb"):
        load_reference_params(Z.build_model(_f32("llama3.2-3b"), "cpu"), tree)


@pytest.mark.parametrize("where", ["leaf", "layers"])
def test_load_reference_params_raises_on_a_mis_shaped_leaf(where):
    tree = _tree("llama3.2-3b")
    if where == "leaf":
        tree["emb"]["tok"] = tree["emb"]["tok"][:, :32]
        match = "emb.tok"
    else:
        tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:1]
        match = "layers.attn.wq"
    with pytest.raises(ValueError, match=match):
        load_reference_params(Z.build_model(_f32("llama3.2-3b"), "cpu"), tree)


def test_load_reference_params_keeps_the_router_f32():
    """bf16 model: every leaf cast to bf16 but the MoE router, which the
    reference keeps f32."""
    cfg = reduced(ARCHS["granite-moe-3b-a800m"])
    tree = _params_np(RZ.build_model(rreduced(
        RARCHS["granite-moe-3b-a800m"])).init(jax.random.key(0)))
    m = load_reference_params(Z.build_model(cfg, device="cpu"), tree)
    assert m.layers[1].moe["router"].dtype == torch.float32
    assert m.layers[1].moe["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(m.layers[1].moe["router"].numpy(),
                                  tree["layers"]["moe"]["router"][1])
