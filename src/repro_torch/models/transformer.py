"""Transformer layer assembly: attention sublayer (train/prefill + decode),
dense/MoE layers and the layer-stack runners (the port's copy of the
reference's `models/transformer.py`). Used by the dense, MoE, VLM and
encoder-decoder models.

A layer's parameters are an `nn.ModuleDict` of `nn.ParameterDict`s under
the reference's names (`ln1.scale`, `attn.wq`, `mlp.w_gate`, ...), and a
stack of layers is an `nn.ModuleList` run by a loop where the reference
scans over parameters stacked on a leading layer axis. Decode writes the new
K/V row into its layer's cache in place at `pos` (the reference's
`dynamic_update_slice` with the cache donated does the same thing
functionally).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as A
from repro_torch.models.common import apply_norm, apply_rope, make_norm_params
from repro_torch.models.mlp import apply_mlp, init_mlp, mlp_specs
from repro_torch.models.moe import apply_moe, init_moe, moe_specs

NORM_SPECS_RMS = {"scale": (None,)}
NORM_SPECS_LN = {"scale": (None,), "bias": (None,)}


def norm_specs(cfg):
    return NORM_SPECS_RMS if cfg.norm == "rmsnorm" else NORM_SPECS_LN


# ---------------------------------------------------------- attention sublayer
def attn_sublayer(cfg, p, x, positions, rules, *, causal=True, prefix_len=0,
                  kv_x=None, kv_positions=None, q_block=1024, kv_block=512,
                  return_kv=False):
    """Full-sequence attention. x: (B,S,E) -> (B,S,E) [, (k, v) for
    caching]."""
    kv_in = x if kv_x is None else kv_x
    q = rules.constrain(x @ p["wq"], "batch", "seq", "act_q")
    k = rules.constrain(kv_in @ p["wk"], "batch", "seq", "act_kv")
    v = rules.constrain(kv_in @ p["wv"], "batch", "seq", "act_kv")
    q, k, v = A.split_heads(cfg, q, k, v)
    if cfg.use_rope:
        kv_pos = positions if kv_positions is None else kv_positions
        B, S, Hkv, G, D = q.shape
        q = apply_rope(q.reshape(B, S, Hkv * G, D), positions,
                       cfg.rope_theta).reshape(B, S, Hkv, G, D)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    use_cp = (rules.mode == "sp_ep" and kv_x is None
              and q.shape[1] <= 8192)
    if use_cp:
        o = A.cp_attention(q, k, v, causal=causal, prefix_len=prefix_len,
                           rules=rules)
    else:
        o = A.blockwise_attention(q, k, v, causal=causal,
                                  prefix_len=prefix_len,
                                  q_block=q_block, kv_block=kv_block)
    o = A.merge_heads(cfg, o)
    o = rules.constrain(o, "batch", "seq", "act_q")
    out = o @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attn_decode_sublayer(cfg, p, x, k_cache, v_cache, pos, rules, *,
                         cross=False, update_cache=True):
    """Single-token attention against a cache.

    x: (B,1,E); k_cache/v_cache: (B,S,Hkv,D), written in place at row `pos`
    (unless `cross` or not `update_cache`); pos: int. Returns
    (out (B,1,E), k_cache, v_cache)."""
    B = x.shape[0]
    q = x @ p["wq"]                                           # (B,1,q_dim)
    G = cfg.num_heads // cfg.num_kv_heads
    qh = q.reshape(B, 1, cfg.num_kv_heads * G, cfg.head_dim)
    if cfg.use_rope:
        pos_arr = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        qh = apply_rope(qh, pos_arr, cfg.rope_theta)
    qh = qh.reshape(B, cfg.num_kv_heads, G, cfg.head_dim)
    if not cross and update_cache:
        k_new = (x @ p["wk"]).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
        v_new = (x @ p["wv"]).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
        if cfg.use_rope:
            k_new = apply_rope(k_new, pos_arr, cfg.rope_theta)
        k_cache[:, pos] = k_new[:, 0]
        v_cache[:, pos] = v_new[:, 0]
    att_pos = k_cache.shape[1] if cross else pos
    o = A.decode_attention(qh, k_cache.to(x.dtype), v_cache.to(x.dtype),
                           att_pos)
    o = o.reshape(B, 1, cfg.q_dim)
    return o @ p["wo"], k_cache, v_cache


# ----------------------------------------------------------- layer definitions
def init_dense_layer(cfg, generator, cross=False):
    p = {"ln1": make_norm_params(cfg, cfg.d_model, generator.device),
         "attn": A.init_attn(cfg, generator),
         "ln2": make_norm_params(cfg, cfg.d_model, generator.device)}
    if cfg.family == "moe":
        p["moe"] = init_moe(cfg, generator)
        if cfg.dense_ff:
            p["mlp"] = init_mlp(cfg, generator, d_ff=cfg.dense_ff)
    else:
        p["mlp"] = init_mlp(cfg, generator)
    if cross:
        p["ln_x"] = make_norm_params(cfg, cfg.d_model, generator.device)
        p["xattn"] = A.init_attn(cfg, generator)
    return nn.ModuleDict(p)


def dense_layer_specs(cfg, cross=False):
    ns = norm_specs(cfg)
    p = {"ln1": ns, "attn": dict(A.ATTN_SPECS), "ln2": ns}
    if cfg.family == "moe":
        p["moe"] = moe_specs(cfg)
        if cfg.dense_ff:
            p["mlp"] = mlp_specs(cfg.mlp)
    else:
        p["mlp"] = mlp_specs(cfg.mlp)
    if cross:
        p["ln_x"] = ns
        p["xattn"] = dict(A.ATTN_SPECS)
    return p


def _ffn(cfg, p, h, rules):
    """The layer's feed-forward half: (out, moe aux or None)."""
    if cfg.family == "moe":
        out, aux = apply_moe(cfg, p["moe"], h, rules)
        if cfg.dense_ff:
            out = out + apply_mlp(cfg, p["mlp"], h, rules)
        return out, aux
    return apply_mlp(cfg, p["mlp"], h, rules), None


def apply_dense_layer(cfg, p, x, positions, rules, *, causal=True,
                      prefix_len=0, enc_out=None, enc_positions=None,
                      return_kv=False):
    """Pre-norm residual layer; optional cross-attention (enc-dec decoder).

    Returns (x, moe_aux, kv); kv is (k, v) [+ cross (xk, xv)] if
    return_kv."""
    h = apply_norm(cfg, p["ln1"], x)
    kv = None
    if return_kv:
        o, kv = attn_sublayer(cfg, p["attn"], h, positions, rules,
                              causal=causal, prefix_len=prefix_len,
                              return_kv=True)
    else:
        o = attn_sublayer(cfg, p["attn"], h, positions, rules,
                          causal=causal, prefix_len=prefix_len)
    x = x + o
    if enc_out is not None:
        h = apply_norm(cfg, p["ln_x"], x)
        if return_kv:
            o, xkv = attn_sublayer(cfg, p["xattn"], h, positions, rules,
                                   causal=False, kv_x=enc_out,
                                   kv_positions=enc_positions, return_kv=True)
            kv = kv + xkv
        else:
            o = attn_sublayer(cfg, p["xattn"], h, positions, rules,
                              causal=False, kv_x=enc_out,
                              kv_positions=enc_positions)
        x = x + o
    h = apply_norm(cfg, p["ln2"], x)
    out, aux = _ffn(cfg, p, h, rules)
    x = rules.constrain(x + out, "batch", "seq", "embed")
    return x.to(h.dtype), aux, kv


def decode_dense_layer(cfg, p, x, k_cache, v_cache, pos, rules,
                       xk_cache=None, xv_cache=None):
    h = apply_norm(cfg, p["ln1"], x)
    o, k_cache, v_cache = attn_decode_sublayer(cfg, p["attn"], h, k_cache,
                                               v_cache, pos, rules)
    x = x + o
    if xk_cache is not None:
        h = apply_norm(cfg, p["ln_x"], x)
        o, _, _ = attn_decode_sublayer(cfg, p["xattn"], h, xk_cache, xv_cache,
                                       pos, rules, cross=True)
        x = x + o
    h = apply_norm(cfg, p["ln2"], x)
    out, _ = _ffn(cfg, p, h, rules)
    return (x + out).to(h.dtype), k_cache, v_cache


# ------------------------------------------------------------ stack runners
def stacked_specs(layer_specs):
    """Prepend the layer axis (replicated) to every leaf spec tuple: the
    reference's stacked layout, kept for the mesh slice."""
    if isinstance(layer_specs, dict):
        return {k: stacked_specs(v) for k, v in layer_specs.items()}
    return (None,) + tuple(layer_specs)


def run_stack(cfg, layers, x, positions, rules, *, causal=True,
              prefix_len=0, enc_out=None, enc_positions=None, remat=True):
    """Every layer in turn. Returns (x, moe aux averaged over the layers).

    `remat` (the reference's rematerialisation in the backward pass) is a
    training concern: accepted and ignored."""
    aux_sum = None
    for p in layers:
        x, aux, _ = apply_dense_layer(cfg, p, x, positions, rules,
                                      causal=causal, prefix_len=prefix_len,
                                      enc_out=enc_out,
                                      enc_positions=enc_positions)
        if aux is not None:
            aux_sum = aux if aux_sum is None else {
                k: aux_sum[k] + aux[k] for k in aux}
    if aux_sum is not None:
        aux_sum = {k: v / cfg.num_layers for k, v in aux_sum.items()}
    return x, aux_sum


def run_stack_prefill(cfg, layers, x, positions, rules, *, causal=True,
                      prefix_len=0, enc_out=None, enc_positions=None):
    """Every layer in turn, keeping its K/V: (x, caches) with caches "k",
    "v" (and cross "xk", "xv") stacked (L,B,S,Hkv,D)."""
    kvs = []
    for p in layers:
        x, _, kv = apply_dense_layer(cfg, p, x, positions, rules,
                                     causal=causal, prefix_len=prefix_len,
                                     enc_out=enc_out,
                                     enc_positions=enc_positions,
                                     return_kv=True)
        kvs.append(kv)
    names = ("k", "v", "xk", "xv")
    caches = {names[i]: torch.stack([kv[i] for kv in kvs])
              for i in range(len(kvs[0]))}
    return x, caches


def run_stack_decode(cfg, layers, x, caches, pos, rules):
    """Every layer in turn for one decode step; caches: dict of (L, ...)
    tensors, "k" / "v" written in place at `pos`."""
    has_cross = "xk" in caches
    for i, p in enumerate(layers):
        x, _, _ = decode_dense_layer(
            cfg, p, x, caches["k"][i], caches["v"][i], pos, rules,
            xk_cache=caches["xk"][i] if has_cross else None,
            xv_cache=caches["xv"][i] if has_cross else None)
    return x, caches
