"""Mixture-of-Experts block: top-k routing, capacity-bounded scatter
dispatch, batched expert matmuls (the port's copy of the reference's
`models/moe.py`).

Per batch row, tokens get a position-in-expert by a cumsum over the
(S*K, E) one-hot, then are scattered into a dense (E, C, d) buffer; tokens
past capacity go to an overflow slot and are dropped (their contribution is
the residual stream only). Router statistics (per-expert load fractions,
dropped share) come back beside the output.

Top-k: `jax.lax.top_k` puts the lower index first among equal values;
`torch.topk` promises no order among ties, so the top K are taken from a
stable descending sort.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import rows_local
from repro_torch.models.common import dense_init, dtype_of
from repro_torch.models.mlp import GLU, _act


def moe_capacity(seq_len, num_experts, top_k, capacity_factor=1.25):
    c = int(np.ceil(seq_len * top_k / num_experts * capacity_factor))
    return max(8, ((c + 7) // 8) * 8)          # pad to 8 for tiling


def init_moe(cfg, generator):
    dt = dtype_of(cfg)
    E, Fd, X = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": dense_init(generator, E, (E, X), torch.float32)}
    if cfg.mlp in GLU:
        p["w_gate"] = dense_init(generator, E, (X, E, Fd), dt)
    p["w_up"] = dense_init(generator, E, (X, E, Fd), dt)
    p["w_down"] = dense_init(generator, Fd, (X, Fd, E), dt)
    return nn.ParameterDict(p)


def moe_specs(cfg):
    if cfg.expert_shard == "tp":      # experts replicated, ff dim sharded
        p = {"router": ("w_embed", None),
             "w_up": (None, "w_embed", "ff"),
             "w_down": (None, "ff", "w_embed")}
        if cfg.mlp in GLU:
            p["w_gate"] = (None, "w_embed", "ff")
        return p
    p = {"router": ("w_embed", None),
         "w_up": ("experts", "w_embed", "expert_ff"),
         "w_down": ("experts", "expert_ff", "w_embed")}
    if cfg.mlp in GLU:
        p["w_gate"] = ("experts", "w_embed", "expert_ff")
    return p


def top_k(probs, k):
    """The k largest along the last axis, the lower index first among equal
    values (as `jax.lax.top_k`)."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def apply_moe(cfg, p, x, rules, capacity_factor=None):
    """x: (B,S,E_model) -> (out, aux) with aux = load-balance metrics/loss."""
    B, S, E = x.shape
    X, K = cfg.num_experts, cfg.top_k
    cf = (cfg.moe_capacity_factor if capacity_factor is None
          else capacity_factor)
    C = moe_capacity(S, X, K, cf)

    logits = rows_local(functools.partial(torch.einsum, "bse,ex->bsx"),
                        x.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)                         # (B,S,X)
    gate_w, gate_i = top_k(probs, K)                              # (B,S,K)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # position-in-expert via cumsum of one-hot over flattened (S*K)
    flat_i = gate_i.reshape(B, S * K)                             # (B,T)
    onehot = F.one_hot(flat_i, X)                                 # (B,T,X)
    pos_all = onehot.cumsum(1) - 1                                # (B,T,X)
    pos = pos_all.gather(-1, flat_i[..., None])[..., 0]           # (B,T)
    keep = pos < C

    # dispatch: scatter tokens into (B, X*C + 1, E); the last row is the
    # overflow slot every dropped token lands in (the only row that takes
    # more than one token, and it is discarded)
    tok = x.repeat_interleave(K, dim=1)                           # (B,T,E)
    slot = torch.where(keep, flat_i * C + pos, X * C)
    # out of place: an in-place scatter into a fresh buffer cannot take a
    # DTensor's placement
    dispatch = torch.zeros((B, X * C + 1, E), dtype=x.dtype,
                           device=x.device).scatter_add(
        1, slot[..., None].expand(-1, -1, E), tok)
    dispatch = rules.constrain(dispatch, "batch", None, None)
    xe = dispatch[:, :-1].reshape(B, X, C, E)
    exp_ax = "act_experts" if cfg.expert_shard == "ep" else None
    ff_ax = "act_expert_ff" if cfg.expert_shard == "ep" else "act_ff"
    xe = rules.constrain(xe, "batch", exp_ax, None, None)

    if cfg.mlp in GLU:
        h = _act(cfg.mlp, torch.einsum("bxce,xef->bxcf", xe, p["w_gate"]))
        h = h * torch.einsum("bxce,xef->bxcf", xe, p["w_up"])
    else:
        h = _act(cfg.mlp, torch.einsum("bxce,xef->bxcf", xe, p["w_up"]))
    h = rules.constrain(h, "batch", exp_ax, None, ff_ax)
    ye = torch.einsum("bxcf,xfe->bxce", h, p["w_down"])           # (B,X,C,E)
    ye = rules.constrain(ye, "batch", None, None, None)

    # combine: gather each token's expert output, weight, sum over K
    flat_slot = torch.clamp(flat_i * C + pos, max=X * C - 1)
    yt = ye.reshape(B, X * C, E).gather(
        1, flat_slot[..., None].expand(-1, -1, E))                # (B,T,E)
    yt = yt * (gate_w.reshape(B, S * K, 1) * keep[..., None]).to(yt.dtype)
    out = yt.reshape(B, S, K, E).sum(2).to(x.dtype)

    # load-balance aux (Switch-style) + stats for the balance report
    me = probs.mean((0, 1))                                       # (X,)
    ce = onehot.sum((0, 1)).float() / (B * S * K)
    aux = {
        "lb_loss": X * (me * ce).sum(),
        "router_z": torch.logsumexp(logits, -1).square().mean(),
        "expert_load": ce,
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return out, aux
