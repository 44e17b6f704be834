"""Grouped-query attention: blockwise (flash-style, online softmax) for
train/prefill, single-step for decode (the port's copy of the reference's
`models/attention.py`).

Blockwise form: an outer loop over query blocks and an inner loop over KV
blocks carrying (m, l, acc), where the reference scans — O(Sq·D) live
memory instead of O(Sq·Skv). Causal blocks above the diagonal are skipped.
GQA is computed grouped (B,S,Hkv,G,D): repeated KV heads are never
materialized. Masked scores are -1e30, not -inf, as in the reference.

The reference contracts with `preferred_element_type=float32`: exact
products of its bf16 operands, summed in f32. The port casts the operands
to f32 before the einsum, which is the same arithmetic (with TF32 off). The
reference's attention is plain jnp, no Pallas kernel, so this stays
`torch.einsum`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import dense_init, dtype_of

_NEG = -1e30


def init_attn(cfg, generator, d_model=None):
    E = d_model or cfg.d_model
    dt = dtype_of(cfg)
    return nn.ParameterDict({
        "wq": dense_init(generator, E, (E, cfg.q_dim), dt),
        "wk": dense_init(generator, E, (E, cfg.kv_dim), dt),
        "wv": dense_init(generator, E, (E, cfg.kv_dim), dt),
        "wo": dense_init(generator, cfg.q_dim, (cfg.q_dim, E), dt),
    })


ATTN_SPECS = {
    "wq": ("w_embed", "q_dim"), "wk": ("w_embed", "kv_dim"),
    "wv": ("w_embed", "kv_dim"), "wo": ("q_dim", "w_embed"),
}


def _pick_block(size, target):
    b = min(target, size)
    while size % b:
        b -= 1
    return b


def blockwise_attention(q, k, v, *, causal, prefix_len=0, q_offset=0,
                        kv_offset=0, q_block=1024, kv_block=512,
                        softmax_scale=None):
    """q: (B,Sq,Hkv,G,D); k,v: (B,Skv,Hkv,D) -> (B,Sq,Hkv,G,D)."""
    B, Sq, Hkv, G, D = q.shape
    Skv = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(D)
    qb = _pick_block(Sq, q_block)
    kb = _pick_block(Skv, kv_block)
    nq, nk = Sq // qb, Skv // kb
    q_pos_base = torch.arange(qb, device=q.device)
    k_pos_base = torch.arange(kb, device=q.device)
    outs = []
    for iq in range(nq):
        qi = q[:, iq * qb:(iq + 1) * qb].float()
        q_pos = q_offset + iq * qb + q_pos_base
        m = torch.full((B, Hkv, G, qb), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, qb, D), dtype=torch.float32,
                          device=q.device)
        for jk in range(nk):
            # skip blocks wholly above the causal diagonal
            if (causal and not prefix_len and kv_offset + jk * kb
                    > q_offset + iq * qb + qb - 1):
                continue
            kj = k[:, jk * kb:(jk + 1) * kb]
            vj = v[:, jk * kb:(jk + 1) * kb]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj.float()) * scale
            if causal:
                k_pos = kv_offset + jk * kb + k_pos_base
                ok = k_pos[None, :] <= q_pos[:, None]
                if prefix_len:
                    ok = ok | (k_pos[None, :] < prefix_len)
                s = torch.where(ok, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vj.dtype).float(),
                              vj.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.movedim(-2, 1).to(q.dtype))      # (B,qb,Hkv,G,D)
    return torch.cat(outs, dim=1)


def cp_attention(q, k, v, *, causal, prefix_len=0, softmax_scale=None,
                 rules=None):
    """Context-parallel full-matrix attention (train-length sequences): q
    sharded over seq, k/v replicated, so every contraction is local. Without
    a mesh it is full-matrix attention with its (B, H, Sq, Skv) scores."""
    B, Sq, Hkv, G, D = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(D)
    if rules is not None:
        q = rules.constrain(q, "batch", "seq_cp", None, None, None)
        k = rules.constrain(k, "batch", None, None, None)
        v = rules.constrain(v, "batch", None, None, None)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        ok = kpos <= qpos
        if prefix_len:
            ok = ok | (kpos < prefix_len)
        s = torch.where(ok, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def decode_attention(q, k, v, pos, *, softmax_scale=None):
    """One-token attention against a cache.

    q: (B,Hkv,G,D); k,v: (B,S,Hkv,D); pos: the current position (cache rows
    0..pos are attended to, the rest masked)."""
    D = q.shape[-1]
    S = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / np.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) * scale
    ok = torch.arange(S, device=q.device) <= pos
    s = torch.where(ok, s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def split_heads(cfg, q, k, v):
    """(B,Sq,q_dim)/(B,Skv,kv_dim) -> grouped (B,Sq,Hkv,G,D), (B,Skv,Hkv,D).

    k/v may have a different sequence length than q (cross-attention)."""
    B, Sq, _ = q.shape
    Skv = k.shape[1]
    G = cfg.num_heads // cfg.num_kv_heads
    q = q.reshape(B, Sq, cfg.num_kv_heads, G, cfg.head_dim)
    k = k.reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def merge_heads(cfg, o):
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.q_dim)
