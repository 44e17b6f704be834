"""Shared layer primitives: norms, embeddings, RoPE, positional encodings,
init (the port's copy of the reference's `models/common.py`).

Parameters keep the reference's layout: a projection is stored (in, out)
and applied as `x @ w`, so weights carry across by name with no transpose.
Random draws come from an explicit `torch.Generator` on the model's device;
their stream differs from `jax.random`'s, so a model is held against the
reference by loading the reference's parameters
(`models.reference_params`), never by seeding both.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param(t) -> nn.Parameter:
    """A model parameter: inference only until training is ported, so it
    asks for no gradient."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------- init helpers
def dense_init(generator, fan_in, shape, dtype):
    """N(0, 1/fan_in) drawn in f32 on the generator's device, then cast."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return param((x * (1.0 / np.sqrt(fan_in))).to(dtype))


def embed_init(generator, shape, dtype):
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return param((x * 0.02).to(dtype))


# ----------------------------------------------------------------------- norms
def rms_norm(x, scale, eps):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def make_norm_params(cfg, d, device):
    dt = dtype_of(cfg)
    if cfg.norm == "rmsnorm":
        return nn.ParameterDict(
            {"scale": param(torch.zeros(d, dtype=dt, device=device))})
    return nn.ParameterDict(
        {"scale": param(torch.ones(d, dtype=dt, device=device)),
         "bias": param(torch.zeros(d, dtype=dt, device=device))})


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


# ------------------------------------------------------------------------ RoPE
def rope_freqs(head_dim, theta):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim, theta, device):
    """`rope_freqs` on `device`, copied there once: a copy from host memory
    at every call would wait for the card's queue to drain."""
    return torch.as_tensor(rope_freqs(head_dim, theta), device=device)


def apply_rope(x, positions, theta):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    Half split (the first and second halves of head_dim rotate together),
    not interleaved; the rotation runs in f32."""
    head_dim = x.shape[-1]
    freqs = _rope_freqs_on(head_dim, theta, x.device)
    angles = positions[..., :, None].float() * freqs     # (..., S, hd/2)
    angles = angles[..., :, None, :]                     # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len, d_model, offset=0, device=None):
    pos = np.arange(offset, offset + seq_len, dtype=np.float32)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float32)[None, :]
    angle = pos / np.power(10_000.0, dim / d_model)
    enc = np.zeros((seq_len, d_model), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return torch.as_tensor(enc, device=device)


# ----------------------------------------------------------------- embeddings
def make_embedding(cfg, generator):
    return nn.ParameterDict({"tok": embed_init(
        generator, (cfg.padded_vocab, cfg.d_model), dtype_of(cfg))})


def embed_tokens(cfg, params, tokens, rules):
    x = params["tok"][tokens.long()]
    if cfg.name.startswith("gemma") or cfg.family == "vlm":   # gemma scaling
        x = (x.float() * np.sqrt(cfg.d_model)).to(x.dtype)
    return rules.constrain(x, "batch", "seq", "embed")


def logits_from_hidden(cfg, params, x, unembed=None):
    """x: (B,S,E) -> (B,S,padded_vocab) float32."""
    w = params["tok"] if unembed is None else unembed
    logits = torch.einsum("bse,ve->bsv", x, w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits

