"""Feed-forward blocks: SwiGLU / GeGLU / squared-ReLU / GELU (the port's
copy of the reference's `models/mlp.py`).

`jax.nn.gelu` defaults to the tanh approximation and `F.gelu` to the exact
erf, so the gelu and geglu blocks pass `approximate="tanh"`.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init, dtype_of

GLU = ("swiglu", "geglu")


def init_mlp(cfg, generator, d_model=None, d_ff=None, mlp=None):
    E = d_model or cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    mlp = mlp or cfg.mlp
    dt = dtype_of(cfg)
    p = {}
    if mlp in GLU:
        p["w_gate"] = dense_init(generator, E, (E, Fd), dt)
    p["w_up"] = dense_init(generator, E, (E, Fd), dt)
    p["w_down"] = dense_init(generator, Fd, (Fd, E), dt)
    return nn.ParameterDict(p)


def mlp_specs(mlp):
    p = {"w_down": ("ff", "w_embed"), "w_up": ("w_embed", "ff")}
    if mlp in GLU:
        p["w_gate"] = ("w_embed", "ff")
    return p


def _act(mlp, h):
    if mlp == "swiglu":
        return F.silu(h)
    if mlp in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    if mlp == "squared_relu":
        r = F.relu(h)
        return r * r
    raise KeyError(mlp)


def apply_mlp(cfg, p, x, rules, mlp=None):
    mlp = mlp or cfg.mlp
    if mlp in GLU:
        h = _act(mlp, x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = _act(mlp, x @ p["w_up"])
    h = rules.constrain(h, "batch", "seq", "act_ff")
    return (h @ p["w_down"]).to(x.dtype)
