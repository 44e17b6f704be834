"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory, recurrent)
(the port's copy of the reference's `models/xlstm.py`).

The xLSTM cell equations (Beck et al. 2024) with stabilized exponential
gating (running max-state m). Both cells run as a Python loop over time
(the reference's `lax.scan`): sLSTM is inherently sequential (its
recurrence reads h_{t-1}); the recurrent mLSTM is the reference's own form
(a chunkwise-parallel variant is not in it).

As in the reference: both block types use a pre-norm residual block with 2x
up-projection and a SiLU-gated output branch; per-head causal conv
frontends are omitted. States are tuples of f32 tensors, (C, n, m) for the
mLSTM and (c, n, m, h) for the sLSTM; m starts at -1e30.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init, dtype_of, param

_M0 = -1e30


def xlstm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    dh = d_inner // H
    return d_inner, H, dh


def _post(p, h, z, x):
    """The output branch both cells share: RMS-normalise h, gate by
    SiLU(z), project down. h: (B,S,d_inner) f32."""
    var = h.square().mean(-1, keepdim=True)
    h = h * torch.rsqrt(var + 1e-5) * (1.0 + p["norm"].float())
    h = h * F.silu(z.float())
    return h.to(x.dtype) @ p["w_down"]


# ------------------------------------------------------------------- mLSTM
def init_mlstm(cfg, generator):
    dt = dtype_of(cfg)
    E = cfg.d_model
    d_inner, H, dh = xlstm_dims(cfg)
    dev = generator.device
    return nn.ParameterDict({
        "w_up": dense_init(generator, E, (E, 2 * d_inner), dt),
        "w_q": dense_init(generator, d_inner, (d_inner, d_inner), dt),
        "w_k": dense_init(generator, d_inner, (d_inner, d_inner), dt),
        "w_v": dense_init(generator, d_inner, (d_inner, d_inner), dt),
        "w_if": dense_init(generator, d_inner, (d_inner, 2 * H),
                           torch.float32),
        "b_if": param(torch.cat([
            torch.zeros(H, dtype=torch.float32, device=dev),
            torch.full((H,), 3.0, dtype=torch.float32, device=dev)])),
        "norm": param(torch.zeros(d_inner, dtype=dt, device=dev)),
        "w_down": dense_init(generator, d_inner, (d_inner, E), dt),
    })


MLSTM_SPECS = {
    "w_up": ("w_embed", "ff"), "w_q": (None, "ff"), "w_k": (None, "ff"),
    "w_v": (None, "ff"), "w_if": ("ff", None), "b_if": (None,),
    "norm": ("ff",), "w_down": ("ff", "w_embed"),
}


def _mlstm_scan(q, k, v, li, lf, state0):
    """q,k,v: (B,S,H,dh); li,lf: (B,S,H) log gates; returns h (B,S,H,dh)
    and the final (C, n, m)."""
    q, k, v, li, lf = (t.float() for t in (q, k, v, li, lf))
    C, n, m = state0                      # (B,H,dh,dh),(B,H,dh),(B,H)
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt, lit, lft = q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t]
        m_new = torch.maximum(lft + m, lit)
        ig = torch.exp(lit - m_new)[..., None]
        fg = torch.exp(lft + m - m_new)[..., None]
        C = fg[..., None] * C + ig[..., None] * (vt[..., :, None]
                                                 * kt[..., None, :])
        n = fg * n + ig * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.maximum((n * qt).sum(-1).abs(),
                            torch.exp(-m_new))[..., None]
        hs.append(num / den)
        m = m_new
    return torch.stack(hs, 1), (C, n, m)


def mlstm_state0(cfg, batch, device=None):
    _, H, dh = xlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, H, dh, dh), **f32),
            torch.zeros((batch, H, dh), **f32),
            torch.full((batch, H), _M0, **f32))


def apply_mlstm(cfg, p, x, rules, state0=None, return_state=False):
    B, S, E = x.shape
    d_inner, H, dh = xlstm_dims(cfg)
    up = x @ p["w_up"]
    xm, z = up.chunk(2, dim=-1)
    xm = rules.constrain(xm, "batch", "seq", "act_ff")
    q = (xm @ p["w_q"]).reshape(B, S, H, dh)
    k = (xm @ p["w_k"]).reshape(B, S, H, dh) / math.sqrt(float(dh))
    v = (xm @ p["w_v"]).reshape(B, S, H, dh)
    gates = xm.float() @ p["w_if"] + p["b_if"]
    li, lf = gates[..., :H], F.logsigmoid(gates[..., H:])
    if state0 is None:
        state0 = mlstm_state0(cfg, B, x.device)
    h, state = _mlstm_scan(q, k, v, li, lf, state0)
    out = _post(p, h.reshape(B, S, d_inner), z, x)
    if return_state:
        return out, state
    return out


def decode_mlstm(cfg, p, x, state, rules):
    """x: (B,E); single-step mLSTM: (out (B,E), new state)."""
    out, new_state = apply_mlstm(cfg, p, x[:, None, :], rules,
                                 state0=state, return_state=True)
    return out[:, 0], new_state


# ------------------------------------------------------------------- sLSTM
def init_slstm(cfg, generator):
    dt = dtype_of(cfg)
    E = cfg.d_model
    d_inner, H, dh = xlstm_dims(cfg)
    dev = generator.device
    return nn.ParameterDict({
        "w_up": dense_init(generator, E, (E, 2 * d_inner), dt),
        "w_g": dense_init(generator, d_inner, (d_inner, 4 * d_inner),
                          torch.float32),
        "r_g": dense_init(generator, dh, (H, dh, 4 * dh), torch.float32),
        "b_g": param(torch.zeros(4 * d_inner, dtype=torch.float32,
                                 device=dev)),
        "norm": param(torch.zeros(d_inner, dtype=dt, device=dev)),
        "w_down": dense_init(generator, d_inner, (d_inner, E), dt),
    })


SLSTM_SPECS = {
    "w_up": ("w_embed", "ff"), "w_g": ("ff", None), "r_g": (None, None, None),
    "b_g": (None,), "norm": ("ff",), "w_down": ("ff", "w_embed"),
}


def slstm_state0(cfg, batch, device=None):
    d_inner, H, dh = xlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda: torch.zeros((batch, H, dh), **f32)  # noqa: E731
    return (z(), z(), torch.full((batch, H, dh), _M0, **f32), z())  # c,n,m,h


def _slstm_scan(wx, r_g, state0):
    """wx: (B,S,4*d_inner) input-side gate preactivations; returns h
    (B,S,H,dh) and the final (c, n, m, h)."""
    B, S, _ = wx.shape
    H, dh, _ = r_g.shape
    wx = wx.float()
    c, n, m, h = state0                           # (B,H,dh) each
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hdg->bhg", h, r_g)    # (B,H,4*dh)
        g = wx[:, t].reshape(B, 4, H, dh).permute(0, 2, 1, 3)  # (B,H,4,dh)
        pre = g + rec.reshape(B, H, 4, dh)
        li, lf = pre[..., 0, :], F.logsigmoid(pre[..., 1, :])
        zt, ot = torch.tanh(pre[..., 2, :]), torch.sigmoid(pre[..., 3, :])
        m_new = torch.maximum(lf + m, li)
        ig = torch.exp(li - m_new)
        fg = torch.exp(lf + m - m_new)
        c = fg * c + ig * zt
        n = torch.clamp(fg * n + ig, min=1e-6)
        h = ot * (c / n)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1), (c, n, m, h)       # (B,S,H,dh)


def apply_slstm(cfg, p, x, rules, state0=None, return_state=False):
    B, S, E = x.shape
    d_inner, H, dh = xlstm_dims(cfg)
    up = x @ p["w_up"]
    xs_, z = up.chunk(2, dim=-1)
    xs_ = rules.constrain(xs_, "batch", "seq", "act_ff")
    wx = xs_.float() @ p["w_g"] + p["b_g"]
    if state0 is None:
        state0 = slstm_state0(cfg, B, x.device)
    h, state = _slstm_scan(wx, p["r_g"], state0)
    out = _post(p, h.reshape(B, S, d_inner), z, x)
    if return_state:
        return out, state
    return out


def decode_slstm(cfg, p, x, state, rules):
    """x: (B,E); single-step sLSTM: (out (B,E), new state)."""
    out, new_state = apply_slstm(cfg, p, x[:, None, :], rules,
                                 state0=state, return_state=True)
    return out[:, 0], new_state
