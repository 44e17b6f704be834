"""Mamba2 (SSD) block: chunked-scan prefill form + single-token decode form
(the port's copy of the reference's `models/mamba2.py`).

Chunked state-space dual form (Dao & Gu 2024): the sequence is processed in
chunks of `ssm_chunk`; within a chunk the quadratic masked-decay form runs
as batched matmuls, between chunks a Python loop carries the (B,H,P,N)
state (the reference's `lax.scan`). All decays are computed in log space,
in f32.

The reference's three-operand einsums are written here as explicit
two-operand contractions on f32 operands, so that the contraction order
(and its rounding) does not depend on whether `opt_einsum` is installed,
and no (B,H,Q,K,P) intermediate is built. Decode writes the new SSM state
and conv tails into its cache in place and returns it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init, dtype_of, param


def mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = min(64, d_inner)                     # head dim
    H = d_inner // P
    return d_inner, H, P, cfg.ssm_state


def softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0) (`F.softplus` switches to x above
    20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def init_mamba(cfg, generator):
    dt = dtype_of(cfg)
    E = cfg.d_model
    d_inner, H, P, N = mamba_dims(cfg)
    dev = generator.device
    # the reference's deterministic numpy draw, repeated exactly
    dt_init = np.log(np.expm1(np.exp(np.random.RandomState(0).uniform(
        np.log(1e-3), np.log(1e-1), size=(H,)))))
    f32 = dict(dtype=torch.float32, device=dev)
    return nn.ParameterDict({
        "w_z": dense_init(generator, E, (E, d_inner), dt),
        "w_x": dense_init(generator, E, (E, d_inner), dt),
        "w_B": dense_init(generator, E, (E, N), dt),
        "w_C": dense_init(generator, E, (E, N), dt),
        "w_dt": dense_init(generator, E, (E, H), dt),
        "dt_bias": param(torch.as_tensor(dt_init, **f32)),
        "A_log": param(torch.zeros(H, **f32)),
        "D": param(torch.ones(H, **f32)),
        "conv_x": dense_init(generator, cfg.ssm_conv,
                             (cfg.ssm_conv, d_inner), dt),
        "conv_B": dense_init(generator, cfg.ssm_conv, (cfg.ssm_conv, N), dt),
        "conv_C": dense_init(generator, cfg.ssm_conv, (cfg.ssm_conv, N), dt),
        "norm": param(torch.zeros(d_inner, dtype=dt, device=dev)),
        "w_out": dense_init(generator, d_inner, (d_inner, E), dt),
    })


MAMBA_SPECS = {
    "w_z": ("w_embed", "ff"), "w_x": ("w_embed", "ff"),
    "w_B": ("w_embed", None), "w_C": ("w_embed", None),
    "w_dt": ("w_embed", None), "dt_bias": (None,), "A_log": (None,),
    "D": (None,), "conv_x": (None, "ff"), "conv_B": (None, None),
    "conv_C": (None, None), "norm": ("ff",), "w_out": ("ff", "w_embed"),
}


def _causal_conv(x, w):
    """x: (B,S,C), w: (k,C) depthwise causal conv as k shifted adds."""
    k = w.shape[0]
    out = x * w[-1]
    for i in range(1, k):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[k - 1 - i]
    return out


def _gated_rmsnorm(y, z, scale, eps=1e-5):
    y = y * F.silu(z.float())
    var = y.square().mean(-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _ssd_chunked(xdt, a, Bm, Cm, chunk, state0=None):
    """Chunked SSD scan.

    xdt: (B,S,H,P) inputs pre-multiplied by dt; a: (B,S,H) log-decay dt*A;
    Bm/Cm: (B,S,N). Returns y: (B,S,H,P) (f32) and final state (B,H,P,N)."""
    B_, S, H, P = xdt.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    tril = torch.ones((Q, Q), dtype=torch.bool, device=xdt.device).tril()
    state = state0 if state0 is not None else torch.zeros(
        (B_, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for c in range(0, S, Q):
        x_c = xdt[:, c:c + Q].float().transpose(1, 2)          # (B,H,Q,P)
        a_cs = a[:, c:c + Q].float().transpose(1, 2).cumsum(-1)  # (B,H,Q)
        B_c = Bm[:, c:c + Q].float()                           # (B,Q,N)
        C_c = Cm[:, c:c + Q].float()
        # intra-chunk masked decay. The exponent is masked to -inf above the
        # diagonal before exp (where it is positive and may overflow): the
        # same values as the reference's where-after-exp, and no inf left
        # for a backward pass to turn into NaN.
        diff = a_cs[..., :, None] - a_cs[..., None, :]         # (B,H,Q,K)
        L = torch.exp(torch.where(tril, diff, float("-inf")))
        scores = C_c @ B_c.transpose(1, 2)                     # (B,Q,K)
        y_diag = (scores[:, None] * L) @ x_c                   # (B,H,Q,P)
        # contribution of the carried-in state
        y_off = (C_c[:, None] @ state.transpose(-1, -2)) \
            * torch.exp(a_cs)[..., None]                       # (B,H,Q,P)
        # new state
        decay_in = torch.exp(a_cs[..., -1:] - a_cs)            # (B,H,Q)
        chunk_state = (x_c * decay_in[..., None]).transpose(-1, -2) \
            @ B_c[:, None]                                     # (B,H,P,N)
        state = state * torch.exp(a_cs[..., -1])[..., None, None] \
            + chunk_state
        ys.append((y_diag + y_off).transpose(1, 2))            # (B,Q,H,P)
    return torch.cat(ys, 1), state


def apply_mamba(cfg, p, x, rules, state0=None, return_state=False,
                return_cache=False):
    """Prefill form. x: (B,S,E) -> (B,S,E).

    return_cache: also return a decode-compatible cache (final SSM state +
    conv input tails), for prefill-then-serve."""
    d_inner, H, P, N = mamba_dims(cfg)
    z = x @ p["w_z"]
    xc_in = x @ p["w_x"]
    bc_in = x @ p["w_B"]
    cc_in = x @ p["w_C"]
    xi = F.silu(_causal_conv(xc_in, p["conv_x"]))
    xi = rules.constrain(xi, "batch", "seq", "act_ff")
    Bm = F.silu(_causal_conv(bc_in, p["conv_B"]))
    Cm = F.silu(_causal_conv(cc_in, p["conv_C"]))
    dt = softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                # (H,) negative
    B_, S, _ = x.shape
    xh = xi.reshape(B_, S, H, P)
    xdt = xh * dt[..., None].to(xh.dtype)       # dt cast down, as the reference
    a = dt * A                                                # (B,S,H) log decay
    y, state = _ssd_chunked(xdt, a, Bm, Cm, cfg.ssm_chunk, state0)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = _gated_rmsnorm(y.reshape(B_, S, d_inner), z, p["norm"])
    out = y.to(x.dtype) @ p["w_out"]
    if return_cache:
        t = cfg.ssm_conv - 1
        cache = {"state": state, "conv_x": xc_in[:, -t:].clone(),
                 "conv_B": bc_in[:, -t:].clone(),
                 "conv_C": cc_in[:, -t:].clone()}
        return out, cache
    if return_state:
        return out, state
    return out


def init_mamba_cache(cfg, batch, dtype=torch.float32, device=None):
    d_inner, H, P, N = mamba_dims(cfg)
    k = cfg.ssm_conv
    z = lambda shape, dt: torch.zeros(shape, dtype=dt,  # noqa: E731
                                      device=device)
    return {
        "state": z((batch, H, P, N), torch.float32),
        "conv_x": z((batch, k - 1, d_inner), dtype),
        "conv_B": z((batch, k - 1, N), dtype),
        "conv_C": z((batch, k - 1, N), dtype),
    }


def decode_mamba(cfg, p, x, cache, rules):
    """Single-token step. x: (B,E); cache from `init_mamba_cache` or
    `apply_mamba(return_cache=True)`, written in place (state and conv
    tails, each keeping its dtype) and returned: (out (B,E), cache)."""
    d_inner, H, P, N = mamba_dims(cfg)

    def conv_step(name, xt, w):
        hist = cache[name]                                    # (B,k-1,C)
        dt_ = torch.promote_types(hist.dtype, xt.dtype)
        buf = torch.cat([hist.to(dt_), xt.to(dt_)[:, None]], 1)   # (B,k,C)
        out = torch.einsum("bkc,kc->bc", buf, w.to(dt_))
        hist.copy_(buf[:, 1:])
        return out

    z = x @ p["w_z"]
    xi = F.silu(conv_step("conv_x", x @ p["w_x"], p["conv_x"]))
    Bm = F.silu(conv_step("conv_B", x @ p["w_B"], p["conv_B"]))
    Cm = F.silu(conv_step("conv_C", x @ p["w_C"], p["conv_C"]))
    dt = softplus((x @ p["w_dt"]).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    B_ = x.shape[0]
    xh = xi.reshape(B_, H, P).float()
    da = torch.exp(dt * A)                                     # (B,H)
    state = cache["state"]
    state.mul_(da[..., None, None]).add_(
        (dt[..., None] * xh)[..., None] * Bm.float()[:, None, None, :])
    y = (state @ Cm.float()[:, None, :, None])[..., 0]         # (B,H,P)
    y = y + p["D"][None, :, None] * xh
    y = _gated_rmsnorm(y.reshape(B_, d_inner), z, p["norm"])
    out = y.to(x.dtype) @ p["w_out"]
    return out, cache
