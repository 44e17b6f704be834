"""Hand-rolled AdamW with optional 8-bit first moment (row-quantized) and
f32 master weights (the port's copy of the reference's
`train/optimizer.py`). No `torch.optim`: the state layout must be keyed by
the logical sharding rules and checkpointable by `repro_torch.ckpt`.

State layout (a dict keyed like the parameters, by parameter name):
  master : f32 master copy of the (bf16) params, a clone even for an f32
           param (the reference's `copy=True`: a master that aliased its
           parameter would be updated twice)
  m      : first moment  — f32, or {"codes": int8, "scale": f32} if quantized
  v      : second moment — f32, or bf16 if quantized ("8-bit Adam" profile)
  step   : 0-d int32 tensor on the parameters' device

`apply_updates` updates the state in place and casts each new master into
its parameter with `copy_`; nothing in a step reads a value back to the
host. Over a mesh every leaf is a DTensor and keeps its placements; the
row-wise scales of the 8-bit moment are DTensor reductions over whole
rows, so they equal the unsharded run's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import place_like, whole
from repro_torch.train import compression as C


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantize_state: bool = False     # 8-bit m / bf16 v (memory compression)


def schedule(cfg: OptConfig, step):
    """Linear warmup + cosine decay to min_lr_frac. step: an integer tensor
    (on any device) -> the f32 learning rate, a tensor on the same
    device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: OptConfig, params):
    """params: {name: tensor} -> the state above, on the params' devices."""
    def init_m(p):
        if cfg.quantize_state:
            return {"codes": torch.zeros(p.shape, dtype=torch.int8,
                                         device=p.device),
                    "scale": torch.full(p.shape[:-1], 1e-12,
                                        dtype=torch.float32,
                                        device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init_v(p):
        dt = torch.bfloat16 if cfg.quantize_state else torch.float32
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = next(iter(params.values())).device
    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
        "m": {n: init_m(p) for n, p in params.items()},
        "v": {n: init_v(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree):
    """tree: {name: tensor} -> the f32 L2 norm over every element. A
    DTensor's sum of squares (a `Partial` sum over its shards) is made whole
    before the sum, so the norm is a plain tensor, the same on every
    rank."""
    return torch.sqrt(sum(whole(x.float().square().sum())
                          for x in tree.values()))


def clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, gn


def _is_m_leaf(x):
    return isinstance(x, dict) and "codes" in x


def apply_updates(cfg: OptConfig, params, opt_state, grads):
    """One AdamW step. params: {name: tensor}, the module's parameters,
    each overwritten in place with its new master cast to its dtype;
    opt_state is updated in place. Returns (opt_state, {"grad_norm",
    "lr"}), both metrics tensors on the device.

    The clip is the reference's `clip_by_global_norm` (the gradient times
    the scale cast to its dtype), applied one leaf at a time so that no
    clipped copy of every gradient is held at once."""
    gn = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    masters, ms, vs = opt_state["master"], opt_state["m"], opt_state["v"]
    with torch.no_grad():
        for name, p_master in masters.items():
            g = grads[name]
            g32 = (g * clip.to(g.dtype)).float()
            m = ms[name]
            quantized = _is_m_leaf(m)
            m_val = (C.dequantize_rowwise_int8(m["codes"], m["scale"])
                     if quantized else m)
            m_new = b1 * m_val + (1 - b1) * g32
            v_new = b2 * vs[name].float() + (1 - b2) * torch.square(g32)
            # each f32 temporary goes as soon as it is spent: on a large
            # leaf (a 394 M embedding) one is 1.6 GB
            del g32, m_val
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            new_master = p_master - lr * (delta + cfg.weight_decay
                                          * p_master)
            del delta
            masters[name] = new_master
            if quantized:
                codes, scale = C.quantize_rowwise_int8(m_new)
                ms[name] = {"codes": place_like(codes, m["codes"]),
                            "scale": place_like(scale, m["scale"])}
                vs[name] = v_new.to(torch.bfloat16)
            else:
                ms[name], vs[name] = m_new, v_new
            params[name].copy_(new_master)
    opt_state["step"] = step
    return opt_state, {"grad_norm": gn, "lr": lr}


def opt_state_specs(param_specs, quantize_state=False):
    """Logical-axis specs for the optimizer state (mirrors init_opt_state);
    param_specs: {name: tuple of logical axes}.

    Quantized m codes keep the tensor shape -> inherit the param spec; the
    per-row scales drop the last axis."""
    if quantize_state:
        m = {n: {"codes": t, "scale": t[:-1]} for n, t in param_specs.items()}
    else:
        m = dict(param_specs)
    return {"master": dict(param_specs), "m": m, "v": dict(param_specs),
            "step": ()}
