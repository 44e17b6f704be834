"""Compression utilities for distributed optimization (the port's copy of
the reference's `train/compression.py`).

Two distinct mechanisms:

1. Gradient wire compression. `quantize_ef` / `dequantize_block_int8`
   implement int8 block quantization with ERROR FEEDBACK (the residual is
   carried and re-added next step), the standard convergence-preserving
   trick for a compressed all-reduce payload.
2. Optimizer-state memory compression (8-bit Adam first moment, bf16
   second moment, row-wise scales): `quantize_rowwise_int8`.

A tree of the reference is a dict keyed by parameter name here. Both
frameworks round half to even (`jnp.round`, `torch.round`), so the int8
codes equal the reference's on the same inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, place_like

BLOCK = 256


def _pad_to_block(flat):
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat, pad


def quantize_block_int8(x):
    """x: any shape f32/bf16 -> (int8 codes (n_blocks, BLOCK), f32 block
    scales (n_blocks,)), the tensor flattened and zero-padded to BLOCK."""
    flat = x.float().reshape(-1)
    flat, _ = _pad_to_block(flat)
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127)
    return codes.to(torch.int8), scale[:, 0]


def dequantize_block_int8(codes, scale, shape):
    flat = (codes.float() * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def quantize_rowwise_int8(x):
    """Per-row (last-dim) int8 quantization that PRESERVES SHAPE: codes
    inherit the tensor's sharding spec (used for optimizer moments)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_rowwise_int8(codes, scale):
    return codes.float() * scale[..., None]


def quantize_ef(grad, residual):
    """Error-feedback int8 quantization of one gradient tensor.

    Returns (codes, scale, new_residual). dequantize(codes) + new_residual
    == grad + residual (up to float error)."""
    g = grad.float() + residual
    codes, scale = quantize_block_int8(g)
    deq = dequantize_block_int8(codes, scale, g.shape)
    return codes, scale, g - deq


def compress_grads_ef(grads, residuals):
    """Error-feedback int8 round trip of every gradient (emulating the
    compressed all-reduce payload). grads, residuals: {name: tensor}.
    Returns (dequantized f32 grads, new residuals), both keyed as grads."""
    out_g, out_r = {}, {}
    for name, g in grads.items():
        r = residuals[name]
        if is_dtensor(g):
            # the blocks of 256 are those of the whole flattened tensor, as
            # in the reference's one jitted step: gather the leaf whole,
            # quantize it there and keep this rank's block of the results
            # (one whole leaf live at a time)
            out_g[name], out_r[name] = _ef_whole(g, place_like(r, g))
            continue
        codes, scale, out_r[name] = quantize_ef(g, r)
        out_g[name] = dequantize_block_int8(codes, scale, g.shape)
    return out_g, out_r


def _ef_whole(g, r):
    """`quantize_ef` of a DTensor gradient and residual on the whole
    tensor: (dequantized gradient, new residual), both placed as `g`."""
    from torch.distributed.tensor import DTensor, Replicate
    codes, scale, res = quantize_ef(g.full_tensor(), r.full_tensor())
    deq = dequantize_block_int8(codes, scale, g.shape)
    whole_pl = [Replicate()] * g.device_mesh.ndim

    def back(t):
        # Replicate -> Shard keeps a local block: no communication
        return DTensor.from_local(t, g.device_mesh, whole_pl,
                                  run_check=False).redistribute(
            g.device_mesh, g.placements)

    return back(deq), back(res)


def init_residuals(params):
    """params: {name: tensor} -> {name: f32 zeros of its shape} (of its
    placements, for a DTensor)."""
    return {name: torch.zeros_like(p, dtype=torch.float32,
                                   requires_grad=False)
            for name, p in params.items()}
