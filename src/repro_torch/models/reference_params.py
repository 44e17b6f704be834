"""Carry the JAX reference's parameters into a port model (port only).

The reference's `model.init(key)` is a tree of nested dicts whose stacked
groups ("layers"; "enc" and "dec" for the encoder-decoder; "mlstm" and
"slstm" for the xLSTM) hold every layer's leaf on a leading layer axis,
nested dicts inside a layer included (the hybrid's `layers.mamba.*`); an
unstacked group (the hybrid's `shared` block) is one layer's dict. The
port keeps the same leaf names and layouts, with each stacked group an
`nn.ModuleList`, so loading is a copy by name: split the layer axis across
the list and cast to the dtype of the port's parameter (the model's dtype;
f32 where the reference keeps f32 in any model: the MoE router, Mamba's
`dt_bias`, `A_log` and `D`, the mLSTM's `w_if` / `b_if`, the sLSTM's `w_g`,
`r_g` and `b_g`). Random streams differ between the frameworks, so this is
how a port model is held against the reference on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _as_array(a):
    a = np.asarray(a)
    if a.dtype.kind not in "fiub":      # e.g. ml_dtypes' bfloat16
        a = a.astype(np.float32)
    return a


def load_reference_params(model: nn.Module, tree: dict) -> nn.Module:
    """Copy `tree` (nested dicts of numpy arrays, the reference's parameter
    tree) into `model` in place. Raises ValueError on a leaf missing from
    the tree, a leaf the model lacks, a layer count or a shape that does not
    match. Returns the model."""
    stacked = {name for name, m in model.named_children()
               if isinstance(m, nn.ModuleList)}
    params = dict(model.named_parameters())
    want = {}          # port parameter name -> array
    for path, a in _flatten(tree):
        a = _as_array(a)
        rest = ".".join(path[1:])
        if path[0] in stacked:
            n = len(getattr(model, path[0]))
            if a.ndim == 0 or a.shape[0] != n:
                raise ValueError(f"{'.'.join(path)}: {a.shape} has no "
                                 f"leading axis of {n} layers")
            for i in range(n):
                want[f"{path[0]}.{i}.{rest}"] = a[i]
        else:
            want[".".join(path)] = a
    missing = sorted(set(params) - set(want))
    extra = sorted(set(want) - set(params))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing from the "
                         f"reference tree {missing}, not in the model "
                         f"{extra}")
    for name, a in want.items():
        if tuple(a.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: reference {tuple(a.shape)}, model "
                             f"{tuple(params[name].shape)}")
    with torch.no_grad():
        for name, a in want.items():
            p = params[name]
            p.copy_(torch.tensor(a))       # copy_ casts to p's dtype
    return model
