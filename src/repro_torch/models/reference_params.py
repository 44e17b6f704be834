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
`to_reference_tree` goes the other way for anything keyed by parameter
name (gradients, optimizer masters and moments), so tests compare them
leaf by leaf; `specs_by_name` splits the stacked sharding specs by the
same rule.
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


def _stacked(model):
    """The model's stacked groups: {name of an `nn.ModuleList` child: its
    layer count}."""
    return {name: len(m) for name, m in model.named_children()
            if isinstance(m, nn.ModuleList)}


def _by_name(model, tree, take):
    """{port parameter name: leaf} of a tree in the reference's layout: a
    stacked group's leaf yields one entry a layer, `take(leaf, i, n,
    dotted path)` for layer i of n; any other leaf keeps its joined path as
    its name."""
    stacked = _stacked(model)
    out = {}
    for path, leaf in _flatten(tree):
        rest = ".".join(path[1:])
        if path[0] in stacked:
            n = stacked[path[0]]
            for i in range(n):
                out[f"{path[0]}.{i}.{rest}"] = take(leaf, i, n,
                                                    ".".join(path))
        else:
            out[".".join(path)] = leaf
    return out


def _layer_of(a, i, n, name):
    if a.ndim == 0 or a.shape[0] != n:
        raise ValueError(f"{name}: {a.shape} has no leading axis of {n} "
                         f"layers")
    return a[i]


def load_reference_params(model: nn.Module, tree: dict) -> nn.Module:
    """Copy `tree` (nested dicts of numpy arrays, the reference's parameter
    tree) into `model` in place. Raises ValueError on a leaf missing from
    the tree, a leaf the model lacks, a layer count or a shape that does not
    match. Returns the model."""
    params = dict(model.named_parameters())
    want = {name: _as_array(a)
            for name, a in _by_name(model, tree, _layer_of).items()}
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


def specs_by_name(model: nn.Module) -> dict:
    """{parameter name: tuple of logical axes}: `model.param_specs()` (the
    reference's stacked specs) split across the layer lists by the rule
    `load_reference_params` uses, each stacked spec losing its leading
    layer axis."""
    return _by_name(model, model.param_specs(),
                    lambda spec, i, n, name: tuple(spec[1:]))


def _host(t) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16
        t = t.float()
    return t.numpy()


def to_reference_tree(model: nn.Module, values: dict) -> dict:
    """The inverse of `load_reference_params`' naming: `values`, {parameter
    name: tensor, or a dict of tensors such as a quantized moment's
    {"codes", "scale"}} (gradients, masters, moments), as nested dicts of
    numpy arrays in the reference's layout, each stacked group's layers
    stacked on a leading axis (bf16 as f32). Raises ValueError when a
    stacked group misses a layer."""
    stacked = _stacked(model)
    tree, layers = {}, {}
    for name, v in values.items():
        parts = tuple(name.split("."))
        subs = v.items() if isinstance(v, dict) else [((), v)]
        for sub, t in subs:
            sub = (sub,) if sub else ()
            if parts[0] in stacked:
                path = (parts[0],) + parts[2:] + sub
                layers.setdefault(path, {})[int(parts[1])] = _host(t)
            else:
                _put(tree, parts + sub, _host(t))
    for path, per in layers.items():
        n = stacked[path[0]]
        if sorted(per) != list(range(n)):
            raise ValueError(f"{'.'.join(path)}: layers {sorted(per)}, the "
                             f"model has {n}")
        _put(tree, path, np.stack([per[i] for i in range(n)]))
    return tree


def _put(tree, path, leaf):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf
