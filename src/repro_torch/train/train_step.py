"""The train step (the port's copy of the reference's
`train/train_step.py`): loss -> grads (with optional microbatch
accumulation and int8-EF gradient compression) -> clipped AdamW update.

The model is the `nn.Module` that carries its parameters, so the step
updates them in place:
  train_step(opt_state, batch) -> (opt_state, metrics)
where the reference's pure step maps (params, opt_state, batch) to new
ones. Every metric is a tensor on the model's device; nothing is read back
to the host inside a step.

Over a mesh (`init_train_state` with rules that have one), the parameters,
moments and masters are DTensors placed by `tree_shardings(rules,
train_state_specs(...))`; the step distributes each batch by its "batch"
placement, runs the model and the update under DTensor's implicit
replication (so positions, masks and scalars mix with DTensors), makes
every gradient whole over its parameter's placement before the clip (a
`Partial` sum reduced) and hands back plain metrics. On a one-device mesh
the state stays plain tensors unless `distribute=True`: every placement
there is trivial, and DTensor dispatch only costs host time.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.distributed.sharding import (
    NULL_RULES, is_dtensor, place_like, tree_map, tree_shardings, whole)
from repro_torch.models.reference_params import specs_by_name
from repro_torch.train import compression as C
from repro_torch.train import optimizer as O


def _split_microbatches(batch, n):
    """Each array of the batch cut along its leading axis into n equal
    parts: a list of n batches."""
    out = [{} for _ in range(n)]
    for k, x in batch.items():
        x = torch.as_tensor(x)
        parts = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
        for i in range(n):
            out[i][k] = parts[i]
    return out


def make_train_step(model, rules, opt_cfg: O.OptConfig, num_microbatches=1,
                    compress_grads=False):
    """The step over `model`'s current parameters: build it after
    `init_train_state` (a later `model.init` replaces them). With
    `num_microbatches` n the batch is cut along its leading axis into n
    parts whose f32 gradients are summed and divided by n, the losses and
    metrics averaged; with `compress_grads` the gradients make the int8
    error-feedback round trip, the residuals kept in
    `opt_state["ef_residual"]`."""
    params = dict(model.named_parameters())
    meshed = any(is_dtensor(p) for p in params.values())

    def scope():
        if not meshed:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication
        return implicit_replication()

    def loss_and_grads(batch):
        for p in params.values():
            p.grad = None
        if meshed:
            batch = _place_batch(batch, rules, model.device)
        with scope():
            loss, metrics = model.loss_fn(batch, rules)
            loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        if meshed:
            # a Partial sum (a replicated weight used on sharded rows)
            # reduced to its parameter's placements
            grads = {n: place_like(g, params[n]) for n, g in grads.items()}
            loss = whole(loss)
            metrics = {k: whole(v) for k, v in metrics.items()}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def compute_grads(batch):
        if num_microbatches == 1:
            return loss_and_grads(batch)
        acc = {n: torch.zeros_like(p, dtype=torch.float32)
               for n, p in params.items()}
        losses, metricses = [], []
        for mbatch in _split_microbatches(batch, num_microbatches):
            loss, metrics, grads = loss_and_grads(mbatch)
            for n, g in grads.items():
                acc[n] += g.float()
            losses.append(loss)
            metricses.append(metrics)
        grads = {n: a / num_microbatches for n, a in acc.items()}
        metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                   for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, grads

    def update(opt_state, metrics, grads):
        if compress_grads:
            grads, residuals = C.compress_grads_ef(
                grads, opt_state["ef_residual"])
        with scope():
            inner, opt_metrics = O.apply_updates(
                opt_cfg, params, {k: v for k, v in opt_state.items()
                                  if k != "ef_residual"}, grads)
        for p in params.values():
            p.grad = None
        new_state = dict(inner)
        if compress_grads:
            new_state["ef_residual"] = residuals
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return new_state, metrics

    def train_step(opt_state, batch):
        _, metrics, grads = compute_grads(batch)
        return update(opt_state, metrics, grads)

    # its two halves, for a profile that times them apart:
    # compute_grads(batch) -> (loss, metrics, grads) and
    # update(opt_state, metrics, grads) -> (opt_state, metrics)
    train_step.compute_grads = compute_grads
    train_step.update = update
    return train_step


def init_train_state(model, opt_cfg: O.OptConfig, generator=None,
                     compress_grads=False, rules=NULL_RULES,
                     distribute=None):
    """Draw the model's parameters anew from `generator` (`model.init`)
    and return `train_state` for them."""
    model.init(generator)
    return train_state(model, opt_cfg, compress_grads, rules, distribute)


def train_state(model, opt_cfg: O.OptConfig, compress_grads=False,
                rules=NULL_RULES, distribute=None):
    """Turn the gradients of the model's current parameters on and return
    the optimizer state for them.

    With rules over a mesh of more than one device (or `distribute=True`
    over any mesh) the parameters and the state become DTensors placed by
    `tree_shardings(rules, train_state_specs(...))`: each rank keeps its
    block of the tensors that every rank holds whole."""
    model.requires_grad_(True)
    if distribute is None:
        distribute = rules.mesh is not None and rules.mesh.size() > 1
    if distribute:
        if rules.mesh is None:
            raise ValueError("distribute=True needs rules over a mesh")
        pspecs, ospecs = train_state_specs(model, opt_cfg, compress_grads)
        place_params(model, tree_shardings(rules, pspecs))
    params = dict(model.named_parameters())
    opt_state = O.init_opt_state(opt_cfg, params)
    if compress_grads:
        opt_state["ef_residual"] = C.init_residuals(params)
    if distribute:
        opt_state = place_tree(opt_state, tree_shardings(rules, ospecs))
    return opt_state


def place_params(model, shardings):
    """Replace each parameter of `model` by a DTensor with its placements
    (`shardings`: {parameter name: Placements}); it keeps its name and
    `requires_grad`."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        new = nn.Parameter(shardings[name].place(p.detach()),
                           requires_grad=p.requires_grad)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = new
        else:
            setattr(mod, leaf, new)


def place_tree(tree, shardings):
    """Every tensor of `tree` with at least one dim placed by its entry of
    `shardings` (a 0-d leaf, the step counter, stays a plain tensor: it is
    replicated either way)."""
    return tree_map(lambda t, sh: sh.place(t) if t.ndim else t,
                    tree, shardings)


def _place_batch(batch, rules, device):
    """The batch's arrays as DTensors, each split by its "batch"
    placement (every rank holds the same global batch)."""
    out = {}
    for k, x in batch.items():
        x = torch.as_tensor(x, device=device)
        out[k] = rules.sharding("batch", *([None] * (x.ndim - 1))).place(x)
    return out


def train_state_specs(model, opt_cfg: O.OptConfig, compress_grads=False):
    """(param specs, opt-state specs), each keyed by parameter name as the
    state is: the model's stacked specs split across its layer lists
    (`models.reference_params.specs_by_name`)."""
    pspecs = specs_by_name(model)
    ospecs = O.opt_state_specs(pspecs, opt_cfg.quantize_state)
    if compress_grads:
        ospecs["ef_residual"] = pspecs
    return pspecs, ospecs
