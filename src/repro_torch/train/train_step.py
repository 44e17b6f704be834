"""The train step (the port's copy of the reference's
`train/train_step.py`): loss -> grads (with optional microbatch
accumulation and int8-EF gradient compression) -> clipped AdamW update.

The model is the `nn.Module` that carries its parameters, so the step
updates them in place:
  train_step(opt_state, batch) -> (opt_state, metrics)
where the reference's pure step maps (params, opt_state, batch) to new
ones. Every metric is a tensor on the model's device; nothing is read back
to the host inside a step.
"""
from __future__ import annotations

import torch

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

    def loss_and_grads(batch):
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss_fn(batch, rules)
        loss.backward()
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                {n: p.grad for n, p in params.items()})

    def compute_grads(batch):
        if num_microbatches == 1:
            return loss_and_grads(batch)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
                     compress_grads=False):
    """Draw the model's parameters anew from `generator` (`model.init`),
    turn their gradients on, and return the optimizer state for them."""
    model.init(generator)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt_state = O.init_opt_state(opt_cfg, params)
    if compress_grads:
        opt_state["ef_residual"] = C.init_residuals(params)
    return opt_state


def train_state_specs(model, opt_cfg: O.OptConfig, compress_grads=False):
    """(param specs, opt-state specs), each keyed by parameter name as the
    state is: the model's stacked specs split across its layer lists
    (`models.reference_params.specs_by_name`)."""
    pspecs = specs_by_name(model)
    ospecs = O.opt_state_specs(pspecs, opt_cfg.quantize_state)
    if compress_grads:
        ospecs["ef_residual"] = pspecs
    return pspecs, ospecs
