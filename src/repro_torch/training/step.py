"""Train-step assembly: loss -> gradients -> clip -> AdamW update.

Counterpart of ``repro/training/step.py::make_train_step`` (its
single-device half; the optimizer state's sharding specs, ``opt_specs``
and ``opt_shardings``, come with the device mesh, ROADMAP.md queue 1
item 11c).  The gradients are ``torch.autograd.grad`` of
``models.transformer.train_loss``: nothing accumulates into ``.grad``.
"""
from __future__ import annotations

import torch

from ..models.transformer import Model, decayed_names, train_loss
from .optimizer import AdamWConfig, apply_updates, clip_by_global_norm

F32 = torch.float32


def trainable(model: Model) -> dict:
    """The model's parameters by name, made trainable (the serving path
    registers them with ``requires_grad=False``)."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def loss_and_grads(model: Model, params: dict, batch: dict):
    """(loss, {name: gradient in the parameter's dtype}).  A parameter
    the batch does not reach (an expert no token chose) gets zeros, as
    ``jax.grad`` gives it."""
    loss = train_loss(model, batch)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(params, grads))


def make_train_step(opt_cfg: AdamWConfig, clip_norm: float = 1.0,
                    grad_accum: int = 1):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; the model's parameters and the state are updated in
    place, ``metrics`` holds the 0-d tensors ``loss`` and ``grad_norm``.

    ``grad_accum`` > 1 splits the batch's leading axis into that many
    microbatches and sums their gradients into a separate f32 tree (the
    reference's scan carry), then divides by ``grad_accum``: bf16
    parameters' gradients are never summed in bf16.  Weight decay takes
    the reference's leaves (``decayed_names``)."""

    def train_step(model: Model, opt_state: dict, batch: dict):
        params = trainable(model)
        if grad_accum == 1:
            loss, grads = loss_and_grads(model, params, batch)
        else:
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            dev = next(iter(params.values())).device
            loss = torch.zeros((), dtype=F32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                     for k, p in params.items()}
            for i in range(grad_accum):
                mb = {k: v[i] for k, v in micro.items()}
                loss_i, grads_i = loss_and_grads(model, params, mb)
                loss = loss + loss_i
                for k, g in grads_i.items():
                    grads[k].add_(g.to(F32))
                del grads_i
            loss = loss / grad_accum
            for g in grads.values():
                g.div_(grad_accum)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        apply_updates(opt_cfg, params, grads, opt_state,
                      decayed_names(params))
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step
