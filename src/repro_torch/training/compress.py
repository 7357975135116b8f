"""int8 gradient compression with error feedback for the data-parallel
reduction.

Counterpart of ``repro/training/compress.py``.  Compressing gradients to
int8 with blockwise scales cuts the cross-shard traffic 4× (2× against
bf16); error feedback keeps the residual of each quantisation step and
adds it back before the next one, preserving convergence.

Over a mesh axis of n shards (one process, PR 24's execution model): each
shard computes its gradient on its slice of the batch, quantises
(gradient + its own residual), the int8 codes and f32 scales are
"all-gathered" (recorded as int8 on the wire), dequantised and averaged.
The reference returns the residuals under ``out_specs=P()`` with
``check_rep=False``: each device keeps its own buffer across calls, and
reading the result gives device 0's.  Here the residuals are a list with
one tree per shard (the first call's made with ``init_error_feedback``
for each shard), which the next call takes back.
"""
from __future__ import annotations

import numpy as np
import torch

from ..runtime import collectives
from .optimizer import dequantize_i8, quantize_i8

F32 = torch.float32


def compress_decompress(g, err):
    """One error-feedback quantisation round trip (per leaf).  Returns
    (the quantised-then-dequantised gradient in g's dtype, the new
    residual in f32)."""
    g32 = g.to(F32) + err
    codes, scales = quantize_i8(g32)
    deq = dequantize_i8(codes, scales, g32.shape)
    return deq.to(g.dtype), g32 - deq


def compressed_psum_grads(grads: list, errors: list):
    """int8-compressed gradient mean over the shards: ``grads[i]`` and
    ``errors[i]`` are shard i's gradient and residual trees (``{name:
    tensor}``).  Returns (the mean gradient on shard 0's device, the new
    residual of each shard)."""
    n = len(grads)
    mean, new_err = {}, [{} for _ in range(n)]
    for k in grads[0]:
        codes, scales = [], []
        for i in range(n):
            g32 = grads[i][k].to(F32) + errors[i][k].to(grads[i][k].device)
            c, s = quantize_i8(g32)
            new_err[i][k] = g32 - dequantize_i8(c, s, g32.shape)
            codes.append(c)
            scales.append(s)
        dev, shape = grads[0][k].device, grads[0][k].shape
        all_codes = torch.stack([c.to(dev) for c in codes])  # int8 wire
        all_scales = torch.stack([s.to(dev) for s in scales])
        collectives.record("all-gather", all_codes, n)
        collectives.record("all-gather", all_scales, n)
        deq = torch.stack([dequantize_i8(c, s, shape)
                           for c, s in zip(all_codes, all_scales)])
        mean[k] = (deq.sum(dim=0) / n).to(grads[0][k].dtype)
    return mean, new_err


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def _axis_devices(mesh, axis: str) -> list:
    """One device per index of ``axis``: the first mesh device there."""
    i = mesh.axis_names.index(axis)
    arr = np.moveaxis(mesh.devices, i, 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def _split(tree, n: int, i: int):
    """Slice ``i`` of ``n`` along the leading dim of every leaf."""
    if isinstance(tree, dict):
        return {k: _split(v, n, i) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_split(v, n, i) for v in tree)
    b = tree.shape[0] // n
    return tree[i * b:(i + 1) * b]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def make_compressed_dp_grad_fn(loss_fn, mesh, axis: str = "data"):
    """Explicit-DP gradient with int8-compressed cross-shard reduction.

    ``loss_fn(params, batch) -> scalar`` (``params`` a dict of tensors).
    Returns ``grad_fn(params, batch, errors) -> (loss_mean, grads_mean,
    new_errors)`` with the parameters replicated, the batch split over
    ``axis`` of ``mesh`` (a ``runtime.sharding.DeviceMesh``), and
    ``errors`` the list of one residual tree per shard (the list an
    earlier call returned)."""
    devs = _axis_devices(mesh, axis)
    n = len(devs)

    def grad_fn(params: dict, batch, errors: list):
        if len(errors) != n:
            raise ValueError(f"{len(errors)} residual trees for {n} shards")
        losses, grads = [], []
        for i, dev in enumerate(devs):
            p = {k: v.detach().to(dev).requires_grad_(True)
                 for k, v in params.items()}
            loss = loss_fn(p, _to(_split(batch, n, i), dev))
            g = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True, materialize_grads=True)
            losses.append(loss.detach().to(devs[0]))
            grads.append(dict(zip(p, g)))
        mean, new_err = compressed_psum_grads(grads, errors)
        return torch.stack(losses).mean(), mean, new_err
    return grad_fn
