"""Cost of a program from its aten operations, run on ``meta`` tensors.

Counterpart of ``repro/runtime/jaxpr_cost.py``, which walks a jaxpr.
PyTorch has no jaxpr: :func:`op_cost` runs ``fn`` eagerly with every
tensor argument moved to the ``meta`` device (shapes and dtypes only,
nothing allocated or computed) under two dispatch modes, and returns the
same :class:`Cost`:

  * ``flops`` (global): the matmul-like operations' FLOPs from
    ``torch.utils.flop_counter.FlopCounterMode`` (2·M·K·N for a matmul),
    plus one FLOP per output element of every other operation that is
    not materialising, as the reference counts elementwise and layout
    operations (views, which move nothing, count none).
  * ``bytes`` (global HBM traffic estimate): the operand and result
    bytes of the *materialising* operations, by the reference's rule —
    matmuls, gathers and scatters, sorts, concatenations, cumulative
    sums and reductions; elementwise operations are assumed fused — plus
    the program's inputs and outputs once.
  * ``collective_bytes`` (global): what the mesh's gathers and sums
    record (``runtime.collectives``), the weighted ring traffic summed
    over the receiving devices.

The reference multiplies a ``scan`` body by its trip count and a
``shard_map`` body by its device count.  Here an eager Python loop (the
layers, the attention chunks, the microbatches, the shards) is traced
whole, so no multiplier is needed.  ``Cost.ops`` keeps the trace (the
aten op names), which ``collectives.count_op`` reads.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from . import collectives


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    ops: list = dataclasses.field(default_factory=list, repr=False,
                                  compare=False)


_DOTLIKE = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot",
            "convolution", "_scaled_dot_product_efficient_attention",
            "_scaled_dot_product_flash_attention",
            "_scaled_dot_product_cudnn_attention"}
_MATERIALIZING = {"index", "index_select", "gather", "scatter",
                  "scatter_add", "scatter_reduce", "index_add",
                  "index_put", "index_put_", "index_add_", "embedding",
                  "embedding_dense_backward", "sort", "argsort", "topk",
                  "cat", "stack", "cumsum", "logcumsumexp", "sum", "amax",
                  "amin", "max", "min", "mean", "logsumexp", "arange",
                  "bincount", "repeat_interleave", "nonzero"}
# Metadata only: no element is produced.
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_strided",
         "_local_scalar_dense", "set", "resize"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _signature(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    return x if isinstance(x, (int, float, bool, str, type(None),
                               torch.dtype, torch.device,
                               torch.memory_format, torch.layout)) else id(x)


def _fresh(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_fresh(v) for v in x)
    return x


class _ByteCounter(TorchDispatchMode):
    """Bytes of the materialising operations, elementwise FLOPs, and the
    trace of op names.  On ``meta`` an operation's output depends only on
    its inputs' shapes, strides and dtypes and its other arguments, so a
    functional (not in-place, not a view) operation seen before gets
    fresh tensors of the remembered layout instead of running its meta
    kernel again."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.seen: dict = {}

    def _run(self, func, args, kwargs):
        if func.is_view or func._schema.is_mutable or any(
                r.alias_info is not None for r in func._schema.returns):
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        if key not in self.seen:
            self.seen[key] = func(*args, **kwargs)
        return _fresh(self.seen[key])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins, _ = tree_flatten((args, kwargs))
        on_meta = all(t.device.type == "meta" for t in ins
                      if isinstance(t, torch.Tensor))
        out = (self._run(func, args, kwargs) if on_meta
               else func(*args, **kwargs))
        name = func.overloadpacket.__name__
        self.cost.ops.append(f"aten.{name}")
        base = name.rstrip("_")
        if base in _DOTLIKE or base in _MATERIALIZING or \
                name in _MATERIALIZING:   # (a dot's FLOPs: FlopCounterMode)
            outs, _ = tree_flatten(out)
            self.cost.bytes += sum(map(_nbytes, ins)) + \
                sum(map(_nbytes, outs))
        elif not (func.is_view or base in _FREE):
            outs, _ = tree_flatten(out)
            self.cost.flops += sum(t.numel() for t in outs
                                   if isinstance(t, torch.Tensor))
        return out


def _to_meta(obj):
    if isinstance(obj, torch.Tensor):
        return torch.empty(obj.shape, dtype=obj.dtype, device="meta")
    if isinstance(obj, dict):
        return {k: _to_meta(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_meta(v) for v in obj)
    return obj


def _leaf_bytes(obj) -> int:
    """Tensor bytes in nested dicts / lists, sharded tensors and modules."""
    if isinstance(obj, torch.Tensor):
        return _nbytes(obj)
    if isinstance(obj, dict):
        return sum(_leaf_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_leaf_bytes(v) for v in obj)
    if isinstance(obj, torch.nn.Module):
        return sum(_nbytes(p) for p in obj.parameters())
    if hasattr(obj, "shards"):
        return sum(_nbytes(b) for b in obj.shards)
    if hasattr(obj, "params") and isinstance(obj.params, dict):
        return _leaf_bytes(obj.params)
    return 0


def op_cost(fn, *args, **kwargs) -> Cost:
    """Cost of ``fn(*args, **kwargs)`` — global totals.  Tensor arguments
    (in dicts, lists and tuples) are moved to ``meta``; a module or a
    sharded model must already be there."""
    args, kwargs = _to_meta(args), _to_meta(kwargs)
    cost = Cost()
    flop_mode = FlopCounterMode(display=False)
    # FlopCounterMode on top: it sees every operation before the byte
    # counter answers it
    with collectives.recording() as coll, _ByteCounter(cost), flop_mode:
        out = fn(*args, **kwargs)
    cost.flops += float(flop_mode.get_total_flops())
    cost.collective_bytes = coll.total_bytes
    # program inputs/outputs cross HBM once
    cost.bytes += _leaf_bytes((args, kwargs)) + _leaf_bytes(out)
    return cost
