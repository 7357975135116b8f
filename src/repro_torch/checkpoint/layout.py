"""The port's training state in the reference's checkpoint layout.

A checkpoint holds ``{"params", "opt"}`` as the reference's trees: each
per-layer parameter (``"layers.3.attn.wq"``) is a row of a stacked
``(L, ...)`` leaf, and so are its moments.  Blocks of the int8 codec tile
only the last axis, so stacked codes and scales are the reference's.
Over a mesh the leaves are ``runtime.sharding.ShardedTensor``s, stacked
block by block; they are written one file per shard, as the reference
writes a sharded array.
"""
from __future__ import annotations

import torch

from ..models.transformer import (Model, _layer_split, stack_layers,
                                  unstack_layers)
from ..runtime.sharding import ShardedTensor


def stacked_path(name: str) -> tuple:
    """A port parameter's name -> (the '/'-joined path of its leaf in the
    reference's tree, whether the name is one layer's row of that
    stacked leaf): ``"layers.3.attn.wq"`` -> ``("layers/attn/wq",
    True)``; the ``path_of`` of ``runtime.sharding.param_specs``."""
    path, layer = _layer_split(name)
    return "/".join(path), layer is not None


def params_to_tree(model) -> dict:
    """The parameters in the reference's ``init_params`` layout, in their
    own dtypes: on the host for a ``Model``, sharded as they are for a
    ``training.step.ShardedModel``."""
    if not isinstance(model, Model):
        return stack_layers(dict(model.params))
    return stack_layers({n: p.detach().cpu()
                         for n, p in model.named_parameters()})


def _host(t):
    return t if isinstance(t, ShardedTensor) else t.detach().cpu()


def state_to_tree(state: dict) -> dict:
    """The optimizer state in the reference's layout (tensors on the
    host; ``ShardedTensor``s as they are)."""
    flat = {f"{name}.{k}": _host(t)
            for name, st in state["moments"].items() for k, t in st.items()}
    return {"step": state["step"].detach().cpu(),
            "moments": stack_layers(flat)}


def state_from_tree(tree: dict, like: dict) -> dict:
    """The inverse of :func:`state_to_tree`: ``like`` is a state of the
    same model and config (``optimizer.init_state``, or
    ``training.step.init_sharded_state``), whose keys and devices the
    result takes; a restored ``ShardedTensor`` is taken as it is."""
    moments = {}
    for name, st in like["moments"].items():
        got = unstack_layers(tree["moments"], [f"{name}.{k}" for k in st])
        moments[name] = {
            k: (got[f"{name}.{k}"] if isinstance(t, ShardedTensor) else
                got[f"{name}.{k}"].to(t.device, copy=True).contiguous())
            for k, t in st.items()}
    return {"step": torch.as_tensor(tree["step"]).to(like["step"].device,
                                                      torch.int32),
            "moments": moments}


def _meta(t: ShardedTensor) -> ShardedTensor:
    return ShardedTensor([torch.empty(b.shape, dtype=b.dtype, device="meta")
                          for b in t.shards], t.sharding)


def sharded_checkpoint_like(sm, state: dict) -> tuple:
    """(tree_like, shardings) to restore a checkpoint onto ``sm``'s mesh
    and ``state``'s layout: ``meta`` tensors of the global shapes, and
    the stacked leaves' shardings (None for ``step``)."""
    params = stack_layers({n: _meta(t) for n, t in sm.params.items()})
    moments = stack_layers({f"{name}.{k}": _meta(t)
                            for name, st in state["moments"].items()
                            for k, t in st.items()})

    def like(tree):
        return {k: like(v) if isinstance(v, dict) else
                torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in tree.items()}

    def shardings(tree):
        return {k: shardings(v) if isinstance(v, dict) else v.sharding
                for k, v in tree.items()}

    return ({"params": like(params),
             "opt": {"step": torch.empty((), dtype=torch.int32,
                                         device="meta"),
                     "moments": like(moments)}},
            {"params": shardings(params),
             "opt": {"step": None, "moments": shardings(moments)}})
