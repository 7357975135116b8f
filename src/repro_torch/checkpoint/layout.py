"""The port's training state in the reference's checkpoint layout.

A checkpoint holds ``{"params", "opt"}`` as the reference's trees: each
per-layer parameter (``"layers.3.attn.wq"``) is a row of a stacked
``(L, ...)`` leaf, and so are its moments.  Blocks of the int8 codec tile
only the last axis, so stacked codes and scales are the reference's.
"""
from __future__ import annotations

import torch

from ..models.transformer import Model, stack_layers, unstack_layers


def params_to_tree(model: Model) -> dict:
    """The parameters on the host in the reference's ``init_params``
    layout, in their own dtypes."""
    return stack_layers({n: p.detach().cpu()
                         for n, p in model.named_parameters()})


def state_to_tree(state: dict) -> dict:
    """The optimizer state on the host in the reference's layout."""
    flat = {f"{name}.{k}": t.detach().cpu()
            for name, st in state["moments"].items() for k, t in st.items()}
    return {"step": state["step"].detach().cpu(),
            "moments": stack_layers(flat)}


def state_from_tree(tree: dict, like: dict) -> dict:
    """The inverse of :func:`state_to_tree`: ``like`` is a state of the
    same model and config (``optimizer.init_state``), whose keys and
    devices the result takes."""
    moments = {}
    for name, st in like["moments"].items():
        got = unstack_layers(tree["moments"], [f"{name}.{k}" for k in st])
        moments[name] = {k: got[f"{name}.{k}"].to(t.device, copy=True)
                         .contiguous() for k, t in st.items()}
    return {"step": torch.as_tensor(tree["step"]).to(like["step"].device,
                                                      torch.int32),
            "moments": moments}
