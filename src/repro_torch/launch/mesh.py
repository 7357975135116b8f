"""Production and test meshes.

Counterpart of ``repro/launch/mesh.py``.  Functions, never module-level
constants, so that importing this module touches no device.  Like
``jax.make_mesh`` the production meshes need as many devices as they
have positions (256 or 512 cards); with ``device="meta"``, as the dry
run passes, every position is a ``meta`` device and nothing is
allocated.  The test mesh places its data·model positions round robin
on the visible cards, or all on ``device``.
"""
from __future__ import annotations

import torch

from ..runtime.sharding import Parallelism, make_mesh


def _devices(device) -> list:
    if device is not None:
        return [torch.device(device)]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to place the mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    devs = _devices(device)
    if device is None and len(devs) < n:
        raise RuntimeError(f"the {shape} mesh needs {n} devices, "
                           f"{len(devs)} are visible (device='meta' builds "
                           f"it for the dry run)")
    return make_mesh(shape, axes, devs)


def make_parallelism(*, multi_pod: bool = False, fsdp: bool = True,
                     device=None) -> Parallelism:
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    return Parallelism(
        mesh=mesh,
        data_axes=("pod", "data") if multi_pod else ("data",),
        model_axis="model",
        fsdp_axis="data" if fsdp else None,
    )


def make_test_parallelism(data: int = 2, model: int = 2,
                          fsdp: bool = True, device=None) -> Parallelism:
    """A small (data, model) mesh: positions round robin on the cards, or
    all on ``device``.  Raises without a card unless ``device`` is given."""
    mesh = make_mesh((data, model), ("data", "model"),
                     _devices(device))
    return Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                       fsdp_axis="data" if fsdp else None)
