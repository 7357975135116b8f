"""Parallelism descriptor, parameter sharding rules (name → PartitionSpec)
and the mesh's gather and sum.

Counterpart of ``repro/runtime/sharding.py``.  Mesh layout
(``launch/mesh.py``):
  single-pod: (data=16, model=16)          — 256 devices
  multi-pod:  (pod=2, data=16, model=16)   — 512 devices

Mapping, as the reference's:
  * batch  → ('pod', 'data')   (DP)
  * TP     → 'model'           (heads / d_ff / vocab)
  * FSDP   → 'data'            (params + optimizer state sharded over the
                                data axis, gathered for the compute)
  * EP     → 'model'           (MoE experts; see models/moe.py)

Execution model.  A mesh is one process over an array of
``torch.device``s with named axes: shards sit round robin on the visible
cards, or all on one given device (``"cpu"`` in the tests, ``"meta"`` in
the dry run).  A sharded leaf is kept as its distinct blocks only
(:func:`shard`): a block that several devices replicate is stored once,
on the first of them.  :func:`gather` concatenates the blocks into the
global tensor (``torch.cat``, so differentiable), :func:`reduce_scatter`
cuts a summed gradient back into blocks, and :func:`psum` is an f32 sum
on the first operand's device.  Each records its bytes in
``runtime.collectives``.

The port's parameters are named per layer (``"layers.3.attn.wq"``); the
rules are keyed on the reference's stacked paths (``layers/attn/wq`` with
a leading layer dim).  :func:`param_specs` takes the caller's map from
a name to its path (``checkpoint.layout.stacked_path`` for the port's
names) and drops the leading ``None`` of a stacked spec for a per-layer
leaf; this module knows nothing of the model's naming.
:meth:`Parallelism.constrain` is the identity: in the reference it is a
layout hint to GSPMD, which computes the single-device function whatever
the layout.
"""
from __future__ import annotations

import dataclasses
import itertools
import re

import numpy as np
import torch

from . import collectives


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dim, each None
    (replicated), an axis name or a tuple of axis names."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """``jax.sharding.Mesh``: an ndarray of ``torch.device``s, one axis
    per name.  ``shape`` maps each axis name to its size, as the
    reference's ``mesh.shape`` reads."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(shape: tuple, axis_names: tuple, devices) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (a list, reused round robin)."""
    n = int(np.prod(shape))
    arr = np.empty(n, dtype=object)
    for i in range(n):
        arr[i] = torch.device(devices[i % len(devices)])
    return DeviceMesh(arr.reshape(shape), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Parallelism:
    """Everything a model needs to know about the mesh.  mesh=None means
    single-device execution — every sharding becomes a no-op."""

    mesh: DeviceMesh | None = None
    data_axes: tuple = ("data",)       # batch axes, e.g. ("pod", "data")
    model_axis: str = "model"
    fsdp_axis: str | None = "data"     # None disables ZeRO-3 param sharding

    @property
    def data_spec(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.model_axis] if self.mesh else 1

    @property
    def data_size(self) -> int:
        if not self.mesh:
            return 1
        n = 1
        for a in self.data_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def all_axes(self) -> tuple:
        return tuple(self.data_axes) + (self.model_axis,)

    def constrain(self, x, *spec):
        """The identity (a layout hint in the reference)."""
        return x

    def sharding(self, *spec) -> "NamedSharding | None":
        return None if self.mesh is None else NamedSharding(self.mesh,
                                                            P(*spec))

    def devices_by_data(self) -> np.ndarray:
        """The mesh's devices as a (data_size, model_size) array (the model
        axis is the last of every mesh ``launch/mesh.py`` makes)."""
        return self.mesh.devices.reshape(self.data_size, self.model_size)

    def data_rows(self, rows) -> "Parallelism":
        """The sub-mesh of the data indices ``rows`` (the last data axis
        of size ``len(rows)``, the others of size 1)."""
        sub = self.devices_by_data()[list(rows)].reshape(
            (1,) * (len(self.data_axes) - 1) + (len(rows), self.model_size))
        return dataclasses.replace(
            self, mesh=DeviceMesh(sub, self.all_axes))


def single_device() -> Parallelism:
    return Parallelism(mesh=None)


# ---------------------------------------------------------------------------
# A sharding: which block of a global tensor lives where.
# ---------------------------------------------------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec.  The distinct
    blocks of a tensor are numbered row-major over the sharded dims."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def counts(self, ndim: int) -> tuple:
        """The number of blocks along each dim."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return tuple(int(np.prod([self.mesh.shape[a] for a in _axes(e)]))
                     for e in spec)

    def shard_shape(self, shape) -> tuple:
        counts = self.counts(len(shape))
        for s, c in zip(shape, counts):
            if s % c:
                raise ValueError(f"dim {s} does not divide into {c} shards")
        return tuple(s // c for s, c in zip(shape, counts))

    def indices(self, shape) -> list:
        """Per block, its slice of the global tensor as [[start, stop]]."""
        counts = self.counts(len(shape))
        sub = self.shard_shape(shape)
        return [[[j * b, (j + 1) * b] for j, b in zip(idx, sub)]
                for idx in itertools.product(*(range(c) for c in counts))]

    def devices(self, ndim: int) -> list:
        """Per block, the first mesh device holding it."""
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        names = self.mesh.axis_names
        counts = self.counts(ndim)
        out = {}
        for pos in itertools.product(*(range(s) for s in
                                       self.mesh.devices.shape)):
            coord = dict(zip(names, pos))
            idx = []
            for e in spec:
                j = 0
                for a in _axes(e):
                    j = j * self.mesh.shape[a] + coord[a]
                idx.append(j)
            out.setdefault(tuple(idx), self.mesh.devices[pos])
        return [out[idx] for idx in
                itertools.product(*(range(c) for c in counts))]


def shard(t: torch.Tensor, sharding: NamedSharding | None) -> list:
    """The distinct blocks of ``t`` under ``sharding``, each a contiguous
    copy on its device (``[t]`` when there is no sharding)."""
    if sharding is None:
        return [t]
    out = []
    for sl, dev in zip(sharding.indices(t.shape),
                       sharding.devices(t.ndim)):
        out.append(t[tuple(slice(a, b) for a, b in sl)]
                   .to(dev, copy=True).contiguous())
    return out


def _cat(blocks: list, counts: tuple, dim: int):
    if dim == len(counts):
        return blocks[0]
    n = counts[dim]
    per = len(blocks) // n
    parts = [_cat(blocks[i * per:(i + 1) * per], counts, dim + 1)
             for i in range(n)]
    return parts[0] if n == 1 else torch.cat(parts, dim)


def gather(shards: list, sharding: NamedSharding | None, device=None,
           receivers: int | None = None) -> torch.Tensor:
    """The global tensor from its blocks, on ``device`` (default: the
    first block's): ``torch.cat`` along every sharded dim, so it is
    differentiable.  ``receivers``: how many devices receive the result
    (default: every device of the mesh), for the collective's bytes."""
    if sharding is None:
        return shards[0] if device is None else shards[0].to(device)
    device = shards[0].device if device is None else torch.device(device)
    out = _cat([b.to(device) for b in shards],
               sharding.counts(shards[0].ndim), 0)
    if len(shards) > 1:
        collectives.record("all-gather", out,
                           receivers or sharding.mesh.size)
    return out


def reduce_scatter(full: torch.Tensor, sharding: NamedSharding | None,
                   receivers: int | None = None) -> list:
    """The blocks of ``full`` (a gradient already summed over the
    replicas), each a contiguous copy on its device: the reduce-scatter
    half of FSDP."""
    blocks = shard(full, sharding)
    if len(blocks) > 1:
        collectives.record("reduce-scatter", full,
                           receivers or sharding.mesh.size)
    return blocks


def psum(parts: list, receivers: int | None = None) -> torch.Tensor:
    """``lax.psum``: the f32 sum of ``parts`` on the first part's
    device."""
    dev = parts[0].device
    out = parts[0].to(torch.float32)
    for p in parts[1:]:
        out = out + p.to(dev, torch.float32)
    if len(parts) > 1:
        collectives.record("all-reduce", out, receivers or len(parts))
    return out


class ShardedTensor:
    """A global tensor held as its distinct blocks under ``sharding``
    (None: one block, the whole tensor)."""

    def __init__(self, shards: list, sharding: NamedSharding | None):
        self.shards = list(shards)
        self.sharding = sharding

    @classmethod
    def of(cls, t: torch.Tensor, sharding) -> "ShardedTensor":
        return cls(shard(t, sharding), sharding)

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    @property
    def shape(self) -> tuple:
        if self.sharding is None:
            return tuple(self.shards[0].shape)
        return tuple(s * c for s, c in zip(self.shards[0].shape,
                                           self.sharding.counts(self.ndim)))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def indices(self) -> list:
        if self.sharding is None:
            return [None]
        return self.sharding.indices(self.shape)

    def full(self, device=None) -> torch.Tensor:
        return gather(self.shards, self.sharding, device)

    def __getitem__(self, i: int) -> "ShardedTensor":
        """Row ``i`` of a leaf whose first dim is not sharded (a stacked
        leaf's layer)."""
        if self.sharding is None:
            return ShardedTensor([self.shards[0][i]], None)
        assert self.sharding.counts(self.ndim)[0] == 1
        return ShardedTensor([b[i] for b in self.shards], NamedSharding(
            self.sharding.mesh, P(*tuple(self.sharding.spec)[1:])))

    @staticmethod
    def stack(rows: list) -> "ShardedTensor":
        """The inverse of indexing: the rows stacked on a new unsharded
        first dim."""
        sh = rows[0].sharding
        return ShardedTensor(
            [torch.stack([r.shards[b] for r in rows])
             for b in range(len(rows[0].shards))],
            None if sh is None else NamedSharding(
                sh.mesh, P(None, *tuple(sh.spec))))


# ---------------------------------------------------------------------------
# Param path → PartitionSpec rules (verbatim from the reference).
#
# Paths are '/'-joined key paths into the reference's param tree, WITHOUT
# the leading stacked-layer index dim (rules below prepend None for
# stacked leaves).
# ---------------------------------------------------------------------------

_FSDP = "__FSDP__"    # placeholder replaced by the fsdp axis (or None)
_TP = "__TP__"        # placeholder replaced by the model axis

# (regex, spec-per-dim) — first match wins.  Specs are for the UNSTACKED
# leaf; stacked leaves get None prepended for the layer dim.
_RULES = [
    # embeddings / unembedding
    (r"embed/table$",            (_TP, _FSDP)),         # (V, d)
    (r"lm_head$",                (_FSDP, _TP)),         # (d, V)
    # attention
    (r"attn/wq$",                (_FSDP, _TP)),         # (d, H·Dh)
    (r"attn/wk$",                (_FSDP, _TP)),
    (r"attn/wv$",                (_FSDP, _TP)),
    (r"attn/wo$",                (_TP, _FSDP)),         # (H·Dh, d)
    (r"attn/(q|k)_norm$",        (None,)),
    # cross-attention (same shapes)
    (r"cross/wq$",               (_FSDP, _TP)),
    (r"cross/wk$",               (_FSDP, _TP)),
    (r"cross/wv$",               (_FSDP, _TP)),
    (r"cross/wo$",               (_TP, _FSDP)),
    (r"cross/(q|k)_norm$",       (None,)),
    # dense MLP
    (r"mlp/w_gate$",             (_FSDP, _TP)),
    (r"mlp/w_up$",               (_FSDP, _TP)),
    (r"mlp/w_down$",             (_TP, _FSDP)),
    (r"mlp/w_in$",               (_FSDP, _TP)),
    (r"mlp/w_out$",              (_TP, _FSDP)),
    # MoE — expert-parallel mode: experts over model axis
    (r"moe_ep/router$",          (_FSDP, None)),        # (d, E)
    (r"moe_ep/w_gate$",          (_TP, _FSDP, None)),   # (E, d, F)
    (r"moe_ep/w_up$",            (_TP, _FSDP, None)),
    (r"moe_ep/w_down$",          (_TP, None, _FSDP)),   # (E, F, d)
    # MoE — tensor-parallel mode: d_ff over model axis
    (r"moe_tp/router$",          (_FSDP, None)),
    (r"moe_tp/w_gate$",          (None, _FSDP, _TP)),
    (r"moe_tp/w_up$",            (None, _FSDP, _TP)),
    (r"moe_tp/w_down$",          (None, _TP, _FSDP)),
    # Mamba2
    (r"ssm/in_proj$",            (_FSDP, None)),        # (d, proj) mixed out
    (r"ssm/conv_w$",             (None, _TP)),          # (k, conv_dim)
    (r"ssm/conv_b$",             (_TP,)),
    (r"ssm/A_log$",              (_TP,)),               # (H,)
    (r"ssm/D$",                  (_TP,)),
    (r"ssm/dt_bias$",            (_TP,)),
    (r"ssm/norm$",               (_TP,)),               # (d_inner,)
    (r"ssm/out_proj$",           (_TP, _FSDP)),         # (d_inner, d)
    # norms and everything residual-width
    (r"(norm|scale|final_norm)$", (None,)),
]

# Leaves under these top-level keys are layer-stacked (leading L dim).
STACKED_PREFIXES = ("layers/", "cross_layers/", "encoder/", "groups/")


def _fits(parallel: Parallelism, axis, dim_size: int) -> bool:
    """Drop axes that don't divide (pjit's in_shardings demand it)."""
    if axis is None or parallel.mesh is None:
        return True
    axes = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in axes:
        n *= parallel.mesh.shape[a]
    return dim_size % n == 0


def spec_for(path: str, shape, parallel: Parallelism) -> P:
    """PartitionSpec for a param leaf at '/'-joined ``path``."""
    ndim = len(shape)
    stacked = path.startswith(STACKED_PREFIXES)
    base = path
    for pre in STACKED_PREFIXES:
        if base.startswith(pre):
            base = base[len(pre):]
    for rx, spec in _RULES:
        if re.search(rx, base):
            dims = [parallel.model_axis if s == _TP
                    else (parallel.fsdp_axis if s == _FSDP else s)
                    for s in spec]
            if stacked:
                dims = [None] + dims
            if len(dims) < ndim:      # trailing unsharded dims
                dims = dims + [None] * (ndim - len(dims))
            assert len(dims) == ndim, (path, dims, ndim)
            dims = [d if _fits(parallel, d, shape[i]) else None
                    for i, d in enumerate(dims)]
            return P(*dims)
    return P(*([None] * ndim))        # default: replicated


def param_specs(named: dict, parallel: Parallelism, path_of=None) -> dict:
    """{name: PartitionSpec} for ``{name: tensor}`` (``meta`` tensors do).
    A name is the '/'-joined path the rules are keyed on, as the
    reference's tree paths are, unless ``path_of(name)`` gives ``(path,
    row)``: ``row`` true for one layer's row of a stacked leaf, whose
    spec is the stacked one with the layer dim dropped."""
    out = {}
    for k, t in named.items():
        path, row = (k, False) if path_of is None else path_of(k)
        shape = tuple(t.shape)
        out[k] = (P(*spec_for(path, (1,) + shape, parallel)[1:]) if row
                  else spec_for(path, shape, parallel))
    return out


def param_shardings(named: dict, parallel: Parallelism,
                    path_of=None) -> dict | None:
    if parallel.mesh is None:
        return None
    return {k: NamedSharding(parallel.mesh, s)
            for k, s in param_specs(named, parallel, path_of).items()}
