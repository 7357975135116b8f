"""Train-step assembly: loss -> gradients -> clip -> AdamW update, plus the
sharding specs of the optimizer state and the train step over a mesh.

Counterpart of ``repro/training/step.py``.  The gradients are
``torch.autograd.grad`` of ``models.transformer.train_loss``: nothing
accumulates into ``.grad``.

Over a mesh (``par.mesh`` set) the parameters and moments are
:class:`~repro_torch.runtime.sharding.ShardedTensor`s under
``param_specs`` / ``opt_specs`` (a :class:`ShardedModel`).  The step
gathers every leaf onto the device of each group of data rows that share
one (the FSDP gather), runs ``train_loss`` on the group's slices of the
batch with the group's sub-mesh for the MoE layers, and takes
``torch.autograd.grad`` with respect to the gathered leaves; the
gradients (summed in f32 over groups and microbatches when there are
several) are cut back into blocks (``reduce_scatter``).  The global-norm
clip is a ``psum`` of per-block squares, and AdamW runs block by block —
except on an int8-moment leaf whose last-axis block is not a whole
number of the codec's 256-element blocks, where a shard boundary would
cut a codec block and change its scale: that leaf is updated on its
gathered tensors, as the reference's global update.  The reference's
GSPMD step computes the single-device function whatever the layout, and
so does this one; the whole-model gather is the port's memory schedule
(the reference gathers a layer at a time), not a result.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..checkpoint.layout import stacked_path
from ..models.transformer import Model, decayed_names, train_loss
from ..runtime.sharding import (P, Parallelism, ShardedTensor, NamedSharding,
                                _fits, gather, param_shardings, param_specs,
                                psum, reduce_scatter, single_device)
from .optimizer import (BLOCK, AdamWConfig, _leaf_update,
                        apply_updates, clip_by_global_norm, init_state,
                        schedule)

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
                    grad_accum: int = 1,
                    par: Parallelism | None = None):
    """Returns ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``; the model's parameters and the state are updated in
    place, ``metrics`` holds the 0-d tensors ``loss`` and ``grad_norm``.
    Over a mesh ``model`` is a :class:`ShardedModel` and ``opt_state``
    comes from :func:`init_sharded_state`.

    ``grad_accum`` > 1 splits the batch's leading axis into that many
    microbatches and sums their gradients into a separate f32 tree (the
    reference's scan carry), then divides by ``grad_accum``: bf16
    parameters' gradients are never summed in bf16.  Weight decay takes
    the reference's leaves (``decayed_names``)."""
    par = par or single_device()
    if par.mesh is not None:
        return _mesh_train_step(opt_cfg, clip_norm, grad_accum, par)

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


# ---------------------------------------------------------------------------
# Sharding specs of the optimizer state
# ---------------------------------------------------------------------------


def opt_specs(named: dict, opt_like: dict, par: Parallelism) -> dict:
    """PartitionSpecs for the optimizer state (``{"step", "moments":
    {name: {key: spec}}}``) of parameters ``named``; ``opt_like`` is a
    state of the same shapes (``init_state`` on ``meta`` tensors)."""
    pspecs = param_specs(named, par, stacked_path)
    moments = {}
    for name, st in opt_like["moments"].items():
        ps = pspecs[name]
        out = {}
        for k, leaf in st.items():
            if k in ("m", "v", "m_q", "v_q"):
                out[k] = ps            # codes share the param's shape
            else:
                # block scales: param spec with the last (blocked) dim
                # replaced by the block index (shard only if it divides)
                dims = list(ps)
                dims[-1] = (dims[-1] if _fits(par, dims[-1], leaf.shape[-1])
                            else None)
                out[k] = P(*dims)
        moments[name] = out
    return {"step": P(), "moments": moments}


def opt_shardings(named: dict, opt_like: dict, par: Parallelism):
    if par.mesh is None:
        return None
    specs = opt_specs(named, opt_like, par)
    return {"step": NamedSharding(par.mesh, specs["step"]),
            "moments": {n: {k: NamedSharding(par.mesh, s)
                            for k, s in st.items()}
                        for n, st in specs["moments"].items()}}


# ---------------------------------------------------------------------------
# The model and optimizer state over a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedModel:
    """A model's parameters over a mesh: ``params[name]`` a
    ``ShardedTensor`` under ``param_shardings``; ``model`` the same
    architecture on ``meta`` (its config and parameter names)."""

    model: Model
    params: dict
    par: Parallelism

    @property
    def cfg(self):
        return self.model.cfg

    def skeleton(self) -> dict:
        """{name: meta tensor}: the global shapes and dtypes."""
        return dict(self.model.named_parameters())

    def gathered(self, device=None, receivers=None) -> dict:
        return {k: gather(t.shards, t.sharding, device, receivers)
                for k, t in self.params.items()}

    def full(self, device) -> Model:
        """The unsharded model on ``device`` (a copy)."""
        from ..models.transformer import params_from_numpy, stack_layers

        with torch.no_grad():
            return params_from_numpy(self.cfg, stack_layers(
                self.gathered(device)), device)


def shard_model(model: Model, par: Parallelism) -> ShardedModel:
    """``model``'s parameters sharded over ``par``'s mesh by
    ``param_specs``; ``model`` itself is left as it was."""
    named = dict(model.named_parameters())
    shardings = param_shardings(named, par, stacked_path)
    with torch.no_grad():
        params = {k: ShardedTensor.of(p.detach(), shardings[k])
                  for k, p in named.items()}
    return ShardedModel(Model(model.cfg, device="meta"), params, par)


def sharded_from_tree(cfg, tree: dict, par: Parallelism) -> ShardedModel:
    """A :class:`ShardedModel` from the reference's stacked tree whose
    leaves are ``ShardedTensor``s (a restore with shardings)."""
    from ..models.transformer import unstack_layers

    skel = Model(cfg, device="meta")
    names = [n for n, _ in skel.named_parameters()]
    return ShardedModel(skel, unstack_layers(tree, names), par)


def init_sharded_state(opt_cfg: AdamWConfig, sm: ShardedModel) -> dict:
    """Zero moments, each sharded by :func:`opt_shardings`, on its
    blocks' devices; ``step`` on the mesh's first device."""
    named = sm.skeleton()
    like = init_state(opt_cfg, named)
    shardings = opt_shardings(named, like, sm.par)
    moments = {}
    for name, st in like["moments"].items():
        moments[name] = {}
        for k, t in st.items():
            sh = shardings["moments"][name][k]
            moments[name][k] = ShardedTensor(
                [torch.zeros(sh.shard_shape(t.shape), dtype=t.dtype,
                             device=dev) for dev in sh.devices(t.ndim)], sh)
    first = sm.par.mesh.devices.flat[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=first),
            "moments": moments}


@contextlib.contextmanager
def _bound(model: Model, tensors: dict):
    """``model`` reading ``tensors`` (gathered, with their autograd
    history) in place of its parameters inside the block, the backward
    included (a checkpointed block re-reads them when it recomputes)."""
    slots = []
    for name, t in tensors.items():
        mod, _, leaf = name.rpartition(".")
        sub = model.get_submodule(mod) if mod else model
        slots.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield model
    finally:
        for sub, leaf, old in slots:
            sub._parameters[leaf] = old


def _codec_aligned(t: ShardedTensor) -> bool:
    """True if each block's last axis is a whole number of the int8
    codec's blocks (or the last axis is not sharded)."""
    c = t.sharding.counts(t.ndim)[-1] if t.sharding else 1
    return c == 1 or (t.shape[-1] // c) % BLOCK == 0


def mesh_loss_and_grads(sm: ShardedModel, batch: dict,
                        grad_accum: int = 1):
    """(loss, {name: gradient ``ShardedTensor``}) over ``sm``'s mesh.

    Microbatch ``j`` is rows ``[j·B/a, (j+1)·B/a)`` of the batch and its
    data row ``i`` the i-th of its ``n_data`` equal slices, as the
    reference shards them.  The data rows whose first device is the same
    run as one ``train_loss`` on their slices, with the sub-mesh of those
    rows for the MoE (which splits its batch over them).  A group's loss
    (its MoE aux included) and gradient weigh ``len(rows) / n_data``, so
    groups of unequal size give the mean over all rows, and the loss is
    the mean over microbatches of that.  On one card (or the CPU,
    or ``meta``) every row shares the device: one forward and one backward
    a microbatch, whose gradient is the single-device one.  The gradient
    is cut into the parameters' blocks: in the parameter's dtype when one
    group ran one microbatch (as ``jax.grad`` gives it), else the f32
    mean (the reference's scan carry), cast back for one microbatch."""
    par = sm.par
    devs = par.devices_by_data()
    n_data = par.data_size
    groups: dict = {}
    for i, dev in enumerate(devs[:, 0]):
        groups.setdefault(dev, []).append(i)
    B = next(iter(batch.values())).shape[0]
    n = grad_accum * len(groups)
    if B % (grad_accum * (n_data if len(groups) > 1 else 1)):
        raise ValueError(f"batch {B} does not split into {grad_accum} "
                         f"microbatches over {n_data} data rows")
    mb_size = B // grad_accum
    first = devs[0, 0]
    # The FSDP gather: every leaf whole on each group's device, each
    # device of the mesh receiving it.
    with torch.no_grad():
        full = {dev: {k: v.detach().requires_grad_(True) for k, v in
                      sm.gathered(dev, par.mesh.size).items()}
                for dev in groups}
    loss = torch.zeros((), dtype=F32, device=first)
    acc = None
    for j in range(grad_accum):
        micro = {k: v[j * mb_size:(j + 1) * mb_size]
                 for k, v in batch.items()}
        for dev, rows in groups.items():
            if len(rows) == n_data:
                mb = {k: v.to(dev) for k, v in micro.items()}
            else:
                bl = mb_size // n_data
                mb = {k: torch.cat([v[i * bl:(i + 1) * bl] for i in rows])
                      .to(dev) for k, v in micro.items()}
            leaves = full[dev]
            with _bound(sm.model, leaves):
                loss_g = train_loss(sm.model, mb, par.data_rows(rows))
                g = torch.autograd.grad(loss_g, list(leaves.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            w = len(rows) / n_data
            loss = loss + loss_g.detach().to(first) * w
            if n == 1:
                acc = dict(zip(leaves, g))
            else:
                if acc is None:
                    acc = {k: torch.zeros(t.shape, dtype=F32, device=first)
                           for k, t in sm.params.items()}
                for k, gi in zip(leaves, g):
                    acc[k].add_(gi.to(first, F32), alpha=w)
            del g, loss_g
    del full
    grads = {}
    for k, t in sm.params.items():
        a = acc.pop(k)
        if n > 1:
            a = a.div_(grad_accum)
            a = a if grad_accum > 1 else a.to(t.dtype)
        grads[k] = ShardedTensor(reduce_scatter(a, t.sharding), t.sharding)
        del a
    return loss / grad_accum, grads


def clip_sharded(grads: dict, max_norm: float):
    """``clip_by_global_norm`` over blocks: the norm a ``psum`` of
    per-block squares (a block that devices replicate is stored, and
    counted, once)."""
    norm = torch.sqrt(psum([torch.sum(torch.square(b.to(F32)))
                            for g in grads.values() for b in g.shards]))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: ShardedTensor([(b.to(F32) * scale.to(b.device)).to(b.dtype)
                              for b in g.shards], g.sharding)
            for k, g in grads.items()}, norm


def _mesh_train_step(opt_cfg: AdamWConfig, clip_norm: float,
                     grad_accum: int, par: Parallelism):
    def train_step(sm: ShardedModel, opt_state: dict, batch: dict):
        loss, grads = mesh_loss_and_grads(sm, batch, grad_accum)
        grads, gnorm = clip_sharded(grads, clip_norm)
        apply_sharded_updates(opt_cfg, sm, grads, opt_state)
        return sm, opt_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


@torch.no_grad()
def apply_sharded_updates(cfg: AdamWConfig, sm: ShardedModel, grads: dict,
                          state: dict) -> None:
    """AdamW on the blocks in place (``apply_updates`` per block; an
    int8-moment leaf whose blocks cut the codec's on its gathered
    tensors)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.to(F32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=t.device), t)
    decay = decayed_names(sm.skeleton())
    for name, p in sm.params.items():
        st = state["moments"][name]
        g = grads[name]
        if "m_q" in st and not _codec_aligned(p):
            full = {k: v.full() for k, v in st.items()}
            new_p, new_st = _leaf_update(cfg, lr, bc1, bc2, p.full(),
                                         g.full(), full, name in decay)
            for b, sl in zip(p.shards, p.indices()):
                b.copy_(new_p[tuple(slice(a, z) for a, z in sl)])
            for k, v in new_st.items():
                st[k] = ShardedTensor.of(v, st[k].sharding)
            continue
        for i, b in enumerate(p.shards):
            d = b.device
            new_p, new_st = _leaf_update(
                cfg, lr.to(d), bc1.to(d), bc2.to(d), b, g.shards[i],
                {k: v.shards[i] for k, v in st.items()}, name in decay)
            b.copy_(new_p)
            for k, v in new_st.items():
                st[k].shards[i] = v
    state["step"] = step
