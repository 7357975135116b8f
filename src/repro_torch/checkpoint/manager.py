"""Checkpoint save / restore in the reference's on-disk format.

Counterpart of ``repro/checkpoint/manager.py``.  Layout::

    <dir>/step_<N>/
        manifest.json          shapes, dtypes, per-leaf sha256, metadata
        <leaf-id>.<shard>.npy  one file per shard of a sharded leaf, with
                               its index in the manifest (one file for a
                               tensor; the reference writes one per
                               addressable shard; both are read)

A tree is nested dicts of torch tensors or numpy arrays; a
leaf's path joins its keys with ``/`` (``params/layers/attn/wq``), as the
reference's ``_leaf_paths`` does, and restore finds each leaf of the
tree it is given by that path.  So a checkpoint written by either
package restores in the other (``checkpoint.layout`` gives the model's
parameters and optimizer state in the reference's stacked layout).

  * **atomic commit**: written to ``step_<N>.tmp``, then renamed; a
    killed writer never leaves a half checkpoint that restore would pick;
  * **async**: ``save_async`` copies the tree to the host before it
    returns (training goes on updating its tensors in place), and the
    file I/O runs on a writer thread;
  * **integrity**: a sha256 per leaf over its global bytes, checked on
    restore (``verify=True``);
  * **elastic restore**: the manifest stores global shapes; restore
    reassembles each leaf from its shard files and, given ``shardings``,
    shards it onto the current mesh (``runtime.sharding.ShardedTensor``)
    — a checkpoint written from a (2, 2) mesh restarts on (4, 1) or on
    one device unchanged.  Without shardings a leaf lands on ``device``,
    by default the card; there is no quiet fallback to the host
    (``device="cpu"`` asks for it).

bf16 has no numpy dtype here (the reference's comes with JAX's
``ml_dtypes``).  As the reference does, a bf16 leaf is stored widened to
f32 (lossless) under dtype ``"bfloat16"``, and its hash is over the bf16
bytes (``t.view(torch.int16)``); restore narrows it back to
``torch.bfloat16``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading

import numpy as np
import torch

from ..runtime.sharding import ShardedTensor

_SEP = "."
_BF16 = "bfloat16"


def _leaf_paths(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in
                _leaf_paths(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def _map_leaves(fn, tree, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def _digest(t: torch.Tensor) -> str:
    """sha256 over the tensor's bytes (bf16: its 2-byte words)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _on_host(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.from_numpy(np.asarray(leaf, order="C"))


def _storable(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return _BF16 if t.dtype == torch.bfloat16 else str(t.numpy().dtype)


def save_pytree(tree, directory: str | os.PathLike, step: int,
                extra_meta: dict | None = None) -> pathlib.Path:
    """Synchronous save with atomic rename-commit."""
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = _leaf_paths(tree)
    manifest = {"step": step, "format": 1,
                "treedef": f"nested dicts, {len(leaves)} leaves by path",
                "extra": extra_meta or {}, "leaves": {}}
    for lid, (path, leaf) in enumerate(leaves):
        if isinstance(leaf, ShardedTensor) and leaf.sharding is not None:
            shards = []
            for si, (blk, index) in enumerate(zip(leaf.shards,
                                                  leaf.indices())):
                fname = f"{lid:05d}{_SEP}{si:04d}.npy"
                np.save(tmp / fname, _storable(blk.detach().cpu()))
                shards.append({"file": fname, "index": index})
            t = leaf.full("cpu").detach()
        else:
            if isinstance(leaf, ShardedTensor):
                leaf = leaf.shards[0]
            t = _on_host(leaf)
            fname = f"{lid:05d}{_SEP}0000.npy"
            np.save(tmp / fname, _storable(t))
            shards = [{"file": fname, "index": None}]
        manifest["leaves"][path] = {
            "id": lid, "shape": list(t.shape), "dtype": _dtype_name(t),
            "sha256": _digest(t), "shards": shards}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _default_device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to restore onto the CPU")
    return torch.device("cuda")


def _sharding_at(shardings, path: str):
    node = shardings
    for k in path.split("/"):
        if node is None:
            return None
        node = node.get(k) if isinstance(node, dict) else None
    return node


def restore_pytree(tree_like, directory: str | os.PathLike, step: int,
                   shardings=None, verify: bool = True, device=None):
    """Restore onto the structure of ``tree_like`` (leaves with a
    ``shape``: tensors, ``meta`` tensors, arrays or ``ShardedTensor``s;
    shapes checked), in the checkpoint's dtypes.  ``shardings``: a tree
    of ``NamedSharding`` (or None) leaves keyed as ``tree_like``; a leaf
    with one comes back as a ``ShardedTensor`` on that mesh, every other
    leaf as a tensor on ``device`` (default: the card; raises without
    one)."""
    directory = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((directory / "manifest.json").read_text())
    if shardings is None:
        device = _default_device(device)

    def load(path, like):
        meta = manifest["leaves"].get(path)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        shape = tuple(meta["shape"])
        if tuple(like.shape) != shape:
            raise ValueError(f"{path}: shape {shape} != {tuple(like.shape)}")
        bf16 = meta["dtype"] == _BF16
        g = np.zeros(shape, dtype=np.float32 if bf16 else meta["dtype"])
        for sh in meta["shards"]:
            data = np.load(directory / sh["file"])
            if sh["index"] is None:
                g = data
            else:      # the reference's per-shard files of a jax.Array
                g[tuple(slice(a, b) for a, b in sh["index"])] = data
        t = torch.from_numpy(np.asarray(g, order="C"))
        if bf16:
            t = t.to(torch.bfloat16)
        if verify and _digest(t) != meta["sha256"]:
            raise IOError(f"{path}: checksum mismatch")
        sh = _sharding_at(shardings, path)
        if sh is not None:
            return ShardedTensor.of(t, sh)
        return t.to(_default_device(device))

    return _map_leaves(load, tree_like)


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _host_copy(path, leaf):
    if isinstance(leaf, ShardedTensor):
        return ShardedTensor([b.detach().to("cpu", copy=True)
                              for b in leaf.shards], leaf.sharding)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class CheckpointManager:
    """Async checkpointing with bounded retention."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, tree, step: int, extra_meta: dict | None = None):
        self.wait()  # one in flight at a time
        # Copy to the host before returning: the train step updates its
        # parameters and moments in place, so a writer thread reading the
        # live tensors would save a later step's values.
        snapshot = _map_leaves(_host_copy, tree)

        def _write(tree=snapshot, step=step):
            try:
                save_pytree(tree, self.directory, step, extra_meta)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save_sync(self, tree, step: int, extra_meta: dict | None = None):
        self.wait()
        save_pytree(tree, self.directory, step, extra_meta)
        self._gc()

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def restore_latest(self, tree_like, shardings=None, device=None):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore_pytree(tree_like, self.directory, step, shardings,
                              device=device), step
