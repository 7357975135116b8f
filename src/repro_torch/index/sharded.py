"""Per-shard persistence for the distributed engine.

Counterpart of ``repro/index/sharded.py``; the on-disk format is the
same, so a sharded store written by either package loads in the other,
and the same index saves byte-identical in both.  One store directory
per shard, each holding exactly the arrays its shard owns, written from
that shard's own ``DeviceIndex`` and loaded back onto its mesh device —
no global array is assembled in either direction::

    <dir>/
      manifest.json    {kind, shards, levels, alphabet, n_valid, size, n}
      shard_00000/     store.py dir: series, norms_sq, words_N*, resid_N*
      shard_00001/     ...

Each ``shard_*/`` is itself a valid columnar store (checksummed,
atomically committed); the root directory is committed with the same
write-to-tmp + rename protocol.  The tiered kind
(``fastsax-tiered-sharded``) carries each shard's quantized screen
columns next to its slice of the raw series.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from . import store
from ..core import representation as repr_registry
from ..core.representation import DEFAULT_STACK

MANIFEST = store.MANIFEST
_KIND = "fastsax-index-sharded"
_TIERED_KIND = "fastsax-tiered-sharded"


def _index_stack(index) -> tuple:
    return tuple(getattr(index, "stack", DEFAULT_STACK))


def _check_stack(manifest: dict, path) -> tuple:
    """Loud failure when a manifest's level stack names a representation
    this process has not registered."""
    stack = tuple(manifest.get("stack", DEFAULT_STACK))
    known = set(repr_registry.registered_names())
    unknown = [name for name in stack if name not in known]
    if unknown:
        raise IOError(
            f"{path}: manifest level stack {list(stack)} names "
            f"unregistered representation(s) {unknown} — this reader "
            f"knows {sorted(known)}")
    return stack


def _host(t: torch.Tensor) -> np.ndarray:
    """A device column as its stored host array: bf16 as its uint16 bit
    pattern, the rest in its own dtype."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _device_leaves(index) -> dict:
    """DeviceIndex -> {leaf name: host array} (store.py's per-level
    layout)."""
    leaves = {"series": index.series, "norms_sq": index.norms_sq}
    extra = getattr(index, "extra", ())
    for li, (N, w, r) in enumerate(zip(index.levels, index.words,
                                       index.residuals)):
        leaves[f"words_N{N}"] = w
        leaves[f"resid_N{N}"] = r
        for name, col in (extra[li] if extra else {}).items():
            prefix = repr_registry.get(name).column.prefix
            leaves[f"{prefix}_N{N}"] = col
    return {name: _host(t) for name, t in leaves.items()}


def store_sharded(index, path: str | os.PathLike, n_valid: int | None = None,
                  extra_meta: dict | None = None) -> pathlib.Path:
    """Persist a ``dist_search.ShardedDeviceIndex`` (or one
    ``DeviceIndex``, as one shard), one dir per shard, each written from
    its own shard's tensors.  ``n_valid`` defaults to the index's (all
    rows for a plain index)."""
    path = pathlib.Path(path)
    shards = tuple(getattr(index, "shards", (index,)))
    B = sum(int(s.size) for s in shards)
    if n_valid is None:
        n_valid = getattr(index, "n_valid", B)
    P_sh = len(shards)
    tmp = store.make_tmp_dir(path)
    offset = 0
    for si, sh in enumerate(shards):
        store.write_arrays(
            tmp / f"shard_{si:05d}", _device_leaves(sh),
            {"kind": "fastsax-index-shard", "shard": si, "shards": P_sh,
             "row_offset": int(offset)})
        offset += int(sh.size)
    ref = shards[0]
    manifest = {"format": store.FORMAT_VERSION, "kind": _KIND,
                "shards": P_sh, "levels": [int(N) for N in ref.levels],
                "alphabet": int(ref.alphabet), "size": int(B),
                "n": int(ref.n), "n_valid": int(n_valid),
                "stack": list(_index_stack(ref)),
                "extra": extra_meta or {}}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return store.commit_dir(tmp, path)


def sharded_info(path: str | os.PathLike) -> dict:
    path = pathlib.Path(path)
    return json.loads((path / MANIFEST).read_text())


def _upload(a: np.ndarray, dev) -> torch.Tensor:
    """A stored full-precision column on ``dev`` in the engine's dtype."""
    from ..core.engine import upload_host_array

    dtype = torch.int32 if a.dtype.kind in "iu" else torch.float32
    return upload_host_array(a, dtype, dev)


def _shard_index(d: pathlib.Path, smf: dict, manifest: dict, levels,
                 stack, dev, verify: bool):
    """One ``shard_*/`` dir as an ``engine.DeviceIndex`` on ``dev``."""
    from ..core.engine import DeviceIndex, _extra_dtype, upload_host_array

    def leaf(name):
        return np.asarray(store.read_array(d, name, manifest=smf,
                                           mmap=not verify, verify=verify))

    extra_names = repr_registry.extra_names(stack)
    extra = tuple(
        {name: upload_host_array(
            leaf(f"{repr_registry.get(name).column.prefix}_N{N}"),
            _extra_dtype(name), dev) for name in extra_names}
        for N in levels) if extra_names else ()
    return DeviceIndex(
        series=_upload(leaf("series"), dev).contiguous(),
        norms_sq=_upload(leaf("norms_sq"), dev),
        words=tuple(_upload(leaf(f"words_N{N}"), dev) for N in levels),
        residuals=tuple(_upload(leaf(f"resid_N{N}"), dev) for N in levels),
        extra=extra, levels=levels, alphabet=int(manifest["alphabet"]),
        stack=stack)


def load_sharded(path: str | os.PathLike, mesh, axis: str = "data",
                 verify: bool = False):
    """Map a sharded store onto a mesh: shard file *i* → mesh device *i*
    (mmap-opened, so only the bytes each device takes are read).  Returns
    ``(dist_search.ShardedDeviceIndex, n_valid)``.  The stored shard count
    must equal the mesh's; resharding a store is an offline operation,
    not a load-time one."""
    from ..core.dist_search import ShardedDeviceIndex

    path = pathlib.Path(path)
    manifest = sharded_info(path)
    if manifest.get("kind") != _KIND:
        raise IOError(f"{path}: not a {_KIND} store")
    P_sh = int(manifest["shards"])
    mesh_size = int(mesh.shape[axis])
    if P_sh != mesh_size:
        raise ValueError(
            f"{path}: stored for {P_sh} shard(s) but mesh axis "
            f"{axis!r} has {mesh_size} — rebuild or re-store for this fleet")
    levels = tuple(int(N) for N in manifest["levels"])
    stack = _check_stack(manifest, path)
    shards = []
    for si, dev in enumerate(mesh.devices):
        d = path / f"shard_{si:05d}"
        shards.append(_shard_index(d, store.read_manifest(d), manifest,
                                   levels, stack, dev, verify))
    n_valid = int(manifest["n_valid"])
    return ShardedDeviceIndex(shards=tuple(shards), n_valid=n_valid), n_valid


def load_shard_indexes(path: str | os.PathLike, verify: bool = False,
                       device=None):
    """Warm-start the *failover* engine: every ``shard_*/`` dir becomes
    its own independent ``DeviceIndex`` (or, for a tiered store, its own
    ``engine.TieredIndex`` with its raw slice trimmed to the live rows),
    shard i on device i of ``dist_search.make_data_mesh(P,
    device=device)``, so ``FailoverShards`` can query, retry and drop
    them one by one.

    Returns ``(shards, offsets, n_valid)`` — per-shard indexes, each
    shard's global row offset, and the live row count of the store.
    """
    from ..core.dist_search import make_data_mesh

    path = pathlib.Path(path)
    manifest = sharded_info(path)
    if manifest.get("kind") == _TIERED_KIND:
        from ..core.engine import TieredIndex, quantized_device_index

        tiers, n_valid, _mf = load_tier_shards(path, mmap=not verify,
                                               verify=verify)
        devices = make_data_mesh(len(tiers), device=device).devices
        shards = []
        for t, dev in zip(tiers, devices):
            # Trim the raw tier to this shard's live rows: the k-NN seed
            # strides over the raw rows only, and a pad row sampled there
            # would shrink the seed radius below the true k-th distance.
            live = max(0, min(int(t.raw.shape[0]), n_valid - t.offset))
            shards.append(TieredIndex(dev=quantized_device_index(t.qhost,
                                                                 dev),
                                      raw=t.raw[:live]))
        return shards, [t.offset for t in tiers], n_valid
    if manifest.get("kind") != _KIND:
        raise IOError(f"{path}: not a {_KIND} store")
    levels = tuple(int(N) for N in manifest["levels"])
    stack = _check_stack(manifest, path)
    P_sh = int(manifest["shards"])
    devices = make_data_mesh(P_sh, device=device).devices
    smfs = [store.read_manifest(path / f"shard_{si:05d}")
            for si in range(P_sh)]
    offsets = [int(smf.get("row_offset", 0)) for smf in smfs]
    order = np.argsort(offsets)
    shards = [_shard_index(path / f"shard_{si:05d}", smfs[si], manifest,
                           levels, stack, devices[rank], verify)
              for rank, si in enumerate(order)]
    return shards, [offsets[i] for i in order], int(manifest["n_valid"])


# ---------------------------------------------------------------------------
# Tiered (quantized) sharded persistence.
#
# Each shard dir additionally carries the quantized resident-tier columns
# (the names and dtypes of a plain store's quantized tier) next to its
# slice of the raw series, so a fleet can warm-start the screen tier
# shard by shard while the raw rows stay on disk for the final verify.
# ---------------------------------------------------------------------------


def _tiered_leaves(qdev) -> dict:
    """QuantizedDeviceIndex -> {quant-tier column name: host array}, as
    ``store.save_index`` stores the tier: bf16 codes as their uint16 bit
    patterns, per-row and per-block columns flat f32."""
    int8 = qdev.mode == "int8"
    leaves = {"qseries": qdev.series, "qseries_err": qdev.series_err,
              "qnorms": qdev.norms_sq}
    if int8:
        leaves["qseries_scale"] = qdev.series_scale
        leaves["qseries_zero"] = qdev.series_zero
    qextra = getattr(qdev, "extra", ())
    for li, N in enumerate(qdev.levels):
        leaves[f"qwords_N{N}"] = qdev.words[li]
        leaves[f"qresid_N{N}"] = qdev.residuals[li]
        leaves[f"qresid_err_N{N}"] = qdev.resid_err[li]
        if int8:
            leaves[f"qresid_scale_N{N}"] = qdev.resid_scale[li]
            leaves[f"qresid_zero_N{N}"] = qdev.resid_zero[li]
        for name, col in (qextra[li] if qextra else {}).items():
            prefix = repr_registry.get(name).column.prefix
            leaves[f"q{prefix}_N{N}"] = col
    return {name: _host(t) for name, t in leaves.items()}


def store_sharded_quantized(tindex, path: str | os.PathLike,
                            n_valid: int | None = None,
                            extra_meta: dict | None = None) -> pathlib.Path:
    """Persist a ``dist_search.DistTieredIndex`` (or one
    ``engine.TieredIndex``, as one shard), one store dir per shard: its
    quantized screen columns and its slice of the host raw series.  With
    more than one shard, every non-final shard's row count must be a
    multiple of ``quantized.RESID_BLOCK``, or the per-block scales would
    not describe the concatenated row order a single-host reload sees.
    The raw tier may hold fewer rows than the screen tier (a
    ``DistTieredIndex`` pads the screen but not the raw rows): each shard
    stores only its live raw slice."""
    from . import quantized as _q

    path = pathlib.Path(path)
    shards = tuple(tindex.shards if hasattr(tindex, "shards")
                   else (tindex.dev,))
    rows = [int(s.size) for s in shards]
    P_sh = len(shards)
    if P_sh > 1 and any(r % _q.RESID_BLOCK for r in rows[:-1]):
        raise ValueError(
            f"shard row counts {rows} are not multiples of "
            f"RESID_BLOCK={_q.RESID_BLOCK}; per-shard scale blocks would "
            f"misalign on reload — repad the database")
    B = sum(rows)
    raw = tindex.raw
    R = int(raw.shape[0])
    tmp = store.make_tmp_dir(path)
    offset = 0
    for si, sh in enumerate(shards):
        arrays = _tiered_leaves(sh)
        arrays["series"] = np.asarray(raw[min(offset, R):
                                          min(offset + rows[si], R)])
        store.write_arrays(
            tmp / f"shard_{si:05d}", arrays,
            {"kind": "fastsax-tiered-shard", "shard": si, "shards": P_sh,
             "row_offset": int(offset),
             "quant": {"mode": sh.mode, "resid_block": _q.RESID_BLOCK,
                       "sentinel_code": _q.SENTINEL_CODE}})
        offset += rows[si]
    ref = shards[0]
    manifest = {"format": store.FORMAT_VERSION, "kind": _TIERED_KIND,
                "shards": P_sh, "levels": [int(N) for N in ref.levels],
                "alphabet": int(ref.alphabet), "size": B,
                "n": int(raw.shape[-1]), "quantization": ref.mode,
                "n_valid": int(B if n_valid is None else n_valid),
                "stack": list(_index_stack(ref)),
                "extra": extra_meta or {}}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return store.commit_dir(tmp, path)


class TierShard:
    """One shard of a tiered sharded store, loaded in isolation: its
    quantized screen columns (``QuantizedHostIndex``), its live raw rows
    (mmap), and its global row offset."""

    def __init__(self, qhost, raw, offset: int):
        self.qhost = qhost
        self.raw = raw
        self.offset = int(offset)
        self.rows = int(np.asarray(qhost.norms_sq).shape[0])


def load_tier_shards(path: str | os.PathLike, mmap: bool = True,
                     verify: bool = False):
    """Load a tiered sharded store shard by shard — no host-side concat.

    Returns ``(shards, n_valid, manifest)``, ``shards`` a list of
    :class:`TierShard` sorted by row offset.  Misaligned stores fail
    loudly here: offsets that do not tile ``[0, size)``, non-final shards
    whose row count is not a RESID_BLOCK multiple, a raw slice larger
    than its screen slice, or live raw rows that are not a prefix of the
    screen rows.
    """
    from . import quantized as _q

    path = pathlib.Path(path)
    manifest = sharded_info(path)
    if manifest.get("kind") != _TIERED_KIND:
        raise IOError(f"{path}: not a {_TIERED_KIND} store")
    mode = str(manifest["quantization"])
    levels = tuple(int(N) for N in manifest["levels"])
    stack = _check_stack(manifest, path)
    P_sh = int(manifest["shards"])

    shards = []
    for si in range(P_sh):
        d = path / f"shard_{si:05d}"
        smf = store.read_manifest(d)

        def get(name, d=d, smf=smf):
            return np.asarray(store.read_array(d, name, manifest=smf,
                                               mmap=mmap, verify=verify))

        qhost = _q.quant_from_arrays(mode, int(manifest["n"]),
                                     int(manifest["alphabet"]), levels,
                                     get, stack=stack)
        raw = store.read_array(d, "series", manifest=smf, mmap=mmap,
                               verify=verify)
        shards.append(TierShard(qhost=qhost, raw=raw,
                                offset=int(smf.get("row_offset", 0))))
    shards.sort(key=lambda s: s.offset)

    pos, raw_short = 0, False
    for si, s in enumerate(shards):
        if s.offset != pos:
            raise IOError(
                f"{path}: shard {si} starts at row {s.offset}, expected "
                f"{pos} — shard offsets do not tile the index; "
                "mis-sharded store")
        if si < P_sh - 1 and s.rows % _q.RESID_BLOCK:
            raise IOError(
                f"{path}: shard {si} holds {s.rows} rows, not a multiple "
                f"of RESID_BLOCK={_q.RESID_BLOCK} — its per-block scales "
                "would misalign against the concatenated row order")
        r = int(s.raw.shape[0])
        if r > s.rows:
            raise IOError(
                f"{path}: shard {si} raw tier has {r} rows for "
                f"{s.rows} screen rows — corrupt store")
        if raw_short and r:
            raise IOError(
                f"{path}: shard {si} has live raw rows after an earlier "
                "short shard — raw tier is not a prefix of the screen "
                "rows; mis-sharded store")
        raw_short |= r < s.rows
        pos += s.rows
    if pos != int(manifest["size"]):
        raise IOError(
            f"{path}: shards cover {pos} rows but the manifest declares "
            f"size={int(manifest['size'])} — mis-sharded store")
    return shards, int(manifest["n_valid"]), manifest


class ShardedRaw:
    """Raw verify tier of a mesh-loaded tiered store: one live-row mmap
    per shard, gathered by global row id without concatenating the shards
    on the host.

    Shard ``si`` owns screen rows ``[si*block, (si+1)*block)``; its part
    holds the *live prefix* of that range.  ``index.store.gather_rows``
    clamps row ids into ``[0, len(self))`` before indexing, so the
    div/mod mapping below never reads past a part.
    """

    def __init__(self, parts, block: int | None = None):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("ShardedRaw needs at least one shard")
        if block is None:
            block = int(self.parts[0].shape[0])
        self.block = max(int(block), 1)
        n_rows = sum(int(p.shape[0]) for p in self.parts)
        for si, p in enumerate(self.parts):
            want = min(max(n_rows - si * self.block, 0), self.block)
            if int(p.shape[0]) != want:
                raise ValueError(
                    f"shard {si} holds {int(p.shape[0])} raw rows, "
                    f"expected {want} (block={self.block}): live raw "
                    "rows must be a prefix of the screen rows")
        self.shape = (n_rows,) + tuple(self.parts[0].shape[1:])
        self.dtype = np.dtype(np.float32)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        shard = np.clip(idx // self.block, 0, len(self.parts) - 1)
        local = idx - shard * self.block
        out = np.empty(idx.shape + self.shape[1:], np.float32)
        for si, p in enumerate(self.parts):
            m = shard == si
            if m.any():
                out[m] = np.asarray(p[local[m]], np.float32)
        return out

    def __array__(self, dtype=None, copy=None):
        a = (np.asarray(self.parts[0]) if len(self.parts) == 1
             else np.concatenate([np.asarray(p) for p in self.parts]))
        return np.asarray(a, np.float32 if dtype is None else dtype)


def load_sharded_tiered(path: str | os.PathLike, mesh, axis: str = "data",
                        verify: bool = False):
    """Map a tiered sharded store onto a mesh for the distributed
    quantized screen.  Returns ``(shards, ShardedRaw, n_valid)``: each
    shard's screen columns uploaded to its own mesh device as an
    ``engine.QuantizedDeviceIndex``, the raw verify tier a set of
    per-shard live-row mmaps.  Feed them to
    ``core.dist_search.DistTieredIndex``."""
    from ..core.engine import quantized_device_index

    shards, n_valid, _manifest = load_tier_shards(path, mmap=not verify,
                                                  verify=verify)
    P_sh = len(shards)
    mesh_size = int(mesh.shape[axis])
    if P_sh != mesh_size:
        raise ValueError(
            f"{path}: stored for {P_sh} shard(s) but mesh axis {axis!r} "
            f"has {mesh_size} — rebuild or re-store for this fleet")
    rows = {s.rows for s in shards}
    if len(rows) != 1:
        raise ValueError(
            f"{path}: unequal shard row counts {sorted(rows)} — the "
            "distributed screen needs equal per-device blocks; re-store "
            "through core.dist_search.store_sharded_tiered")
    b_loc = rows.pop()
    qdevs = tuple(quantized_device_index(s.qhost, dev)
                  for s, dev in zip(shards, mesh.devices))
    raw = ShardedRaw([s.raw for s in shards], block=b_loc)
    return qdevs, raw, n_valid


def load_sharded_quantized(path: str | os.PathLike, mmap: bool = True,
                           verify: bool = False, device=None):
    """Reassemble a tiered sharded store on one device (default: CUDA).

    Returns ``(engine.TieredIndex, n_valid)``.  A single-shard store
    passes its mmap columns straight through; a multi-shard store
    concatenates the per-shard quantized columns (sound because
    :func:`store_sharded_quantized` enforced RESID_BLOCK-aligned shard
    sizes) and the live raw rows.  The raw tier may come back shorter
    than the screen tier: the trailing screen rows are sentinel-killed
    padding, which the tiered engines handle.
    """
    from ..core import engine as _engine
    from . import quantized as _q

    shards, n_valid, manifest = load_tier_shards(path, mmap=mmap,
                                                 verify=verify)
    if len(shards) == 1:
        qhost, raw = shards[0].qhost, shards[0].raw
    else:
        dicts = [_q.quant_arrays(s.qhost) for s in shards]

        def get(name):
            return np.concatenate([d[name] for d in dicts])

        qhost = _q.quant_from_arrays(
            str(manifest["quantization"]), int(manifest["n"]),
            int(manifest["alphabet"]),
            tuple(int(N) for N in manifest["levels"]), get,
            stack=tuple(manifest.get("stack", DEFAULT_STACK)))
        raw = np.concatenate([np.asarray(s.raw) for s in shards])
    tiered = _engine.TieredIndex(
        dev=_engine.quantized_device_index(qhost, device), raw=raw)
    return tiered, n_valid
