"""Persistent columnar store for FAST_SAX indexes, and the raw-tier row
fetch.

Counterpart of ``repro/index/store.py``; the on-disk format is the same,
byte for byte, so a store written by either package loads in the other.
One directory per committed index (or index segment)::

    <dir>/
      manifest.json     format version, FastSAXConfig, per-array shape /
                        dtype / sha256, caller metadata
      series.npy        (B, n) float64 z-normalised rows
      words_N8.npy      (B, 8)  int32 SAX words, one pair per level
      resid_N8.npy      (B,)    float64 linear-fit residuals d(u, ū)
      words_N16.npy ... (keyed by segment count, unique by FastSAXConfig)
      q*.npy            the quantized resident tier, when saved with one

Crash safety: everything is written into a ``<dir>.tmp`` sibling and
``os.rename``d into place, so a killed writer never leaves a half index
where a reader would pick it up, and the previous generation survives
until the new one is in place.

Loading uses ``np.load(mmap_mode="r")``: opening a multi-GB index costs
milliseconds and pages lazily.  ``verify_store`` re-hashes every array
against the manifest.  The reference's fault-injection sites
``store_read`` and ``verify_fetch`` come with the fault-tolerance slice
of the port (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil

import numpy as np

from ..core import representation as repr_registry
from ..core.fastsax import FastSAXConfig, FastSAXIndex, LevelData
from ..core.representation import DEFAULT_STACK

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
_KIND = "fastsax-index"

#: Dtypes a loader may hand to the engines without a cast.  Anything else
#: in a core column fails loudly (:class:`StoreDtypeError`) instead of
#: flowing into the bound math.
_COLUMN_DTYPES = {
    "series": ("float64", "float32"),
    "resid": ("float64", "float32"),
    "words": ("int32",),
}

#: Expected dtypes of the quantized resident-tier columns.
_QUANT_DTYPES = {
    "int8": {"qseries": "int8", "qresid": "int8", "qwords": "int8"},
    "bf16": {"qseries": "uint16", "qresid": "uint16", "qwords": "int8"},
}


class StoreDtypeError(IOError):
    """A stored column's dtype violates the format contract (e.g. float16
    residuals that would flow into the f32 bound math)."""


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _array_entry(a: np.ndarray, fname: str) -> dict:
    return {"file": fname, "shape": list(a.shape), "dtype": str(a.dtype),
            "sha256": _sha256(a)}


def make_tmp_dir(path: str | os.PathLike) -> pathlib.Path:
    """Fresh ``<path>.tmp`` staging sibling for :func:`commit_dir`."""
    path = pathlib.Path(path)
    tmp = path.parent / (path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp


def commit_dir(tmp: pathlib.Path, path: pathlib.Path) -> pathlib.Path:
    """Atomically swing a fully written staging dir into place.

    The committed generation is never destroyed before the new one is in
    place: it is parked at ``<path>.old``, the rename swings, then the
    backup is dropped.  A writer killed before the first rename leaves
    the old store untouched; between the renames the old data survives
    at ``.old``.
    """
    if path.exists():
        backup = path.parent / (path.name + ".old")
        if backup.exists():
            shutil.rmtree(backup)
        os.rename(path, backup)
        os.rename(tmp, path)
        shutil.rmtree(backup)
    else:
        os.rename(tmp, path)
    return path


def write_arrays(path: str | os.PathLike, arrays: dict,
                 meta: dict) -> pathlib.Path:
    """Commit ``arrays`` and the JSON-friendly caller ``meta`` to ``path``
    atomically: one ``.npy`` per array, one manifest, tmp + rename."""
    path = pathlib.Path(path)
    tmp = make_tmp_dir(path)
    manifest = {"format": FORMAT_VERSION, "arrays": {}, **meta}
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        fname = name + ".npy"
        np.save(tmp / fname, a)
        manifest["arrays"][name] = _array_entry(a, fname)
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return commit_dir(tmp, path)


def read_manifest(path: str | os.PathLike) -> dict:
    path = pathlib.Path(path)
    return json.loads((path / MANIFEST).read_text())


def read_array(path: str | os.PathLike, name: str,
               manifest: dict | None = None, mmap: bool = True,
               verify: bool = False) -> np.ndarray:
    """Load one named array, lazily (mmap) by default.  A header that
    disagrees with the manifest raises ``IOError``; ``verify=True`` also
    reads the whole array and raises on a checksum mismatch."""
    path = pathlib.Path(path)
    manifest = manifest or read_manifest(path)
    entry = manifest["arrays"].get(name)
    if entry is None:
        raise KeyError(f"store {path} has no array {name!r}")
    a = np.load(path / entry["file"], mmap_mode="r" if mmap else None)
    if list(a.shape) != entry["shape"] or str(a.dtype) != entry["dtype"]:
        raise IOError(f"{path}/{name}: header {a.shape}/{a.dtype} does not "
                      f"match manifest {entry['shape']}/{entry['dtype']}")
    if verify and _sha256(np.asarray(a)) != entry["sha256"]:
        raise IOError(f"{path}/{name}: checksum mismatch — corrupt store")
    return a


def gather_rows(raw, idx, out: np.ndarray | None = None) -> np.ndarray:
    """Fetch full-precision verify rows from the raw tier by row id, as
    float32 of shape ``idx.shape + raw.shape[1:]``.

    The one place every raw-tier verify read goes through, synchronous or
    prefetched.  ``raw`` is anything with row-major fancy indexing (an
    ``np.memmap`` of a store's f64 series or a plain array).  Row ids
    clamp into the raw tier's row range, so a dead slot's arbitrary id
    never faults the read; an empty raw tier serves zeros.  ``out``, when
    given, receives the rows (e.g. a pinned staging buffer) and is
    returned.  A read of the wrong shape raises ``IOError`` instead of
    returning a truncated candidate set.
    """
    n_rows = int(raw.shape[0])
    idx = np.asarray(idx)
    want = idx.shape + tuple(raw.shape[1:])
    if n_rows == 0:
        rows = np.zeros(want, np.float32)
    elif out is not None and raw.dtype == np.float32 and out.shape == want:
        # Straight into the caller's buffer: no intermediate copy.
        rows = np.take(raw, idx, axis=0, mode="clip", out=out)
    else:
        clamped = np.clip(idx, 0, n_rows - 1)
        rows = np.asarray(raw[clamped], dtype=np.float32)
    if rows.shape != want:
        raise IOError(
            f"verify fetch returned shape {rows.shape} for row ids of shape "
            f"{idx.shape} (expected {want}): truncated raw-tier read")
    if out is None or rows is out:
        return rows
    out[...] = rows
    return out


def verify_store(path: str | os.PathLike) -> dict:
    """Re-hash every array against the manifest.  Returns the manifest;
    raises ``IOError`` naming the first corrupt array."""
    manifest = read_manifest(path)
    for name in manifest["arrays"]:
        read_array(path, name, manifest, mmap=True, verify=True)
    return manifest


# --- FastSAXIndex layout ----------------------------------------------------

def _config_to_json(config: FastSAXConfig) -> dict:
    return {"n_segments": list(config.n_segments),
            "alphabet": int(config.alphabet),
            "level_order": config.level_order,
            "stack": list(getattr(config, "stack", DEFAULT_STACK))}


def _config_from_json(d: dict, where: str = "store") -> FastSAXConfig:
    # Manifests written before the representation registry carry no
    # "stack" key: those stores are the paper's two-level cascade.
    stack = tuple(d.get("stack", DEFAULT_STACK))
    known = set(repr_registry.registered_names())
    unknown = [name for name in stack if name not in known]
    if unknown:
        raise IOError(
            f"{where}: manifest level stack {list(stack)} names "
            f"unregistered representation(s) {unknown} — this reader "
            f"knows {sorted(known)}; register the representation before "
            f"loading")
    return FastSAXConfig(n_segments=tuple(int(N) for N in d["n_segments"]),
                         alphabet=int(d["alphabet"]),
                         level_order=d["level_order"],
                         stack=stack)


def index_arrays(index: FastSAXIndex) -> dict:
    """The columnar layout of one index: name -> array.  No ``norms_sq``
    column: the device upload recomputes ‖u‖² from the f32 series."""
    arrays = {"series": index.series}
    for lv in index.levels:
        arrays[f"words_N{lv.n_segments}"] = lv.words
        arrays[f"resid_N{lv.n_segments}"] = lv.residuals
        for name, col in getattr(lv, "extra", {}).items():
            prefix = repr_registry.get(name).column.prefix
            arrays[f"{prefix}_N{lv.n_segments}"] = col
    return arrays


def save_index(index: FastSAXIndex, path: str | os.PathLike,
               extra_meta: dict | None = None,
               extra_arrays: dict | None = None,
               quantization: str = "none") -> pathlib.Path:
    """Persist a built index atomically.

    ``extra_arrays`` ride along in the same manifest, checksummed like
    every column (``mutable.py`` stores each segment's external ids this
    way); ``load_index`` ignores names it does not know.
    ``quantization`` ∈ {"none", "bf16", "int8"} also writes the resident
    tier's ``q*`` columns and a ``manifest["quant"]`` block with the
    mode, the scale-block geometry and the sha256 of every
    full-precision source column.
    """
    from . import quantized as _q

    _q.check_mode(quantization)
    arrays = index_arrays(index)
    meta = {"kind": _KIND, "config": _config_to_json(index.config),
            "size": int(index.size), "n": int(index.n),
            "dtypes": {"series": str(np.asarray(index.series).dtype),
                       "resid": str(np.asarray(
                           index.levels[0].residuals).dtype),
                       "words": str(np.asarray(index.levels[0].words).dtype)},
            "extra": extra_meta or {}}
    if quantization != "none":
        qhost = _q.quantize_host_index(index, quantization)
        source_sha = {name: _sha256(np.ascontiguousarray(a))
                      for name, a in arrays.items()}
        meta["quant"] = _q.quant_meta(qhost, source_sha)
        arrays = {**arrays, **_q.quant_arrays(qhost)}
    return write_arrays(path, {**arrays, **(extra_arrays or {})}, meta)


def _check_column_dtype(path, name: str, kind: str, dtype: str,
                        declared: str | None):
    """Enforce the loader's dtype contract for one core column."""
    allowed = _COLUMN_DTYPES[kind]
    if dtype not in allowed:
        raise StoreDtypeError(
            f"{path}/{name}: stored dtype {dtype} is not a valid {kind} "
            f"dtype (expected one of {allowed}) — refusing the silently "
            f"miscast load")
    if declared is not None and dtype != declared:
        raise StoreDtypeError(
            f"{path}/{name}: stored dtype {dtype} does not match the "
            f"manifest dtype contract {declared!r}")


def load_index(path: str | os.PathLike, mmap: bool = True,
               verify: bool = False) -> FastSAXIndex:
    """Open a committed index.  ``mmap=True`` (default) maps the arrays
    lazily; ``verify=True`` also re-hashes every array (a full read).
    Any registered stack loads, its extra columns with it; the device
    uploads carry them (``engine.device_index_from_host``)."""
    path = pathlib.Path(path)
    manifest = read_manifest(path)
    if manifest.get("kind") != _KIND:
        raise IOError(f"{path}: not a {_KIND} store "
                      f"(kind={manifest.get('kind')!r})")
    if manifest["format"] > FORMAT_VERSION:
        raise IOError(f"{path}: format {manifest['format']} is newer than "
                      f"this reader ({FORMAT_VERSION})")
    config = _config_from_json(manifest["config"], where=str(path))
    declared = manifest.get("dtypes", {})
    series = read_array(path, "series", manifest, mmap=mmap, verify=verify)
    _check_column_dtype(path, "series", "series", str(series.dtype),
                        declared.get("series"))
    levels = []
    for N in config.levels:
        words = read_array(path, f"words_N{N}", manifest, mmap=mmap,
                           verify=verify)
        residuals = read_array(path, f"resid_N{N}", manifest, mmap=mmap,
                               verify=verify)
        _check_column_dtype(path, f"words_N{N}", "words", str(words.dtype),
                            declared.get("words"))
        _check_column_dtype(path, f"resid_N{N}", "resid",
                            str(residuals.dtype), declared.get("resid"))
        extra = {}
        for name in config.extra_stack:
            rep = repr_registry.get(name)
            col_name = f"{rep.column.prefix}_N{N}"
            col = read_array(path, col_name, manifest, mmap=mmap,
                             verify=verify)
            if str(col.dtype) not in rep.column.dtypes:
                raise StoreDtypeError(
                    f"{path}/{col_name}: stored dtype {col.dtype} is not a "
                    f"valid {name!r} column dtype "
                    f"(expected one of {rep.column.dtypes})")
            extra[name] = col
        levels.append(LevelData(n_segments=N, words=words,
                                residuals=residuals, extra=extra))
    return FastSAXIndex(config=config, series=series, levels=levels)


def has_quantized(manifest: dict) -> bool:
    return bool(manifest.get("quant"))


def quantized_mode(manifest: dict) -> str:
    quant = manifest.get("quant") or {}
    return quant.get("mode", "none")


def load_quantized(path: str | os.PathLike, mmap: bool = True,
                   verify: bool = False, mode: str | None = None):
    """Open the quantized resident tier of a committed store as an
    ``index.quantized.QuantizedHostIndex`` (mmap columns by default).

    Raises ``IOError`` when the store has no quantized tier, when its
    mode is not ``mode`` (``None`` accepts any), when its scale-block
    geometry differs from this reader's, or when a recorded source sha256
    no longer matches the full-precision column (the tier was derived
    from another generation of the data); :class:`StoreDtypeError` when
    a quantized column's dtype breaks the mode's contract; and the usual
    shape or checksum ``IOError`` of :func:`read_array`.
    """
    from . import quantized as _q

    path = pathlib.Path(path)
    manifest = read_manifest(path)
    quant = manifest.get("quant")
    if not quant:
        raise IOError(f"{path}: store has no quantized tier "
                      f"(save with quantization='int8'|'bf16')")
    stored_mode = quant.get("mode")
    if mode is not None and stored_mode != mode:
        raise IOError(f"{path}: quantized tier is {stored_mode!r}, "
                      f"caller requires {mode!r}")
    if int(quant.get("resid_block", -1)) != _q.RESID_BLOCK:
        raise IOError(f"{path}: quantized scale-block geometry "
                      f"{quant.get('resid_block')} does not match this "
                      f"reader ({_q.RESID_BLOCK})")
    for name, sha in quant.get("source_sha", {}).items():
        entry = manifest["arrays"].get(name)
        if entry is None or entry["sha256"] != sha:
            raise IOError(
                f"{path}/{name}: quantized columns were derived from a "
                f"different generation of this array — scale/column "
                f"generation mismatch, refusing to load")
    expect = _QUANT_DTYPES[stored_mode]

    def get(name: str) -> np.ndarray:
        a = read_array(path, name, manifest, mmap=mmap, verify=verify)
        base = name.split("_N")[0] if name.startswith(
            ("qwords", "qresid")) else name
        want = expect.get(base)
        if base in ("qresid_scale", "qresid_zero", "qresid_err",
                    "qseries_scale", "qseries_zero", "qseries_err",
                    "qnorms"):
            want = "float32"
        if want is not None and str(a.dtype) != want:
            raise StoreDtypeError(
                f"{path}/{name}: quantized column dtype {a.dtype} "
                f"violates the {stored_mode} contract ({want})")
        return a

    config = _config_from_json(manifest["config"], where=str(path))
    return _q.quant_from_arrays(stored_mode, manifest["n"], config.alphabet,
                                config.levels, get,
                                stack=tuple(config.stack))


def store_info(path: str | os.PathLike) -> dict:
    """Manifest summary for the CLI: sizes, level shapes, on-disk bytes."""
    path = pathlib.Path(path)
    manifest = read_manifest(path)
    arrays = {}
    total = 0
    for name, entry in manifest["arrays"].items():
        nbytes = (path / entry["file"]).stat().st_size
        total += nbytes
        arrays[name] = {"shape": entry["shape"], "dtype": entry["dtype"],
                        "bytes": nbytes}
    config = manifest.get("config") or {}
    return {"path": str(path), "format": manifest["format"],
            "kind": manifest.get("kind"), "config": config,
            "size": manifest.get("size"), "n": manifest.get("n"),
            "stack": list(config.get("stack", DEFAULT_STACK)),
            "quantization": quantized_mode(manifest),
            "extra": manifest.get("extra", {}),
            "arrays": arrays, "total_bytes": total}
