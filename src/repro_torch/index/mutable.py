"""Incrementally updatable FAST_SAX index: generations, deltas, tombstones.

Counterpart of ``repro/index/mutable.py``, with the same on-disk layout,
so a root written by either package opens in the other::

    <root>/
      CURRENT                pointer file: name of the committed epoch
      epoch_<G>.json         one commit: base segment, delta segments in
                             insertion order, tombstone store, next_id
      base_<G>/              store.py index dir (+ ``ids`` array)
      delta_<G>/             store.py index dir for one appended batch
      tomb_<G>/              store.py dir holding the tombstone bitmap

Commit protocol: every mutation writes only new files (segments and the
epoch manifest are never overwritten), then swaps ``CURRENT`` atomically
by write-to-tmp + ``os.replace``.  A writer killed at any point leaves
the previous epoch intact.

Mutations:

  * ``insert`` builds the representations of the new rows only (the
    per-row math is row-independent, so a delta segment is bit-identical
    to what a full rebuild computes for those rows) and appends a delta;
  * ``delete`` flips bits in a tombstone bitmap over physical rows;
  * ``compact()`` concatenates the live rows' stored columns into a new
    base generation, with no representation recomputed;
  * ``search_index()`` is the search view: tombstoned rows keep their
    slots but carry the C9 sentinel residual (the engines' padding
    mechanism), so the cascade excludes them at any finite ε, and a
    large series value, so no verify can rank one above a live row;
    ``live_index()`` drops them instead (the device uploads use it).

Any interleaving of inserts, deletes and compactions answers range and
k-NN queries as a fresh ``build_index`` over the live rows does.  The
mutations and the views run under one lock, so a service snapshotting
the live view on its refresh thread never sees half a mutation (rows of
one epoch with the ids of another).
"""
from __future__ import annotations

import functools
import json
import os
import pathlib
import shutil
import threading

import numpy as np

from ..core.fastsax import (FastSAXConfig, FastSAXIndex, LevelData,
                            build_index, represent_query)
from . import store

#: Level residual of a tombstoned row: the engines' PAD_RESIDUAL.
TOMBSTONE_RESIDUAL = 1e30
#: Series value of a tombstoned row: its Euclidean distance to any live
#: z-normalised row is astronomically larger than any live one's.
TOMBSTONE_SERIES = 1e6

CURRENT = "CURRENT"
_TOMB_KIND = "fastsax-tombstones"


def _epoch_name(gen: int) -> str:
    return f"epoch_{gen:08d}.json"


def _locked(method):
    """Run ``method`` holding the index's lock."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return run


class MutableIndex:
    """A persistent FAST_SAX index that absorbs inserts and deletes.

    Rows carry stable external ids (assigned in insertion order, kept
    across ``compact()``); every query answer is in external ids.
    """

    def __init__(self, root: str | os.PathLike, epoch: dict):
        self.root = pathlib.Path(root)
        self._epoch = epoch
        self._segments: list = []       # [(dirname, FastSAXIndex, ids)]
        self._tomb: np.ndarray | None = None
        self._view: tuple | None = None  # cached (FastSAXIndex, ids)
        self._listeners: list = []       # commit hooks (the serve layer)
        self._lock = threading.RLock()   # mutations against views
        self._load_epoch()

    # --- creation / opening -------------------------------------------------

    @classmethod
    def create(cls, root: str | os.PathLike, series: np.ndarray,
               config: FastSAXConfig, normalize: bool = True,
               quantization: str = "none") -> "MutableIndex":
        """Build generation 0 from ``series`` and commit it.

        ``quantization`` ("none" | "bf16" | "int8") holds for the epoch:
        every segment it commits (the first base, deltas, compacted
        bases) carries a quantized tier in that mode, so a tiered warm
        start finds stored resident columns at any point.
        """
        from . import quantized as _q

        _q.check_mode(quantization)
        root = pathlib.Path(root)
        root.mkdir(parents=True, exist_ok=True)
        if (root / CURRENT).exists():
            raise FileExistsError(f"{root}: index already exists (open it)")
        index = build_index(series, config, normalize=normalize)
        ids = np.arange(index.size, dtype=np.int64)
        _save_segment(index, ids, root / "base_00000000", quantization)
        epoch = {"format": store.FORMAT_VERSION, "gen": 0,
                 "base": "base_00000000", "deltas": [], "tombstones": None,
                 "next_id": int(index.size),
                 "quantization": quantization,
                 "config": store._config_to_json(config)}
        _commit_epoch(root, epoch)
        return cls(root, epoch)

    @classmethod
    def open(cls, root: str | os.PathLike) -> "MutableIndex":
        root = pathlib.Path(root)
        pointer = (root / CURRENT).read_text().strip()
        epoch = json.loads((root / pointer).read_text())
        return cls(root, epoch)

    def _load_epoch(self):
        self._segments = []
        for name in [self._epoch["base"], *self._epoch["deltas"]]:
            idx = store.load_index(self.root / name, mmap=True)
            ids = np.asarray(store.read_array(self.root / name, "ids"))
            self._segments.append((name, idx, ids))
        n_rows = sum(ids.size for _, _, ids in self._segments)
        self._tomb = np.zeros(n_rows, dtype=bool)
        if self._epoch["tombstones"] is not None:
            mask = np.asarray(store.read_array(
                self.root / self._epoch["tombstones"], "mask"))
            # Deltas appended after the tombstone commit are live rows.
            self._tomb[:mask.size] = mask
        self._view = None

    # --- introspection ------------------------------------------------------

    @property
    def config(self) -> FastSAXConfig:
        return self._segments[0][1].config

    @property
    def quantization(self) -> str:
        """The epoch's quantized-tier mode ("none" on epochs written
        before the field existed)."""
        return str(self._epoch.get("quantization", "none"))

    @property
    def n_rows(self) -> int:
        """Physical rows (live and tombstoned) across base and deltas."""
        return int(self._tomb.size)

    @property
    def n_live(self) -> int:
        return int(self.n_rows - self._tomb.sum())

    @property
    def ids(self) -> np.ndarray:
        """External ids of every physical row, ascending."""
        return np.concatenate([ids for _, _, ids in self._segments])

    @property
    def live_ids(self) -> np.ndarray:
        return self.ids[~self._tomb]

    @property
    def live_mask(self) -> np.ndarray:
        """(n_rows,) bool: True for a live physical row."""
        return ~self._tomb

    @property
    def compacted(self) -> bool:
        """One segment and no tombstone: the committed base is the live
        view, column for column."""
        return len(self._segments) == 1 and not self._tomb.any()

    @property
    def base_dir(self) -> pathlib.Path:
        """The committed base segment's store directory."""
        return self.root / self._epoch["base"]

    def verify(self) -> list:
        """Re-hash every committed segment (and the tombstone store)
        against its manifest.  Returns the verified dir names; raises
        ``IOError`` naming the first corrupt array."""
        names = [name for name, _, _ in self._segments]
        if self._epoch["tombstones"]:
            names.append(self._epoch["tombstones"])
        for name in names:
            store.verify_store(self.root / name)
        return names

    def info(self) -> dict:
        cfg = self.config
        return {"root": str(self.root), "gen": self._epoch["gen"],
                "base": self._epoch["base"],
                "n_deltas": len(self._epoch["deltas"]),
                "rows": self.n_rows, "live": self.n_live,
                "tombstoned": int(self._tomb.sum()),
                "next_id": self._epoch["next_id"],
                "config": self._epoch["config"],
                "stack": {
                    "representations": list(cfg.stack),
                    "levels": [{"n_segments": int(N),
                                "representations": list(cfg.stack)}
                               for N in cfg.levels],
                    "quantization": self.quantization,
                }}

    # --- refresh hook (the serve layer's live-ingest signal) ----------------

    @property
    def generation(self) -> int:
        """The committed epoch number; it rises with every mutation.  A
        reader holding a device copy compares it with the generation it
        uploaded to decide whether a refresh is due."""
        return int(self._epoch["gen"])

    def subscribe(self, fn):
        """Run ``fn(mutable_index)`` after every committed mutation
        (insert / delete / compact), once ``CURRENT`` has swapped, still
        under the index's lock (a listener only takes note).  Returns an
        unsubscribe callable.  A listener's exception reaches the
        mutator."""
        self._listeners.append(fn)

        def unsubscribe():
            if fn in self._listeners:
                self._listeners.remove(fn)
        return unsubscribe

    def _notify(self):
        for fn in list(self._listeners):
            fn(self)

    # --- mutation -----------------------------------------------------------

    def _next_gen(self) -> int:
        return int(self._epoch["gen"]) + 1

    @_locked
    def insert(self, series: np.ndarray, normalize: bool = True) -> np.ndarray:
        """Append rows as a delta segment.  Returns their external ids."""
        series = np.asarray(series, dtype=np.float64)
        if series.ndim != 2 or series.shape[-1] != self._segments[0][1].n:
            raise ValueError(
                f"series must be (B, {self._segments[0][1].n}), "
                f"got {series.shape}")
        gen = self._next_gen()
        delta = build_index(series, self.config, normalize=normalize)
        start = int(self._epoch["next_id"])
        ids = np.arange(start, start + delta.size, dtype=np.int64)
        name = f"delta_{gen:08d}"
        _save_segment(delta, ids, self.root / name, self.quantization)
        epoch = dict(self._epoch, gen=gen,
                     deltas=[*self._epoch["deltas"], name],
                     next_id=start + delta.size)
        _commit_epoch(self.root, epoch)
        self._epoch = epoch
        self._segments.append((name, store.load_index(self.root / name),
                               ids))
        self._tomb = np.concatenate(
            [self._tomb, np.zeros(delta.size, dtype=bool)])
        self._view = None
        self._notify()
        return ids

    @_locked
    def delete(self, ids) -> int:
        """Tombstone rows by external id.  Returns the live count after.
        Unknown, duplicate or already deleted ids raise ``KeyError``."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if np.unique(ids).size != ids.size:
            raise KeyError(f"duplicate ids in delete request: "
                           f"{ids.tolist()}")
        all_ids = self.ids
        pos = np.searchsorted(all_ids, ids)
        bad = (pos >= all_ids.size) | (all_ids[np.minimum(
            pos, all_ids.size - 1)] != ids)
        if bad.any():
            raise KeyError(f"unknown ids {ids[bad].tolist()}")
        if self._tomb[pos].any():
            raise KeyError(
                f"already deleted: {ids[self._tomb[pos]].tolist()}")
        gen = self._next_gen()
        mask = self._tomb.copy()
        mask[pos] = True
        name = f"tomb_{gen:08d}"
        store.write_arrays(self.root / name, {"mask": mask},
                           {"kind": _TOMB_KIND, "rows": int(mask.size)})
        epoch = dict(self._epoch, gen=gen, tombstones=name)
        _commit_epoch(self.root, epoch)
        self._epoch = epoch
        self._tomb = mask
        self._view = None
        self._notify()
        return self.n_live

    def _concat_rows(self):
        """Every segment's stored per-row arrays concatenated in physical
        (= id) order: ``(series, words_per_level, resid_per_level,
        extra_per_level)``."""
        series = np.concatenate(
            [np.asarray(idx.series) for _, idx, _ in self._segments])
        words, resid, extra = [], [], []
        for li in range(len(self.config.levels)):
            words.append(np.concatenate(
                [np.asarray(idx.levels[li].words)
                 for _, idx, _ in self._segments]))
            resid.append(np.concatenate(
                [np.asarray(idx.levels[li].residuals)
                 for _, idx, _ in self._segments]))
            extra.append({
                name: np.concatenate(
                    [np.asarray(idx.levels[li].extra[name])
                     for _, idx, _ in self._segments])
                for name in self.config.extra_stack})
        return series, words, resid, extra

    def _assemble(self, keep) -> FastSAXIndex:
        """A FastSAXIndex over the ``keep``-selected physical rows."""
        cfg = self.config
        series, words, resid, extra = self._concat_rows()
        return FastSAXIndex(
            config=cfg, series=series[keep],
            levels=[LevelData(n_segments=N, words=words[li][keep],
                              residuals=resid[li][keep],
                              extra={name: col[keep]
                                     for name, col in extra[li].items()})
                    for li, N in enumerate(cfg.levels)])

    @_locked
    def compact(self, gc: bool = True) -> dict:
        """Fold deltas and tombstones into a new base generation by
        concatenating the live rows' stored columns (the quantized tier,
        if any, is quantized anew over the folded rows).  The old segment
        files are removed after the commit unless ``gc=False``."""
        if self.n_live == 0:
            raise ValueError("refusing to compact to an empty index")
        folded = self._assemble(~self._tomb)
        ids = self.live_ids
        gen = self._next_gen()
        name = f"base_{gen:08d}"
        _save_segment(folded, ids, self.root / name, self.quantization)
        epoch = dict(self._epoch, gen=gen, base=name, deltas=[],
                     tombstones=None)
        _commit_epoch(self.root, epoch)
        old = {s for s, _, _ in self._segments}
        old_tomb = self._epoch["tombstones"]
        self._epoch = epoch
        self._load_epoch()
        if gc:
            for stale in old:
                shutil.rmtree(self.root / stale, ignore_errors=True)
            if old_tomb:
                shutil.rmtree(self.root / old_tomb, ignore_errors=True)
            for p in self.root.glob("epoch_*.json"):
                if p.name != _epoch_name(gen):
                    p.unlink()
        self._notify()
        return self.info()

    # --- querying -----------------------------------------------------------

    @_locked
    def search_index(self) -> tuple:
        """``(FastSAXIndex, ids)`` for the host engines: every physical
        row in id order, tombstoned rows carrying the sentinel residual
        and series values.  Cached until the next mutation."""
        if self._view is not None:
            return self._view
        if self.compacted:
            # The committed base is the view: no copy.
            self._view = (self._segments[0][1], self._segments[0][2])
            return self._view
        dead = self._tomb
        index = self._assemble(slice(None))
        index.series[dead] = TOMBSTONE_SERIES
        for lv in index.levels:
            lv.residuals[dead] = TOMBSTONE_RESIDUAL
        self._view = (index, self.ids)
        return self._view

    @_locked
    def live_index(self) -> tuple:
        """``(FastSAXIndex over the live rows only, their external ids)``,
        for engines without the sentinel machinery, such as the device
        uploads: a tombstoned row takes no slot, so even a k-NN with k ≥
        the live count never surfaces one.  Once rows were deleted, a
        row's position is not its id: map answers through the ids."""
        if self.compacted:
            return self._segments[0][1], self._segments[0][2]
        return self._assemble(~self._tomb), self.live_ids

    @_locked
    def live_snapshot(self) -> tuple:
        """``(generation, FastSAXIndex over the live rows, their ids)`` of
        one committed epoch, taken whole under the lock."""
        return (self.generation, *self.live_index())

    def range_query(self, query: np.ndarray, epsilon: float,
                    normalize: bool = True):
        """FAST_SAX ε-range query on the host.  Returns ``(ids,
        distances)``, as a fresh rebuild over the live rows answers."""
        from ..core.search import fastsax_range_query

        index, ids = self.search_index()
        r = fastsax_range_query(
            index, _repr(query, self.config, normalize), epsilon)
        return ids[r.answers], r.distances

    def knn_query(self, query: np.ndarray, k: int, normalize: bool = True):
        """Exact k-NN over the live rows on the host.  Returns ``(ids,
        distances)``."""
        from ..core.search import fastsax_knn_query

        index, ids = self.search_index()
        k_eff = min(int(k), self.n_live)
        if k_eff == 0:
            return np.empty(0, dtype=np.int64), np.empty(0)
        r = fastsax_knn_query(
            index, _repr(query, self.config, normalize), k_eff)
        return ids[r.indices], r.distances


def _repr(query, config, normalize):
    return represent_query(np.asarray(query, dtype=np.float64), config,
                           normalize=normalize)


def _save_segment(index: FastSAXIndex, ids: np.ndarray,
                  path: pathlib.Path, quantization: str = "none") -> None:
    store.save_index(index, path,
                     extra_arrays={"ids": np.asarray(ids, dtype=np.int64)},
                     quantization=quantization)


def _commit_epoch(root: pathlib.Path, epoch: dict) -> None:
    """Write the epoch manifest (a new file), then swap CURRENT
    atomically."""
    name = _epoch_name(epoch["gen"])
    tmp = root / (name + ".tmp")
    tmp.write_text(json.dumps(epoch, indent=1))
    os.replace(tmp, root / name)
    cur_tmp = root / (CURRENT + ".tmp")
    cur_tmp.write_text(name + "\n")
    os.replace(cur_tmp, root / CURRENT)
