"""Near-duplicate curation on the FAST_SAX engine.

Counterpart of ``repro/data/curation.py``.  Series-shaped artefacts
(telemetry curves, windowed loss signals, embedding traces) are admitted
into a pool in batches; a row within ε of an accepted member, or of an
earlier kept row of its own batch, is rejected.  The pool's index is a
``DeviceIndex`` on the filter's device, rebuilt geometrically, and the
dedup query against it is ``engine.range_query`` (the torch engine, as
the reference calls its XLA engine); the rows admitted since the last
rebuild are compared by brute force on the same device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.engine import (DeviceIndex, build_device_index, dense_diff_sq,
                           range_query, represent_queries, resolve_device)
from ..core.paa import znormalize_np


@dataclasses.dataclass
class CurationStats:
    accepted: int = 0
    rejected_duplicates: int = 0


class NearDuplicateFilter:
    """Grow-only dedup pool.  ``admit(batch)`` returns the boolean keep
    mask (host numpy) and adds the kept rows to the pool.

    ``epsilon`` is the dedup radius in z-normalised Euclidean distance.
    The pool and its index live on ``device`` (default: CUDA; raises
    without one, see ``engine.resolve_device``).  The index is rebuilt
    once the pool has grown ``rebuild_factor`` times past the rows it
    indexes (amortised O(1) per admit), since the offline phase is one
    vectorised pass.
    """

    def __init__(self, length: int, epsilon: float = 1.0,
                 levels=(8, 16), alphabet: int = 10,
                 rebuild_factor: float = 2.0, device=None):
        self.device = resolve_device(device)
        self.length = length
        self.epsilon = float(epsilon)
        self.levels = tuple(levels)
        self.alphabet = alphabet
        self.rebuild_factor = rebuild_factor
        self._pool = torch.zeros((0, length), dtype=torch.float32,
                                 device=self.device)
        self._index: DeviceIndex | None = None
        self._indexed_rows = 0
        self.stats = CurationStats()

    def _maybe_rebuild(self):
        rows = self._pool.shape[0]
        if rows == 0:
            return
        if (self._index is None
                or rows >= self.rebuild_factor * max(1, self._indexed_rows)):
            self._index = build_device_index(self._pool, self.levels,
                                             self.alphabet, normalize=False)
            self._indexed_rows = rows

    def _is_dup(self, batch_z: torch.Tensor) -> torch.Tensor:
        """(Q,) bool on the device: within ε of a pool member."""
        dup = torch.zeros(batch_z.shape[0], dtype=torch.bool,
                          device=self.device)
        if self._index is not None:
            qr = represent_queries(batch_z, self.levels, self.alphabet,
                                   normalize=False)
            answers, _ = range_query(self._index, qr, self.epsilon)
            dup |= answers.any(dim=-1)
        # Rows admitted since the last rebuild: brute force.
        tail = self._pool[self._indexed_rows:]
        if tail.shape[0]:
            dup |= (dense_diff_sq(batch_z, tail)
                    <= self.epsilon ** 2).any(dim=1)
        return dup

    def admit(self, batch: np.ndarray) -> np.ndarray:
        """batch: (Q, length) raw series.  Returns the keep mask (Q,)."""
        batch_z = torch.as_tensor(
            znormalize_np(np.asarray(batch, dtype=np.float64)).astype(
                np.float32), device=self.device)
        self._maybe_rebuild()
        keep = ~self._is_dup(batch_z).cpu().numpy()
        # In-batch dedup, sequential: a row is dropped when it lies within
        # ε of an earlier kept row of the batch.
        near = (dense_diff_sq(batch_z, batch_z)
                <= self.epsilon ** 2).cpu().numpy()
        kept_rows = []
        for i in np.nonzero(keep)[0]:
            if near[i, kept_rows].any():
                keep[i] = False
            else:
                kept_rows.append(i)
        self._pool = torch.cat(
            [self._pool, batch_z[torch.as_tensor(keep, device=self.device)]])
        self.stats.accepted += int(keep.sum())
        self.stats.rejected_duplicates += int((~keep).sum())
        return keep

    @property
    def pool_size(self) -> int:
        return self._pool.shape[0]
