"""FAST_SAX multi-level index, offline phase (paper §3), host float64.

Counterpart of ``repro/core/fastsax.py``.  For every series ``u`` and every
level (a segment count ``N_l``) the builder stores the SAX word (for C10),
the residual ``d(u, ū_l)`` to the optimal per-segment line (for C9) and
the column of every further representation of the stack (``extra``).
Levels are visited coarse→fine by default; ``level_order="paper"`` keeps
the paper's literal fine-first order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import representation as repr_registry
from .paa import paa_np, znormalize_np
from .polyfit import linfit_residual_np
from .representation import DEFAULT_STACK
from .sax import MAX_ALPHABET, MIN_ALPHABET, discretize_np


@dataclasses.dataclass(frozen=True)
class FastSAXConfig:
    """Static configuration of a FAST_SAX index.

    ``n_segments`` is listed coarse→fine and strictly ascending; each
    entry is one level and must divide the series length.  ``stack``
    names the registered representations every level carries; it must
    contain the paper pair.
    """

    n_segments: tuple
    alphabet: int = 10
    level_order: str = "coarse_first"  # "coarse_first" | "paper" (fine first)
    stack: tuple = DEFAULT_STACK

    def __post_init__(self):
        if not MIN_ALPHABET <= self.alphabet <= MAX_ALPHABET:
            raise ValueError(
                f"alphabet must be in [{MIN_ALPHABET}, {MAX_ALPHABET}]")
        if len(self.n_segments) == 0:
            raise ValueError("need at least one level")
        if any(a >= b for a, b in zip(self.n_segments, self.n_segments[1:])):
            raise ValueError(
                "n_segments must be strictly ascending coarse→fine "
                f"(no duplicates), got {tuple(self.n_segments)}")
        if self.level_order not in ("coarse_first", "paper"):
            raise ValueError(f"bad level_order {self.level_order!r}")
        object.__setattr__(self, "stack",
                           repr_registry.validate_stack(self.stack))

    @property
    def extra_stack(self) -> tuple:
        """Stack names beyond the paper pair (build order)."""
        return repr_registry.extra_names(self.stack)

    @property
    def levels(self) -> tuple:
        """Level segment counts in visit order for the online cascade."""
        if self.level_order == "coarse_first":
            return tuple(self.n_segments)
        return tuple(reversed(self.n_segments))


@dataclasses.dataclass
class LevelData:
    """Per-level precomputed representations for a batch of series;
    ``extra`` holds the further representations' columns by name."""

    n_segments: int
    words: np.ndarray      # (B, N_l) int32 SAX symbols
    residuals: np.ndarray  # (B,) float64 d(u, ū_l)
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FastSAXIndex:
    """The offline-built index over a database of z-normalised series."""

    config: FastSAXConfig
    series: np.ndarray         # (B, n) float64, z-normalised
    levels: list               # [LevelData] in cascade visit order

    @property
    def n(self) -> int:
        return self.series.shape[-1]

    @property
    def size(self) -> int:
        return self.series.shape[0]

    def level_for(self, n_segments: int) -> LevelData:
        for lv in self.levels:
            if lv.n_segments == n_segments:
                return lv
        raise KeyError(f"no level with N={n_segments}")


def _represent(series: np.ndarray, n_segments: int, alphabet: int,
               stack: tuple = DEFAULT_STACK) -> LevelData:
    extra = {name: repr_registry.get(name).symbolize_np(
                 series, n_segments, alphabet)
             for name in repr_registry.extra_names(stack)}
    return LevelData(
        n_segments=n_segments,
        words=discretize_np(paa_np(series, n_segments), alphabet),
        residuals=linfit_residual_np(series, n_segments).astype(np.float64),
        extra=extra)


def build_index(series: np.ndarray, config: FastSAXConfig,
                normalize: bool = True) -> FastSAXIndex:
    """Offline phase: z-normalise and precompute every level's words,
    residuals and extra columns."""
    series = np.asarray(series, dtype=np.float64)
    if series.ndim != 2:
        raise ValueError(f"series must be (B, n), got {series.shape}")
    n = series.shape[-1]
    for N in config.n_segments:
        if n % N != 0:
            raise ValueError(f"level N={N} does not divide series length n={n}")
    if normalize:
        series = znormalize_np(series)
    levels = [_represent(series, N, config.alphabet, config.stack)
              for N in config.levels]
    return FastSAXIndex(config=config, series=series, levels=levels)


@dataclasses.dataclass
class QueryRepr:
    """The online representation of one query, mirroring the index
    levels; ``extra`` holds, per level, a dict keyed by representation
    name (empty for the paper stack)."""

    q: np.ndarray            # (n,) z-normalised query
    words: list              # per level: (N_l,) int32
    residuals: list          # per level: scalar d(q, q̄_l)
    extra: list = dataclasses.field(default_factory=list)


def represent_query(q: np.ndarray, config: FastSAXConfig,
                    normalize: bool = True) -> QueryRepr:
    q = np.asarray(q, dtype=np.float64)
    if q.ndim != 1:
        raise ValueError("query must be a single (n,) series")
    if normalize:
        q = znormalize_np(q)
    extras = config.extra_stack
    return QueryRepr(
        q=q,
        words=[discretize_np(paa_np(q, N), config.alphabet)
               for N in config.levels],
        residuals=[float(linfit_residual_np(q, N)) for N in config.levels],
        extra=[{name: repr_registry.get(name).query_repr_np(
                    q, N, config.alphabet) for name in extras}
               for N in config.levels])
