"""Representation registry (the cascade's levels).

Counterpart of ``repro/core/representation.py``.  A representation knows
how to symbolize database series and queries (host float64 numpy and
device float32 torch twins) and how to lower-bound the Euclidean distance
against its stored column.  This slice registers the paper's two
representations, which form the default stack:

  * ``linfit_residual`` — the residual gap |d(u,ū) − d(q,q̄)| (paper
    eq. 9, exclusion condition C9);
  * ``sax_word`` — MINDIST over the SAX word (paper eq. 10, C10).

The reference's ``trend_slope`` and the op-cost hooks are not ported yet
(ROADMAP.md, queue 1).  Every stack must contain the paper pair, and
gap-kind representations run before word-kind ones (C9 → C10).
"""
from __future__ import annotations

import numpy as np
import torch

from . import polyfit
from .paa import paa, paa_np
from .sax import discretize, discretize_np, mindist_table


class Representation:
    """Base class of a registered cascade representation.

    ``kind`` is ``"gap"`` (scalar column, C9-style |a − b| > ε exclusion)
    or ``"word"`` (per-segment symbol column, C10-style squared bound >
    ε² exclusion).
    """

    name: str = ""
    kind: str = "word"

    def symbolize_np(self, series: np.ndarray, N: int, alphabet: int):
        """Host float64 column for a (B, n) batch (or an (n,) query)."""
        raise NotImplementedError

    def symbolize_dev(self, x: torch.Tensor, N: int, alphabet: int):
        """Device float32 column for a (B, n) or (Q, n) tensor."""
        raise NotImplementedError

    def host_lower_bound(self, col: np.ndarray, qval, *, n: int, N: int,
                         alphabet: int) -> np.ndarray:
        """Lower bound on d(u, q) in distance units, host float64."""
        raise NotImplementedError


_REGISTRY: dict = {}

#: The paper's two-representation cascade, and the default stack.
DEFAULT_STACK = ("linfit_residual", "sax_word")
REQUIRED_NAMES = frozenset(DEFAULT_STACK)


def register(rep: Representation) -> Representation:
    """Register a representation instance under its ``name`` (unique)."""
    if not rep.name:
        raise ValueError("representation must have a non-empty name")
    if rep.name in _REGISTRY:
        raise ValueError(f"representation {rep.name!r} already registered")
    if rep.kind not in ("gap", "word"):
        raise ValueError(f"{rep.name}: kind must be 'gap' or 'word', "
                         f"got {rep.kind!r}")
    _REGISTRY[rep.name] = rep
    return rep


def get(name: str) -> Representation:
    """Look up a registered representation; loud failure on unknown."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unregistered representation {name!r} — registered: "
            f"{registered_names()}") from None


def registered_names() -> tuple:
    return tuple(_REGISTRY)


def validate_stack(stack) -> tuple:
    """Validate a level stack: registered names, the paper pair present,
    no duplicates, gap-kind before word-kind.  Returns it as a tuple."""
    stack = tuple(stack)
    if len(set(stack)) != len(stack):
        raise ValueError(f"duplicate representation in stack {stack}")
    reps = [get(name) for name in stack]
    missing = REQUIRED_NAMES - set(stack)
    if missing:
        raise ValueError(
            f"stack {stack} is missing the paper backbone "
            f"representation(s) {sorted(missing)} — every stack must "
            f"contain {DEFAULT_STACK}")
    seen_word = False
    for rep in reps:
        if rep.kind == "word":
            seen_word = True
        elif seen_word:
            raise ValueError(
                f"stack {stack}: gap-kind {rep.name!r} after a word-kind "
                "representation — gap-kind levels run first (C9 → C10)")
    return stack


class LinfitResidualRepr(Representation):
    """Paper C9: residual distance to the optimal per-segment LS line.
    Bound: |d(u,ū) − d(q,q̄)| ≤ d(u,q) (paper eq. 9)."""

    name = "linfit_residual"
    kind = "gap"

    def symbolize_np(self, series, N, alphabet):
        return polyfit.linfit_residual_np(series, N).astype(np.float64)

    def symbolize_dev(self, x, N, alphabet):
        return polyfit.linfit_residual(x, N).to(torch.float32)

    def host_lower_bound(self, col, qval, *, n, N, alphabet):
        return np.abs(col - qval)


class SaxWordRepr(Representation):
    """Paper C10: MINDIST over the SAX word.
    Bound: (n/N)·Σᵢ tab[uᵢ, qᵢ]² ≤ d(u,q)² (paper eq. 3)."""

    name = "sax_word"
    kind = "word"

    def symbolize_np(self, series, N, alphabet):
        return discretize_np(paa_np(series, N), alphabet)

    def symbolize_dev(self, x, N, alphabet):
        return discretize(paa(x, N), alphabet)

    def host_lower_bound(self, col, qval, *, n, N, alphabet):
        tab = mindist_table(alphabet)
        cell = tab[col, np.asarray(qval)[None, :]]
        return np.sqrt((n / N) * np.sum(cell * cell, axis=-1))


register(LinfitResidualRepr())
register(SaxWordRepr())
