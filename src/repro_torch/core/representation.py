"""Representation registry (the cascade's levels).

Counterpart of ``repro/core/representation.py``.  A representation knows
how to symbolize database series and queries (host float64 numpy and
device float32 torch twins), how to lower-bound the Euclidean distance
against its stored column (host and device forms), which store column it
occupies, and what its exclusion test and query transform cost in the
paper's op counts (``core/cost_model.py``).  ``core/fastsax.py`` and
``core/search.py`` consume a *stack* of registered names generically.

Soundness contract, for any z-normalised series ``u`` and query ``q``:
``lower_bound(u, q) ≤ d(u, q)``, so a kill never drops a true answer.
The registrations:

  * ``linfit_residual`` — the residual gap |d(u,ū) − d(q,q̄)| (paper
    eq. 9, exclusion condition C9);
  * ``sax_word`` — MINDIST over the SAX word (paper eq. 10, C10);
  * ``trend_slope`` — symbols of the per-segment least-squares slope,
    with a MINDIST-style slope bound (the reference's first registration
    beyond the paper).

Every stack must contain the paper pair, and gap-kind representations run
before word-kind ones (C9 → C10).  The host engines take any stack; the
device engines build only the paper pair and refuse a longer stack
(``engine.extended_stack_error``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from . import cost_model as cm
from . import polyfit
from .paa import paa, paa_np, row_sum
from .sax import discretize, discretize_np, mindist_table


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    """Store-column schema of one representation: ``prefix`` names the
    per-level column (``{prefix}_N{N}.npy``), ``dtypes`` the accepted
    types (the first is written), ``per_segment`` a (B, N) symbol column
    against a (B,) scalar one, ``quantizable`` whether the resident tier
    may narrow it."""

    prefix: str
    dtypes: tuple
    per_segment: bool
    quantizable: bool


class Representation:
    """Base class of a registered cascade representation.

    ``kind`` is ``"gap"`` (scalar column, C9-style |a − b| > ε exclusion)
    or ``"word"`` (per-segment symbol column, C10-style squared bound >
    ε² exclusion).  ``canonical_field`` names the index field of the two
    paper representations (``"residuals"`` / ``"words"``); extras ride in
    the ``extra`` dicts keyed by name.
    """

    name: str = ""
    kind: str = "word"
    canonical_field: str | None = None
    column: ColumnSpec = None
    residual_rule: str = ""

    # -- symbolization ----------------------------------------------------
    def symbolize_np(self, series: np.ndarray, N: int, alphabet: int):
        """Host float64 column for a (B, n) batch (or an (n,) query)."""
        raise NotImplementedError

    def query_repr_np(self, q: np.ndarray, N: int, alphabet: int):
        """Host query-side value: a float (gap) or (N,) int32 (word)."""
        raise NotImplementedError

    def symbolize_dev(self, x: torch.Tensor, N: int, alphabet: int):
        """Device float32 column for a (B, n) or (Q, n) tensor."""
        raise NotImplementedError

    # -- lower bounds ------------------------------------------------------
    def host_gap(self, col: np.ndarray, qval) -> np.ndarray:
        """Gap-kind lower bound in distance units."""
        raise NotImplementedError

    def host_bound_sq(self, col: np.ndarray, qval, *, n: int, N: int,
                      alphabet: int) -> np.ndarray:
        """Word-kind squared lower bound."""
        raise NotImplementedError

    def host_lower_bound(self, col: np.ndarray, qval, *, n: int, N: int,
                         alphabet: int) -> np.ndarray:
        """Lower bound on d(u, q) in distance units, either kind."""
        if self.kind == "gap":
            return self.host_gap(col, qval)
        return np.sqrt(self.host_bound_sq(col, qval, n=n, N=N,
                                          alphabet=alphabet))

    def dev_gap(self, col: torch.Tensor, qcol: torch.Tensor) -> torch.Tensor:
        """(Q, B) device gap — gap-kind only."""
        raise NotImplementedError

    def dev_bound_sq(self, col: torch.Tensor, qcol: torch.Tensor, *, n: int,
                     N: int, tab: torch.Tensor) -> torch.Tensor:
        """(Q, B) device squared bound — word-kind only; ``tab`` is the
        (α, α) float32 MINDIST table on the columns' device."""
        raise NotImplementedError

    # -- cost-model hooks --------------------------------------------------
    def exclude_cost(self, n: int, N: int, alphabet: int) -> dict:
        """Per-candidate op dict of one exclusion test at this level."""
        raise NotImplementedError

    def query_cost(self, n: int, N: int, alphabet: int) -> dict:
        """Per-query op dict of the online transform at this level."""
        raise NotImplementedError

    #: Optional: symbolize every window of a stream from the cumsum window
    #: statistics (the reference's ``core/subseq._window_level``).
    window_symbolize_np: Callable | None = None


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
    if rep.column is None:
        raise ValueError(f"{rep.name}: missing ColumnSpec")
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


def stack_reps(stack) -> tuple:
    """The validated stack resolved to representation objects."""
    return tuple(get(name) for name in validate_stack(stack))


def extra_names(stack) -> tuple:
    """Stack names beyond the paper pair, in stack order."""
    return tuple(n for n in validate_stack(stack)
                 if get(n).canonical_field is None)


def linfit_residual_sq(x, n_segments: int, backend: str = "numpy"):
    """Squared per-segment linear-fit residual ‖u − ū‖², dispatched:
    ``"numpy"`` the host f64 form (op-counted engines), ``"torch"`` the
    device form (the reference's ``"xla"``), ``"cuda"`` the kernel
    wrapper ``kernels/level_ops.linfit_residual_sq`` (the reference's
    ``"pallas"``), which runs its plain version on a CPU tensor.  All
    evaluate the same closed form and agree to f32 rounding."""
    if backend == "numpy":
        return polyfit.linfit_residual_sq_np(np.asarray(x), n_segments)
    if backend == "torch":
        return polyfit.linfit_residual_sq(x, n_segments)
    if backend == "cuda":
        from ..kernels import level_ops
        return level_ops.linfit_residual_sq(x, n_segments)
    raise ValueError(f"unknown linfit backend {backend!r} "
                     "(want numpy|torch|cuda)")


def _gather_bound_sq(col, qcol, tab):
    """(Q, B) Σᵢ tab[colᵢ, qcolᵢ]² on the device."""
    cell = tab[col.long()[None, :, :], qcol.long()[:, None, :]]
    return row_sum(cell * cell)


class LinfitResidualRepr(Representation):
    """Paper C9: residual distance to the optimal per-segment LS line.
    Bound: |d(u,ū) − d(q,q̄)| ≤ d(u,q) (paper eq. 9)."""

    name = "linfit_residual"
    kind = "gap"
    canonical_field = "residuals"
    column = ColumnSpec(prefix="resid", dtypes=("float64", "float32"),
                        per_segment=False, quantizable=True)
    residual_rule = ("gap = |d(u,ū) − d(q,q̄)|; kill iff gap > ε "
                     "(paper eq. 9, condition C9)")

    def symbolize_np(self, series, N, alphabet):
        return polyfit.linfit_residual_np(series, N).astype(np.float64)

    def query_repr_np(self, q, N, alphabet):
        return float(polyfit.linfit_residual_np(q, N))

    def symbolize_dev(self, x, N, alphabet):
        return polyfit.linfit_residual(x, N).to(torch.float32)

    def host_gap(self, col, qval):
        return np.abs(col - qval)

    def dev_gap(self, col, qcol):
        return torch.abs(col[None, :] - qcol[:, None])

    def exclude_cost(self, n, N, alphabet):
        return cm.c9_cost()

    def query_cost(self, n, N, alphabet):
        return cm.linfit_residual_cost(n, N)


class SaxWordRepr(Representation):
    """Paper C10: MINDIST over the SAX word.
    Bound: (n/N)·Σᵢ tab[uᵢ, qᵢ]² ≤ d(u,q)² (paper eq. 3)."""

    name = "sax_word"
    kind = "word"
    canonical_field = "words"
    column = ColumnSpec(prefix="words", dtypes=("int32",),
                        per_segment=True, quantizable=True)
    residual_rule = ("MINDIST²(sax(u), sax(q)) = (n/N)·Σ tab[uᵢ,qᵢ]²; "
                     "kill iff MINDIST² > ε² (paper eq. 10, C10)")

    def symbolize_np(self, series, N, alphabet):
        return discretize_np(paa_np(series, N), alphabet)

    def query_repr_np(self, q, N, alphabet):
        return discretize_np(paa_np(q, N), alphabet)

    def symbolize_dev(self, x, N, alphabet):
        return discretize(paa(x, N), alphabet)

    def host_bound_sq(self, col, qval, *, n, N, alphabet):
        tab = mindist_table(alphabet)
        cell = tab[col, np.asarray(qval)[None, :]]
        return (n / N) * np.sum(cell * cell, axis=-1)

    def dev_bound_sq(self, col, qcol, *, n, N, tab):
        return (n / N) * _gather_bound_sq(col, qcol, tab)

    def exclude_cost(self, n, N, alphabet):
        return cm.mindist_cost(N)

    def query_cost(self, n, N, alphabet):
        return _merge_costs(cm.paa_cost(n, N),
                            cm.discretize_cost(N, alphabet))


def _trend_scaled_slope_np(series: np.ndarray, N: int) -> np.ndarray:
    """Per-segment slope·√Sxx of the LS line, host f64."""
    n = series.shape[-1]
    if n % N != 0:
        raise ValueError(f"n_segments must divide n: n={n}, N={N}")
    L = n // N
    segs = series.reshape(*series.shape[:-1], N, L)
    if L == 1:
        return np.zeros(segs.shape[:-1], dtype=np.float64)
    xc = np.arange(L, dtype=np.float64) - (L - 1) / 2.0
    sxx = float(np.sum(xc * xc))
    return (segs @ xc) / np.sqrt(sxx)


class TrendSlopeRepr(Representation):
    """Trend-aware level: symbols of the per-segment LS slope.

    Column: (B, N) int32 symbols of ``slope·√Sxx`` discretized with the
    Gaussian breakpoints.  The orthogonal projection onto the per-segment
    linear class gives ``d(u,q)² ≥ Σᵢ (Δ(slopeᵢ·√Sxx))²``, and symbols
    more than one bin apart imply ``|Δ(slope·√Sxx)| ≥ tab[uᵢ, qᵢ]``, so
    ``Σᵢ tab[uᵢ,qᵢ]² ≤ d(u,q)²`` (no n/N factor: the slope deviations are
    already in distance units).
    """

    name = "trend_slope"
    kind = "word"
    canonical_field = None
    column = ColumnSpec(prefix="twords", dtypes=("int32",),
                        per_segment=True, quantizable=True)
    residual_rule = ("TLB²(u, q) = Σ tab[tsym(u)ᵢ, tsym(q)ᵢ]² with "
                     "tsym = discretize(slope·√Sxx); kill iff TLB² > ε²")

    def symbolize_np(self, series, N, alphabet):
        return discretize_np(_trend_scaled_slope_np(series, N), alphabet)

    def query_repr_np(self, q, N, alphabet):
        return discretize_np(_trend_scaled_slope_np(q, N), alphabet)

    def symbolize_dev(self, x, N, alphabet):
        segs, L = polyfit._segments(x, N)
        if L == 1:
            scaled = torch.zeros(segs.shape[:-1], dtype=x.dtype,
                                 device=x.device)
        else:
            xc_np = np.arange(L, dtype=np.float64) - (L - 1) / 2.0
            xc = torch.as_tensor(xc_np, dtype=x.dtype, device=x.device)
            scaled = row_sum(segs * xc) / math.sqrt(float(np.sum(xc_np ** 2)))
        return discretize(scaled, alphabet)

    def host_bound_sq(self, col, qval, *, n, N, alphabet):
        tab = mindist_table(alphabet)
        cell = tab[col, np.asarray(qval)[None, :]]
        return np.sum(cell * cell, axis=-1)

    def dev_bound_sq(self, col, qcol, *, n, N, tab):
        return _gather_bound_sq(col, qcol, tab)

    def exclude_cost(self, n, N, alphabet):
        return dict(lookup=N, mul=N, add=N - 1, cmp=1)

    def query_cost(self, n, N, alphabet):
        return dict(mul=n, add=n - N, div=N, sqrt=1,
                    cmp=N * math.ceil(math.log2(alphabet)))

    @staticmethod
    def window_symbolize_np(ws) -> np.ndarray:
        """Window symbols from the cumsum statistics ``ws`` (fields
        ``L``, ``sum_y``, ``sxy``, ``sd``, ``sxx``, ``alphabet``): the
        scaled slope of the z window is ``sxy / (σ·√Sxx)``; an L == 1
        level takes the symbol of a zero slope."""
        if ws.L == 1:
            scaled = np.zeros(ws.sum_y.shape, dtype=np.float64)
        else:
            scaled = ws.sxy / (ws.sd[..., None] * np.sqrt(ws.sxx))
        return discretize_np(scaled, ws.alphabet)


def _merge_costs(*dicts) -> dict:
    out: dict = {}
    for d in dicts:
        for op, c in d.items():
            out[op] = out.get(op, 0) + c
    return out


register(LinfitResidualRepr())
register(SaxWordRepr())
register(TrendSlopeRepr())
