"""Symbolic Aggregate approXimation (Lin, Keogh, Lonardi, Chiu 2003).

Counterpart of ``repro/core/sax.py``.  Breakpoints are standard-Gaussian
quantiles producing equiprobable regions; MINDIST (paper eq. 3) uses the
precomputed cell-distance lookup table.  The host math is float64 numpy;
:func:`discretize` is the device form on float32 tensors.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .paa import paa, row_sum

MIN_ALPHABET = 3   # smallest size tested for the original SAX (paper §4)
MAX_ALPHABET = 20  # largest size in the second SAX version (paper §4)


def _ndtri_scalar(p: float) -> float:
    """Inverse standard-normal CDF (Acklam 2003 + one Halley refinement via
    math.erf), host float64 — the same arithmetic as the reference."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        ql = math.sqrt(-2 * math.log(p))
        x = ((((((c[0]*ql+c[1])*ql+c[2])*ql+c[3])*ql+c[4])*ql+c[5]) /
             ((((d[0]*ql+d[1])*ql+d[2])*ql+d[3])*ql+1))
    elif p <= phigh:
        qm = p - 0.5
        r = qm * qm
        x = ((((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*qm /
             (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1))
    else:
        qh = math.sqrt(-2 * math.log(1 - p))
        x = -((((((c[0]*qh+c[1])*qh+c[2])*qh+c[3])*qh+c[4])*qh+c[5]) /
              ((((d[0]*qh+d[1])*qh+d[2])*qh+d[3])*qh+1))
    # Halley refinement: e = Φ(x) − p, u = e·√(2π)·exp(x²/2)
    e = 0.5 * (1 + math.erf(x / math.sqrt(2))) - p
    u = e * math.sqrt(2 * math.pi) * math.exp(x * x / 2)
    return x - u / (1 + x * u / 2)


@functools.lru_cache(maxsize=64)
def breakpoints(alphabet: int) -> np.ndarray:
    """Gaussian-quantile breakpoints β_1..β_{α−1} (equal-area regions)."""
    if not MIN_ALPHABET <= alphabet <= MAX_ALPHABET:
        raise ValueError(f"alphabet must be in [{MIN_ALPHABET},{MAX_ALPHABET}]")
    return np.asarray([_ndtri_scalar(k / alphabet) for k in range(1, alphabet)],
                      dtype=np.float64)


@functools.lru_cache(maxsize=64)
def mindist_table(alphabet: int) -> np.ndarray:
    """dist(r,c) lookup table: 0 if |r−c| ≤ 1 else β_{max(r,c)−1} − β_{min(r,c)}."""
    beta = breakpoints(alphabet)
    tab = np.zeros((alphabet, alphabet), dtype=np.float64)
    for r in range(alphabet):
        for c in range(alphabet):
            if abs(r - c) > 1:
                tab[r, c] = beta[max(r, c) - 1] - beta[min(r, c)]
    return tab


def discretize(paa_values: torch.Tensor, alphabet: int) -> torch.Tensor:
    """PAA values -> int32 symbol ids in [0, alphabet) via the breakpoints.

    The breakpoints are cast to float32 first and the search takes the
    right side, as the reference does (``jnp.searchsorted(side="right")``
    on float32 breakpoints): a value equal to a breakpoint goes up."""
    beta = torch.as_tensor(breakpoints(alphabet), dtype=torch.float32,
                           device=paa_values.device)
    x = paa_values.to(torch.float32).contiguous()
    return torch.searchsorted(beta, x, right=True).to(torch.int32)


def sax_transform(x: torch.Tensor, n_segments: int,
                  alphabet: int) -> torch.Tensor:
    """Full SAX: (already z-normalised) series (..., n) -> symbols (..., N)."""
    return discretize(paa(x, n_segments), alphabet)


def _cells(s: torch.Tensor, t: torch.Tensor, alphabet: int) -> torch.Tensor:
    tab = torch.as_tensor(mindist_table(alphabet), dtype=torch.float32,
                          device=s.device)
    return tab[s.long(), t.long()]


def mindist(s: torch.Tensor, t: torch.Tensor, n: int,
            alphabet: int) -> torch.Tensor:
    """MINDIST(ŝ, t̂) (paper eq. 3).  s, t: (..., N) int symbols; the
    table in float32 as the reference's, the sum in :func:`row_sum`'s
    order."""
    N = s.shape[-1]
    cell = _cells(s, t, alphabet)
    return math.sqrt(n / N) * torch.sqrt(row_sum(cell * cell))


def mindist_sq_batch(db_symbols: torch.Tensor, query_symbols: torch.Tensor,
                     n: int, alphabet: int) -> torch.Tensor:
    """Squared MINDIST of one query word (N,) against a batch (B, N),
    scaled by n/N: compared with ε², it prunes as MINDIST with ε does and
    saves one square root per candidate."""
    N = db_symbols.shape[-1]
    cell = _cells(db_symbols, query_symbols[None, :], alphabet)
    return (n / N) * row_sum(cell * cell)


# NumPy twins (host float64) -------------------------------------------------

def discretize_np(paa_values: np.ndarray, alphabet: int) -> np.ndarray:
    beta = breakpoints(alphabet)
    return np.searchsorted(beta, paa_values, side="right").astype(np.int32)


def mindist_np(s: np.ndarray, t: np.ndarray, n: int, alphabet: int) -> float:
    """MINDIST(ŝ, t̂) (paper eq. 3) of two (N,) symbol words."""
    N = s.shape[-1]
    tab = mindist_table(alphabet)
    cell = tab[s, t]
    return float(np.sqrt(n / N) * np.sqrt(np.sum(cell * cell, axis=-1)))
