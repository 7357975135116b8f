"""Optimal per-segment first-degree approximation (paper §3).

Counterpart of ``repro/core/polyfit.py``.  Each series is split into N
segments and each segment is replaced by its least-squares line; the
residual distance d(u,ū) has the closed form

    with centred abscissa xc = x − (L−1)/2,  Sxx = Σ xc²:
      ‖resid‖² = Σy² − L·mean² − (Σ xc·y)²/Sxx

For L ≤ 2 the fit is exact (one point, or a line through two points).
"""
from __future__ import annotations

import numpy as np
import torch

from .paa import row_sum


def _segments(x, n_segments: int):
    n = x.shape[-1]
    if n % n_segments != 0:
        raise ValueError(f"n_segments must divide n: n={n}, N={n_segments}")
    L = n // n_segments
    return x.reshape(*x.shape[:-1], n_segments, L), L


def _centred_abscissa(seg_len: int, dtype, device):
    """xc = x − (L−1)/2 (half-integers, exact in f32) and Sxx = Σ xc²."""
    xc = np.arange(seg_len, dtype=np.float64) - (seg_len - 1) / 2.0
    return (torch.as_tensor(xc, dtype=dtype, device=device),
            float(np.sum(xc * xc)))


def linfit_coeffs(x: torch.Tensor, n_segments: int):
    """Per-segment least-squares line.  x: (..., n) -> (mean, slope),
    (..., N) each; the sums in :func:`paa.row_sum`'s order."""
    segs, L = _segments(x, n_segments)
    mean = row_sum(segs) / L
    if L == 1:
        return mean, torch.zeros_like(mean)
    xc, sxx = _centred_abscissa(L, x.dtype, x.device)
    return mean, row_sum(segs * xc) / sxx


def linfit_reconstruct(mean: torch.Tensor, slope: torch.Tensor,
                       seg_len: int) -> torch.Tensor:
    """(..., N) coefficients -> (..., N·L) piecewise-linear reconstruction
    ū."""
    xc, _ = _centred_abscissa(seg_len, mean.dtype, mean.device)
    rec = mean[..., None] + slope[..., None] * xc
    return rec.reshape(*mean.shape[:-1], mean.shape[-1] * seg_len)


def linfit_residual_sq(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Squared residual distance d(u,ū)² = Σ_seg ‖resid‖².  x: (..., n) -> (...).

    Same expression as the reference, including its L == 2 form (the
    closed form evaluated and clamped at 0, which is zero up to rounding).
    Sums run in :func:`paa.row_sum`'s fixed order, so a row's result does
    not depend on the other rows of the batch."""
    segs, L = _segments(x, n_segments)
    if L == 1:
        return torch.zeros(segs.shape[:-2], dtype=x.dtype, device=x.device)
    xc, sxx = _centred_abscissa(L, x.dtype, x.device)
    sum_y = row_sum(segs)
    sum_y2 = row_sum(segs * segs)
    mean = sum_y / L
    sxy = row_sum(segs * xc)
    per_seg = torch.clamp(sum_y2 - L * mean * mean - (sxy * sxy) / sxx, min=0.0)
    return row_sum(per_seg)


def linfit_residual(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """d(u,ū): Euclidean distance from each series to its optimal projection."""
    return torch.sqrt(linfit_residual_sq(x, n_segments))


# NumPy twins (host float64) -------------------------------------------------

def linfit_residual_sq_np(x: np.ndarray, n_segments: int) -> np.ndarray:
    segs, L = _segments(x, n_segments)
    xc = np.arange(L, dtype=np.float64) - (L - 1) / 2.0
    sxx = float(np.sum(xc * xc))
    sum_y = segs.sum(axis=-1)
    sum_y2 = np.sum(segs * segs, axis=-1)
    mean = sum_y / L
    if L == 1:
        per_seg = np.zeros_like(mean)
    else:
        sxy = segs @ xc
        per_seg = np.maximum(sum_y2 - L * mean * mean - (sxy * sxy) / sxx, 0.0)
    return per_seg.sum(axis=-1)


def linfit_residual_np(x: np.ndarray, n_segments: int) -> np.ndarray:
    return np.sqrt(linfit_residual_sq_np(x, n_segments))
