"""Piecewise Aggregate Approximation and z-normalisation.

Counterpart of ``repro/core/paa.py``.  PAA divides a length-n series into
N equal frames and keeps the frame means; the PAA distance lower-bounds
the Euclidean distance, which makes every SAX/MINDIST bound sound.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _check_segments(n: int, n_segments: int):
    if n % n_segments != 0:
        raise ValueError(f"PAA needs n_segments | n, got n={n}, N={n_segments}")


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed pairwise order built from
    elementwise adds.  A library reduction picks its summation order from
    the tensor's shape, so a query represented inside a batch could come
    out an ulp away from the same query represented alone — and the
    serving exactness replay compares the two.  Here each row's result
    depends on that row only."""
    while x.shape[-1] > 1:
        w = x.shape[-1]
        h = w // 2
        s = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([s, x[..., 2 * h:]], dim=-1) if w % 2 else s
    return x[..., 0]


def paa(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """PAA transform.  x: (..., n) -> (..., N).  Requires N | n."""
    n = x.shape[-1]
    _check_segments(n, n_segments)
    L = n // n_segments
    return row_sum(x.reshape(*x.shape[:-1], n_segments, L)) / L


def paa_np(x: np.ndarray, n_segments: int) -> np.ndarray:
    n = x.shape[-1]
    _check_segments(n, n_segments)
    return x.reshape(*x.shape[:-1], n_segments, n // n_segments).mean(axis=-1)


def paa_dist(px: torch.Tensor, py: torch.Tensor, n: int) -> torch.Tensor:
    """PAA lower-bound distance (paper eq. 4): sqrt(n/N)·‖px − py‖₂, the
    sum in :func:`row_sum`'s order."""
    N = px.shape[-1]
    d = px - py
    return math.sqrt(n / N) * torch.sqrt(row_sum(d * d))


def znormalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Z-normalise along the last axis (SAX step 1), each row on its own
    (:func:`row_sum`).  The standard deviation is the population one
    (ddof = 0), as in the reference — ``torch.std`` would default to the
    unbiased estimator."""
    n = x.shape[-1]
    mu = row_sum(x)[..., None] / n
    dev = x - mu
    sd = torch.sqrt(row_sum(dev * dev)[..., None] / n)
    return dev / torch.clamp(sd, min=eps)


def znormalize_np(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    mu = x.mean(axis=-1, keepdims=True)
    sd = x.std(axis=-1, keepdims=True)
    return (x - mu) / np.maximum(sd, eps)
