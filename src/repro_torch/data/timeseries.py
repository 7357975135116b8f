"""Synthetic wafer-like time series, the benchmark database.

Counterpart of ``repro/data/timeseries.py`` (``make_wafer_like``,
``make_queries``), the same numpy code, so one seed gives the same data
in both packages.  The generator stands in for the UCR *wafer* dataset
the paper reports on: a few process prototypes that series cluster
around, heteroscedastic noise (which spreads the linear-fit residual
C9 exploits), and a small fraction of transient-spike anomalies.
"""
from __future__ import annotations

import numpy as np

from ..core.paa import znormalize_np

WAFER_SIZE = 6164     # largest UCR dataset at the time — paper §4
WAFER_LENGTH = 152    # true UCR wafer length
DEFAULT_LENGTH = 128  # synthetic default: gives power-of-two PAA levels


def make_wafer_like(
    n_series: int = WAFER_SIZE,
    length: int = DEFAULT_LENGTH,
    n_prototypes: int = 32,
    noise_lo: float = 0.02,
    noise_hi: float = 0.4,
    anomaly_frac: float = 0.02,
    seed: int = 0,
    normalize: bool = True,
) -> np.ndarray:
    """Synthetic wafer-like database: (n_series, length) float64.

    Per-series noise amplitude is log-uniform in [noise_lo, noise_hi]."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, length)

    protos = np.empty((n_prototypes, length))
    for k in range(n_prototypes):
        ramp_at = rng.uniform(0.1, 0.4)
        drop_at = rng.uniform(0.6, 0.9)
        level = rng.uniform(0.5, 2.0)
        slope = rng.uniform(-0.5, 0.5)
        sig = level / (1 + np.exp(-40 * (t - ramp_at)))
        sig -= level / (1 + np.exp(-40 * (t - drop_at)))
        sig += slope * t
        ripple_amp = rng.uniform(0.0, 0.35)
        sig += ripple_amp * np.sin(
            2 * np.pi * rng.integers(4, 16) * t + rng.uniform(0, 2 * np.pi))
        protos[k] = sig

    assign = rng.integers(0, n_prototypes, size=n_series)
    noise = np.exp(rng.uniform(np.log(noise_lo), np.log(noise_hi),
                               size=(n_series, 1)))
    x = protos[assign] + noise * rng.standard_normal((n_series, length))

    n_anom = int(anomaly_frac * n_series)
    if n_anom:
        rows = rng.choice(n_series, size=n_anom, replace=False)
        for r in rows:
            pos = rng.integers(5, length - 5)
            width = rng.integers(2, 6)
            x[r, pos:pos + width] += rng.uniform(1.0, 3.0) * rng.choice([-1, 1])

    return znormalize_np(x) if normalize else x


def make_queries(
    database: np.ndarray,
    n_queries: int,
    noise: float = 0.05,
    seed: int = 1,
) -> np.ndarray:
    """Queries near database members (the paper's range-query regime)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, database.shape[0], size=n_queries)
    q = database[rows] + noise * rng.standard_normal(
        (n_queries, database.shape[1]))
    return znormalize_np(q)
