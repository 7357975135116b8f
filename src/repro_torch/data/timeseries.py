"""Synthetic wafer-like and trending time series, the benchmark database,
and the UCR reader.

Counterpart of ``repro/data/timeseries.py`` (``make_wafer_like``,
``make_trending``, ``make_queries``, ``make_subseq_queries``,
``load_ucr``, ``benchmark_database``), the same numpy code, so one seed
gives the same data in both packages.  The generator stands in for the UCR *wafer*
dataset the paper reports on: a few process prototypes that series
cluster around, heteroscedastic noise (which spreads the linear-fit
residual C9 exploits), and a small fraction of transient-spike
anomalies.  A real UCR file is read only when ``REPRO_UCR_PATH`` names
one; nothing is downloaded.
"""
from __future__ import annotations

import os

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


def make_trending(
    n_series: int = 4096,
    length: int = DEFAULT_LENGTH,
    n_prototypes: int = 16,
    n_pieces: int = 8,
    slope_scale: float = 2.5,
    noise: float = 0.08,
    seed: int = 7,
    normalize: bool = True,
) -> np.ndarray:
    """Trending database: (n_series, length) float64.

    Series share a few smooth low-frequency prototypes, so their segment
    means cluster and the SAX word is weakly selective, but each carries
    its own continuous piecewise-linear trend, ``n_pieces`` independent
    slopes.  The per-segment least-squares slope sees that trend where the
    segment means barely do: the data the ``trend_slope`` representation
    prunes on."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, length)

    protos = np.empty((n_prototypes, length))
    for k in range(n_prototypes):
        protos[k] = (rng.uniform(0.5, 1.5)
                     * np.sin(2 * np.pi * rng.uniform(0.5, 1.5) * t
                              + rng.uniform(0, 2 * np.pi)))

    assign = rng.integers(0, n_prototypes, size=n_series)
    piece_slopes = slope_scale * rng.standard_normal((n_series, n_pieces))
    steps = np.repeat(piece_slopes, length // n_pieces, axis=-1) / length
    trend = np.cumsum(steps, axis=-1)
    trend -= trend.mean(axis=-1, keepdims=True)
    x = (protos[assign] + trend
         + noise * rng.standard_normal((n_series, length)))
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


def make_subseq_queries(
    streams: np.ndarray,
    n_queries: int,
    window: int,
    noise: float = 0.05,
    seed: int = 1,
) -> np.ndarray:
    """Window-length queries cut from random stream positions plus noise,
    the subsequence-matching regime (``core/subseq.py``).  Returned raw:
    the engines z-normalise each query, as each database window is."""
    rng = np.random.default_rng(seed)
    streams = np.asarray(streams)
    S, n = streams.shape
    rows = rng.integers(0, S, size=n_queries)
    starts = rng.integers(0, n - window + 1, size=n_queries)
    q = np.stack([streams[r, a:a + window]
                  for r, a in zip(rows, starts)])
    return q + noise * rng.standard_normal(q.shape)


def load_ucr(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read the standard UCR text format: one series per line,
    ``label, v1, v2, ...`` (comma or whitespace separated).  Returns
    ``(labels int64 (B,), series float64 (B, n))``."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            rows.append([float(p) for p in parts])
    arr = np.asarray(rows, dtype=np.float64)
    return arr[:, 0].astype(np.int64), arr[:, 1:]


def benchmark_database(length: int = DEFAULT_LENGTH,
                       seed: int = 0) -> np.ndarray:
    """The database the benchmarks use: the UCR file ``REPRO_UCR_PATH``
    names, z-normalised, when that is set and exists; else the synthetic
    wafer-like stand-in of ``WAFER_SIZE`` series of ``length``."""
    path = os.environ.get("REPRO_UCR_PATH", "")
    if path and os.path.exists(path):
        _, series = load_ucr(path)
        return znormalize_np(series)
    return make_wafer_like(length=length, seed=seed)
