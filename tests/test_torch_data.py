"""The port's data module against the reference's, on the CPU:
``make_trending`` bit for bit, and the near-duplicate curation filter's
keep masks and statistics over a sequence of admits that crosses pool
rebuilds.

The filter's d² are f32 on both sides (the cascade's matmul-form verify,
the difference form for the brute-force tail and the batch); the inputs
keep every pair's d² at least 0.05 away from ε², far outside the f32
band 1e-3 + 1e-5·d², so the masks must be equal exactly.
"""
import numpy as np
import pytest
import torch

from repro.data import curation as jcur
from repro.data import timeseries as jts
from repro_torch.data import curation as tcur
from repro_torch.data import timeseries as tts

LENGTH = 64
EPS = 0.5


@pytest.mark.parametrize("kwargs", [
    {},
    dict(n_series=300, length=96, n_prototypes=4, n_pieces=4,
         slope_scale=1.0, noise=0.2, seed=3),
    dict(n_series=50, length=128, n_pieces=16, seed=11, normalize=False),
])
def test_make_trending_is_bit_identical(kwargs):
    got = tts.make_trending(**kwargs)
    want = jts.make_trending(**kwargs)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def admit_batches(seed=0, n_batches=10, rows=24, dup_frac=0.25):
    """Trending batches with a known share of planted near-duplicates:
    copies (plus small noise) of earlier rows of the stream, some of the
    same batch."""
    rng = np.random.default_rng(seed)
    fresh = tts.make_trending(n_batches * rows, LENGTH, seed=seed + 1)
    seen, out = [], []
    for b in range(n_batches):
        batch = fresh[b * rows:(b + 1) * rows].copy()
        for i in range(rows):
            pool = seen + [batch[j] for j in range(i)]
            if pool and rng.random() < dup_frac:
                src = pool[rng.integers(len(pool))]
                batch[i] = src + 0.01 * rng.standard_normal(LENGTH)
        seen.extend(batch)
        out.append(batch)
    return out


def min_margin(batches) -> float:
    """Smallest |d² − ε²| over every pair of z-normalised rows."""
    from repro_torch.core.paa import znormalize_np
    z = znormalize_np(np.concatenate(batches)).astype(np.float32)
    d2 = ((z[:, None, :] - z[None, :, :]) ** 2).sum(-1)
    off = ~np.eye(len(z), dtype=bool)
    return float(np.min(np.abs(d2[off] - EPS * EPS)))


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_matches_reference_across_rebuilds(seed):
    batches = admit_batches(seed)
    assert min_margin(batches) > 0.05
    got = tcur.NearDuplicateFilter(LENGTH, epsilon=EPS, device="cpu")
    want = jcur.NearDuplicateFilter(LENGTH, epsilon=EPS)
    rebuilds = 0
    for batch in batches:
        before = got._indexed_rows
        keep = got.admit(batch)
        np.testing.assert_array_equal(keep, want.admit(batch))
        rebuilds += got._indexed_rows != before
        assert got._indexed_rows == want._indexed_rows
        assert got.pool_size == want.pool_size
        assert got.stats == tcur.CurationStats(**vars(want.stats))
    assert rebuilds >= 3                  # the first build and two more
    assert 0 < got.stats.rejected_duplicates < got.stats.accepted
    np.testing.assert_array_equal(got._pool.numpy(), want._pool)
    assert got._index.device.type == "cpu"


def test_filter_rejects_planted_duplicates_within_a_batch():
    f = tcur.NearDuplicateFilter(LENGTH, epsilon=EPS, device="cpu")
    base = tts.make_trending(4, LENGTH, seed=2)
    batch = np.concatenate([base, base[:2] + 1e-3])
    np.testing.assert_array_equal(f.admit(batch), [1, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(f.admit(base[1:3] + 1e-3), [0, 0])
    assert f.stats == tcur.CurationStats(accepted=4, rejected_duplicates=4)


def test_filter_refuses_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcur.NearDuplicateFilter(LENGTH)
    assert tcur.NearDuplicateFilter(LENGTH, device="cpu").pool_size == 0
