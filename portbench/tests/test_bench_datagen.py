"""The data generators are seeded: one seed gives the same data, two
seeds different data; the mix has the same kinds for every seed."""
import numpy as np
import pytest
import torch

from portbench import datagen

SEED = 2 ** 31 + 987654321          # seeds past 32 signed bits work too


@pytest.mark.parametrize("shape", [(3, 1000), (2048, 256)])
def test_random_walks_are_seeded(shape):
    g = lambda s: datagen.random_walks(*shape, datagen.generator(s, "cpu"))
    a, b, c = g(SEED), g(SEED), g(SEED + 1)
    assert a.dtype == torch.float32 and a.shape == shape
    assert torch.equal(a, b) and not torch.equal(a, c)
    steps = torch.diff(a.double(), dim=-1)
    assert abs(float(steps.std()) - 1.0) < 0.1


def test_queries_are_seeded_and_shaped():
    x = datagen.random_walks(2048, 256, datagen.generator(SEED, "cpu"))
    q1 = datagen.whole_series_queries(x, 16, datagen.generator(SEED, "cpu"))
    q2 = datagen.whole_series_queries(x, 16, datagen.generator(SEED, "cpu"))
    assert torch.equal(q1, q2) and q1.shape == (16, 256)
    assert torch.allclose(q1.double().mean(-1), torch.zeros(16, dtype=torch.float64),
                          atol=1e-5)
    s = datagen.random_walks(2, 500, datagen.generator(SEED, "cpu"))
    w1 = datagen.subseq_queries(s, 8, 64, datagen.generator(SEED, "cpu"))
    w2 = datagen.subseq_queries(s, 8, 64, datagen.generator(SEED, "cpu"))
    assert torch.equal(w1, w2) and w1.shape == (8, 64)


@pytest.mark.parametrize("eps", [[1.0, 2.0], [3.0]])
def test_request_mix_counts(eps):
    k, e = datagen.request_mix(101, 0.5, eps, datagen.generator(0, "cpu"))
    assert sum(k) == 50 and len(k) == len(e) == 101
    rng = [x for x, kn in zip(e, k) if not kn]
    assert sorted(set(rng)) == sorted(eps)
    assert abs(rng.count(eps[0]) - len(rng) / len(eps)) <= 1
    k2, e2 = datagen.request_mix(101, 0.5, eps, datagen.generator(0, "cpu"))
    assert (k, e) == (k2, e2)
    assert np.asarray(k).dtype == bool
