"""The port's token pipeline (``repro_torch.data.tokens``) on the CPU.

The reference draws with ``jax.random`` and the port with a torch
``Generator``, so the streams differ; the port is held to the properties
``tests/test_data.py`` checks of the reference's (determinism per
(seed, step), range, the Zipf marginal, the repetition rate), and its
``_zipf_inverse_cdf`` to the reference's on the same uniforms."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as ref_tokens
from repro_torch.data.tokens import (TokenPipeline, TokenPipelineConfig,
                                     _step_seed, _zipf_inverse_cdf)


def test_deterministic_and_in_range():
    cfg = TokenPipelineConfig(vocab_size=1000, global_batch=4, seq_len=64,
                              seed=3)
    pipe = TokenPipeline(cfg, "cpu")
    b1 = pipe.batch_at(17)["tokens"]
    b2 = TokenPipeline(cfg, "cpu").batch_at(17)["tokens"]
    assert torch.equal(b1, b2)
    assert b1.shape == (4, 64) and b1.dtype == torch.int64
    assert int(b1.min()) >= 0 and int(b1.max()) < 1000
    assert not torch.equal(b1, pipe.batch_at(18)["tokens"])
    other = TokenPipelineConfig(vocab_size=1000, global_batch=4, seq_len=64,
                                seed=4)
    assert not torch.equal(b1, TokenPipeline(other, "cpu").batch_at(17)[
        "tokens"])


def test_step_seeds_are_distinct():
    seeds = {_step_seed(s, k) for s in range(4) for k in range(2000)}
    assert len(seeds) == 8000
    assert all(0 <= x < 2 ** 63 for x in seeds)


def test_zipf_marginal_and_repetition():
    cfg = TokenPipelineConfig(vocab_size=5000, global_batch=16, seq_len=512,
                              seed=0)
    t = TokenPipeline(cfg, "cpu").batch_at(0)["tokens"].numpy()
    counts = np.bincount(t.ravel(), minlength=5000)
    assert counts.max() > 20 * max(1, int(np.median(counts[counts > 0])))
    rep = (t[:, 1:] == t[:, :-1]).mean()
    assert rep > 0.01
    # The marginal follows the quantile: rank 0's share is the
    # continuous law's P(rank < 1) = (2^(1-a) - 1) / ((V+1)^(1-a) - 1),
    # thinned by the copies (which keep the marginal of a past token).
    a = cfg.zipf_a
    p0 = (2 ** (1 - a) - 1) / ((5001) ** (1 - a) - 1)
    assert abs(counts[0] / t.size - p0) < 0.1 * p0


def test_repetition_rate_matches_the_law():
    """P(token copied) = repeat_p at positions > 0, so adjacent equality
    is at least repeat_p / repeat_window (a lag of 1)."""
    cfg = TokenPipelineConfig(vocab_size=50_000, global_batch=32,
                              seq_len=256, seed=1)
    t = TokenPipeline(cfg, "cpu").batch_at(5)["tokens"].numpy()
    rep = (t[:, 1:] == t[:, :-1]).mean()
    assert rep > 0.8 * cfg.repeat_p / cfg.repeat_window


@pytest.mark.parametrize("vocab,a", [(256, 1.1), (49155, 1.1), (5000, 1.5)])
def test_zipf_inverse_cdf_matches_reference(vocab, a):
    """On the same f32 uniforms the ranks are equal, or one apart where
    the f32 value sits within an ulp of an integer (the two f32 ``pow``s
    may round apart).  Measured: 0, 1 and 1 of 200,000 differ."""
    u = np.random.default_rng(0).random(200_000, dtype=np.float32)
    got = _zipf_inverse_cdf(torch.tensor(u), vocab, a).numpy()
    want = np.asarray(ref_tokens._zipf_inverse_cdf(jnp.asarray(u), vocab, a))
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).sum() <= 20, int((diff > 0).sum())
    assert got.min() >= 0 and got.max() <= vocab - 1
