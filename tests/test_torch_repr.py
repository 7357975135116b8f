"""Parity of the port's representation layer with the reference.

The same numpy inputs, made from seeds, go through ``repro`` (JAX on the
CPU) and ``repro_torch`` (PyTorch on the CPU).  Host float64 code is the
same arithmetic in both packages, so its results must be equal; device
float32 forms may differ by the order of their sums, and each tolerance
below says why it is what it is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import fastsax as jfs
from repro.core import paa as jpaa
from repro.core import polyfit as jpoly
from repro.core import sax as jsax
from repro.data.timeseries import make_wafer_like as j_make_wafer_like
from repro_torch.core import engine as teng
from repro_torch.core import fastsax as tfs
from repro_torch.core import paa as tpaa
from repro_torch.core import polyfit as tpoly
from repro_torch.core import representation as trep
from repro_torch.core import sax as tsax
from repro_torch.data.timeseries import make_wafer_like, make_queries

ALPHABETS = (3, 10, 20)


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_breakpoints_and_table_equal(alphabet):
    np.testing.assert_array_equal(tsax.breakpoints(alphabet),
                                  jsax.breakpoints(alphabet))
    np.testing.assert_array_equal(tsax.mindist_table(alphabet),
                                  jsax.mindist_table(alphabet))
    rng = np.random.default_rng(alphabet)
    s, t = rng.integers(0, alphabet, (2, 16)).astype(np.int32)
    assert tsax.mindist_np(s, t, 128, alphabet) == \
        jsax.mindist_np(s, t, 128, alphabet)


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_discretize_equal_including_breakpoint_ties(alphabet):
    # Values exactly on the float32 breakpoints and one ulp either side:
    # the reference casts β to f32 and searches on the right side, so a
    # value equal to a breakpoint goes up.  Words must be equal exactly.
    beta32 = jsax.breakpoints(alphabet).astype(np.float32)
    ties = np.concatenate([beta32, np.nextafter(beta32, np.float32(-9)),
                           np.nextafter(beta32, np.float32(9))])
    rng = np.random.default_rng(alphabet)
    x = np.concatenate([ties, rng.standard_normal(500).astype(np.float32) * 2])
    # The middle breakpoint of an even alphabet is 0, whose neighbours are
    # subnormal: XLA on the CPU flushes subnormals to zero and PyTorch
    # does not.  No PAA mean of a real series is subnormal.
    x = x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]
    want = np.asarray(jsax.discretize(jnp.asarray(x), alphabet))
    got = tsax.discretize(torch.as_tensor(x), alphabet).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(tsax.discretize_np(x.astype(np.float64),
                                                     alphabet),
                                  jsax.discretize_np(x.astype(np.float64),
                                                     alphabet))


def test_data_generators_equal():
    np.testing.assert_array_equal(make_wafer_like(64, 128, seed=3),
                                  j_make_wafer_like(64, 128, seed=3))
    from repro.data.timeseries import make_queries as j_make_queries
    db = make_wafer_like(64, 128, seed=3)
    np.testing.assert_array_equal(make_queries(db, 5, seed=4),
                                  j_make_queries(db, 5, seed=4))


@pytest.mark.parametrize("N", [4, 8, 16])
def test_paa_and_znormalize(N):
    rng = np.random.default_rng(N)
    x = (rng.standard_normal((37, 128)) * 3 + 1).astype(np.float32)
    # f32 means of 128/N values: the two frameworks may sum in another
    # order, a few ulps of values of size ~5.
    np.testing.assert_allclose(tpaa.paa(torch.as_tensor(x), N).numpy(),
                               np.asarray(jpaa.paa(jnp.asarray(x), N)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tpaa.paa_np(x.astype(np.float64), N),
                                  jpaa.paa_np(x.astype(np.float64), N))
    # Population standard deviation (ddof=0), as the reference: an
    # unbiased estimator would be off by sqrt(128/127) ≈ 0.4 %.
    zt = tpaa.znormalize(torch.as_tensor(x)).numpy()
    zj = np.asarray(jpaa.znormalize(jnp.asarray(x)))
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zt.std(axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(tpaa.znormalize_np(x.astype(np.float64)),
                                  jpaa.znormalize_np(x.astype(np.float64)))


@pytest.mark.parametrize("N", [8, 16, 64, 128])     # L = 16, 8, 2, 1
def test_linfit_residual_sq(N):
    x = make_wafer_like(53, 128, seed=N)
    got = tpoly.linfit_residual_sq(torch.as_tensor(x, dtype=torch.float32),
                                   N).numpy()
    want = np.asarray(jpoly.linfit_residual_sq(jnp.asarray(x, jnp.float32), N))
    # Σy² − L·mean² − Sxy²/Sxx cancels terms of size ~L per segment, so
    # f32 results agree to ~1e-5 of the segment energy (n = 128 in all),
    # not relative to the (small) residual itself.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-4)
    if N >= 64:        # L ≤ 2: a line fits every segment exactly
        assert np.all(np.abs(got) < 1e-3)
    np.testing.assert_array_equal(tpoly.linfit_residual_sq_np(x, N),
                                  jpoly.linfit_residual_sq_np(x, N))


@pytest.mark.parametrize("level_order", ["coarse_first", "paper"])
def test_host_build_index_and_query(level_order):
    db = make_wafer_like(300, 128, seed=5)
    tcfg = tfs.FastSAXConfig(n_segments=(4, 8, 16), alphabet=10,
                             level_order=level_order)
    jcfg = jfs.FastSAXConfig(n_segments=(4, 8, 16), alphabet=10,
                             level_order=level_order)
    ti, ji = tfs.build_index(db, tcfg), jfs.build_index(db, jcfg)
    np.testing.assert_array_equal(ti.series, ji.series)
    assert [lv.n_segments for lv in ti.levels] == \
        [lv.n_segments for lv in ji.levels]
    for tl, jl in zip(ti.levels, ji.levels):
        np.testing.assert_array_equal(tl.words, jl.words)
        np.testing.assert_allclose(tl.residuals, jl.residuals, rtol=1e-6)
    q = make_queries(db, 1, seed=6)[0]
    tq, jq = tfs.represent_query(q, tcfg), jfs.represent_query(q, jcfg)
    np.testing.assert_array_equal(tq.q, jq.q)
    for a, b in zip(tq.words, jq.words):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tq.residuals, jq.residuals, rtol=1e-6)


def test_device_build_and_query_representation():
    # The on-device (f32) build of both packages from the same raw data:
    # words may only differ where a PAA mean sits within f32 rounding of
    # a breakpoint, which this data never does; residuals as above.
    raw = make_wafer_like(200, 128, seed=7, normalize=False)
    ti = teng.build_device_index(raw, (8, 16), 10, device="cpu")
    ji = jeng.build_device_index(jnp.asarray(raw, jnp.float32), (8, 16), 10)
    np.testing.assert_allclose(ti.series.numpy(), np.asarray(ji.series),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.norms_sq.numpy(), np.asarray(ji.norms_sq),
                               rtol=1e-5)
    for li in range(2):
        np.testing.assert_array_equal(ti.words[li].numpy(),
                                      np.asarray(ji.words[li]))
        np.testing.assert_allclose(ti.residuals[li].numpy(),
                                   np.asarray(ji.residuals[li]),
                                   rtol=1e-4, atol=1e-4)
    q = raw[:9] + 0.1
    tq = teng.represent_queries(torch.as_tensor(q, dtype=torch.float32),
                                (8, 16), 10)
    jq = jeng.represent_queries(jnp.asarray(q, jnp.float32), (8, 16), 10)
    np.testing.assert_allclose(tq.q.numpy(), np.asarray(jq.q), rtol=1e-5,
                               atol=1e-5)
    for li in range(2):
        np.testing.assert_array_equal(tq.words[li].numpy(),
                                      np.asarray(jq.words[li]))
        np.testing.assert_allclose(tq.residuals[li].numpy(),
                                   np.asarray(jq.residuals[li]),
                                   rtol=1e-4, atol=1e-4)


def test_stack_validation_and_config_errors():
    assert trep.validate_stack(trep.DEFAULT_STACK) == trep.DEFAULT_STACK
    with pytest.raises(ValueError, match="backbone"):
        trep.validate_stack(("sax_word",))
    with pytest.raises(ValueError, match="gap-kind"):
        trep.validate_stack(("sax_word", "linfit_residual"))
    # trend_slope is registered, and the device build carries its column
    # as the reference's does (word symbols, int32, per level).
    ext = trep.DEFAULT_STACK + ("trend_slope",)
    assert trep.validate_stack(ext) == ext
    with pytest.raises(KeyError, match="unregistered"):
        trep.validate_stack(trep.DEFAULT_STACK + ("no_such_rep",))
    x = make_wafer_like(8, 64, seed=0)
    dev = teng.build_device_index(x, (8,), 10, stack=ext, device="cpu")
    want = jeng.build_device_index(jnp.asarray(x, jnp.float32), (8,), 10,
                                   stack=ext)
    assert dev.stack == ext and set(dev.extra[0]) == {"trend_slope"}
    assert dev.extra[0]["trend_slope"].dtype == torch.int32
    np.testing.assert_array_equal(dev.extra[0]["trend_slope"].numpy(),
                                  np.asarray(want.extra[0]["trend_slope"]))
    with pytest.raises(ValueError, match="ascending"):
        tfs.FastSAXConfig(n_segments=(8, 8))
    with pytest.raises(ValueError, match="alphabet"):
        tfs.FastSAXConfig(n_segments=(8,), alphabet=2)
    # The two registrations' host bounds are sound lower bounds.
    db = make_wafer_like(50, 128, seed=8)
    q = db[0] * 0.9 + 0.1 * db[1]
    d = np.sqrt(((db - q) ** 2).sum(-1))
    for rep in (trep.get("linfit_residual"), trep.get("sax_word")):
        col = rep.symbolize_np(db, 8, 10)
        qv = rep.symbolize_np(q, 8, 10)
        lb = rep.host_lower_bound(col, qv, n=128, N=8, alphabet=10)
        assert np.all(lb <= d + 1e-9)


def test_query_representation_does_not_depend_on_the_batch():
    # The serving exactness replay represents a query alone and compares
    # with the same query represented inside its batch: bit-equal rows.
    raw = make_wafer_like(32, 128, seed=11, normalize=False) * 3 + 0.5
    q = torch.as_tensor(raw, dtype=torch.float32)
    full = teng.represent_queries(q, (8, 16), 10)
    for i in (0, 7, 31):
        one = teng.represent_queries(q[i:i + 1], (8, 16), 10)
        assert torch.equal(one.q[0], full.q[i])
        for li in range(2):
            assert torch.equal(one.words[li][0], full.words[li][i])
            assert torch.equal(one.residuals[li][0], full.residuals[li][i])
    assert torch.equal(tpaa.row_sum(q[:3, :7]),
                       torch.stack([tpaa.row_sum(r) for r in q[:3, :7]]))
    np.testing.assert_allclose(tpaa.row_sum(q).numpy(), raw.sum(-1),
                               rtol=1e-5)
