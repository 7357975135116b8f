"""The paper's distance functions in the port's core (``paa.paa_dist``,
``sax.sax_transform`` / ``mindist`` / ``mindist_sq_batch``,
``polyfit.linfit_coeffs`` / ``linfit_reconstruct``) against the
reference's on the same inputs, on the CPU, in f32.  Symbols are equal;
distances agree within f32 rounding (rtol 1e-5: the port sums in
``paa.row_sum``'s order, the reference in XLA's)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paa as ref_paa
from repro.core import polyfit as ref_polyfit
from repro.core import sax as ref_sax
from repro_torch.core import paa, polyfit, sax

RTOL = dict(rtol=1e-5, atol=1e-6)


def series(b=64, n=128, seed=0):
    x = np.random.default_rng(seed).standard_normal((b, n)).cumsum(-1)
    return np.asarray(ref_paa.znormalize_np(x), np.float32)


@pytest.mark.parametrize("N", [4, 8, 16])
def test_paa_dist(N):
    x = series()
    px, py = ref_paa.paa_np(x[:32], N), ref_paa.paa_np(x[32:], N)
    px, py = px.astype(np.float32), py.astype(np.float32)
    got = paa.paa_dist(torch.tensor(px), torch.tensor(py), 128).numpy()
    want = np.asarray(ref_paa.paa_dist(jnp.asarray(px), jnp.asarray(py), 128))
    np.testing.assert_allclose(got, want, **RTOL)
    # the lower bound (paper eq. 4) below the Euclidean distance
    assert (got <= np.linalg.norm(x[:32] - x[32:], axis=-1) + 1e-4).all()


@pytest.mark.parametrize("N,alphabet", [(8, 4), (16, 10), (32, 20)])
def test_sax_transform_and_mindist(N, alphabet):
    x = series()
    got = sax.sax_transform(torch.tensor(x), N, alphabet)
    want = np.asarray(ref_sax.sax_transform(jnp.asarray(x), N, alphabet))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    s, t = got[:32], got[32:]
    md = sax.mindist(s, t, 128, alphabet).numpy()
    np.testing.assert_allclose(md, np.asarray(ref_sax.mindist(
        jnp.asarray(want[:32]), jnp.asarray(want[32:]), 128, alphabet)),
        **RTOL)
    np.testing.assert_allclose(md, [sax.mindist_np(a, b, 128, alphabet)
                                    for a, b in zip(want[:32], want[32:])],
                               rtol=1e-5)
    sq = sax.mindist_sq_batch(got, got[5], 128, alphabet).numpy()
    np.testing.assert_allclose(sq, np.asarray(ref_sax.mindist_sq_batch(
        jnp.asarray(want), jnp.asarray(want[5]), 128, alphabet)), **RTOL)
    assert sq[5] == 0.0
    # MINDIST lower-bounds the PAA distance (paper eq. 3 ≤ eq. 4)
    pd = paa.paa_dist(paa.paa(torch.tensor(x[:32]), N),
                      paa.paa(torch.tensor(x[32:]), N), 128).numpy()
    assert (md <= pd + 1e-4).all()


@pytest.mark.parametrize("N", [1, 8, 64, 128])
def test_linfit_coeffs_and_reconstruct(N):
    x = series()
    mean, slope = polyfit.linfit_coeffs(torch.tensor(x), N)
    rmean, rslope = ref_polyfit.linfit_coeffs(jnp.asarray(x), N)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), **RTOL)
    np.testing.assert_allclose(slope.numpy(), np.asarray(rslope), **RTOL)
    L = 128 // N
    rec = polyfit.linfit_reconstruct(mean, slope, L)
    np.testing.assert_allclose(rec.numpy(), np.asarray(
        ref_polyfit.linfit_reconstruct(rmean, rslope, L)), **RTOL)
    # the residual of the reconstruction is linfit_residual_sq
    resid = ((torch.tensor(x) - rec) ** 2).sum(-1)
    np.testing.assert_allclose(
        resid.numpy(), polyfit.linfit_residual_sq(torch.tensor(x), N).numpy(),
        rtol=1e-3, atol=1e-3)


def test_rows_do_not_depend_on_the_batch():
    """Each row's sums run in row_sum's fixed order: a row computed alone
    equals the same row inside a batch, bit for bit."""
    x = torch.tensor(series())
    mean, slope = polyfit.linfit_coeffs(x, 8)
    m1, s1 = polyfit.linfit_coeffs(x[7:8], 8)
    assert torch.equal(mean[7:8], m1) and torch.equal(slope[7:8], s1)
    w = sax.sax_transform(x, 16, 10)
    assert torch.equal(sax.mindist_sq_batch(w, w[3], 128, 10)[9:10],
                       sax.mindist_sq_batch(w[9:10], w[3], 128, 10))
