"""The per-level kernel wrappers (``repro_torch.kernels.level_ops``) on the
CPU against the reference's (``repro.kernels.ops``).

On CPU tensors the wrappers compute their plain PyTorch versions
(``kernels/ref.py``), which sum in ``core/paa.row_sum``'s fixed order;
the reference's Pallas kernels run in interpret mode at ``block_b=128``
and compute through MXU-style matrix products, so the two differ by f32
summation order.  The tolerances are the reference's own for its kernels
against its oracles (``tests/test_kernels.py``).  The kernels themselves
are held against the plain versions, bit for bit, on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import representation as jrep
from repro.kernels import ops as jops
from repro_torch.core import polyfit as tpoly
from repro_torch.core import representation as trep
from repro_torch.core.paa import paa as tpaa_fn
from repro_torch.core.sax import discretize, mindist_table
from repro_torch.data.timeseries import make_wafer_like
from repro_torch.kernels import level_ops as lo
from repro_torch.kernels import ref as tref

SHAPES = [(64, 64), (200, 128), (513, 256)]
DTYPES = ["float32", "bfloat16"]


def inputs(B, n, dtype, seed=0):
    """The same series for both packages: f32 numpy, then rounded to bf16
    by each framework (round to nearest even from f32: the same values)."""
    x = make_wafer_like(B, n, seed=seed).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(jx.astype(jnp.float32)),
                                  tx.float().numpy())
    return jx, tx


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [4, 8, 16])
def test_paa_matches_reference(shape, dtype, N):
    jx, tx = inputs(*shape, dtype)
    got = lo.paa(tx, N)
    want = np.asarray(jops.paa(jx, N, block_b=128))
    assert got.dtype == torch.float32 and got.shape == (shape[0], N)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # The plain version is the engine's device PAA of the f32 rows.
    assert torch.equal(got, tpaa_fn(tx.float(), N))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [4, 8, 16])
def test_linfit_residual_sq_matches_reference(shape, dtype, N):
    jx, tx = inputs(*shape, dtype)
    got = lo.linfit_residual_sq(tx, N)
    want = np.asarray(jops.linfit_residual_sq(jx, N, block_b=128))
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    tol = 5e-4 if dtype == "float32" else 0.35
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 10)
    assert torch.equal(got, tpoly.linfit_residual_sq(tx.float(), N))


@pytest.mark.parametrize("shape", [(64, 64), (513, 128)])
@pytest.mark.parametrize("alphabet", [3, 10, 20])
@pytest.mark.parametrize("N", [8, 16])
def test_mindist_sq_matches_reference(shape, alphabet, N):
    B, n = shape
    jx, tx = inputs(B, n, "float32")
    words = np.asarray(discretize(tpaa_fn(tx, N), alphabet))
    qword = words[B // 2]
    got = lo.mindist_sq(torch.as_tensor(words), qword, n, alphabet)
    want = np.asarray(jops.mindist_sq(jnp.asarray(words), jnp.asarray(qword),
                                      n, alphabet, block_b=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert float(got[B // 2]) == 0.0          # adjacent-symbol cells are 0
    np.testing.assert_array_equal(
        lo.query_table(qword, alphabet).numpy(),
        np.asarray(jops.query_table(jnp.asarray(qword), alphabet)))


# sqdist's card kernel takes n = 2^k ≤ 1024 in registers (8, 64, 128,
# 256, 1024 here) and other n through the segment body (96, 100).
SQDIST_SHAPES = SHAPES + [(37, 8), (300, 96), (129, 100), (33, 1024)]


@pytest.mark.parametrize("shape", SQDIST_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sqdist_matches_reference(shape, dtype):
    B, n = shape
    jx, tx = inputs(B, n, dtype)
    got = lo.sqdist(tx, tx[B // 3])
    want = np.asarray(jops.sqdist(jx, jx[B // 3], block_b=128))
    tol = 1e-4 if dtype == "float32" else 0.5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert float(got[B // 3]) == 0.0
    # A float32 query against bfloat16 rows upcasts both.
    q32 = tx[B // 3].float()
    np.testing.assert_array_equal(lo.sqdist(tx, q32).numpy(), got.numpy())


def prune_inputs(B, n, N, alphabet, seed):
    x = make_wafer_like(B, n, seed=seed).astype(np.float32)
    tx = torch.as_tensor(x)
    words = discretize(tpaa_fn(tx, N), alphabet)
    res = torch.sqrt(tpoly.linfit_residual_sq(tx, N))
    q = make_wafer_like(1, n, seed=seed + 100).astype(np.float32)
    tq = torch.as_tensor(q)
    qword = discretize(tpaa_fn(tq, N), alphabet)[0].numpy()
    qres = float(torch.sqrt(tpoly.linfit_residual_sq(tq, N))[0])
    return x, words, res, qword, qres


def test_prune_level_respects_incoming_mask():
    B, n, N, alphabet = 128, 64, 8, 10
    _, words, res, qword, qres = prune_inputs(B, n, N, alphabet, 3)
    dead = torch.zeros(B, dtype=torch.bool)
    out = lo.prune_level(dead, res, words, qword, qres, 100.0, n, alphabet)
    assert not bool(out.any()), "dead rows must stay dead"
    alive = lo.prune_level(~dead, res, words, qword, qres, 100.0, n,
                           alphabet)
    assert bool(alive.all())
    # A PAD_RESIDUAL row dies in C9 at any finite ε.
    res[5] = 1e30
    out = lo.prune_level(~dead, res, words, qword, qres, 1e20, n, alphabet)
    assert not bool(out[5]) and int(out.sum()) == B - 1


@pytest.mark.parametrize("eps", [0.5, 2.0, 6.0])
@pytest.mark.parametrize("N,alphabet", [(8, 10), (16, 3), (4, 20)])
def test_prune_level_matches_reference(eps, N, alphabet):
    B, n = 700, 128
    x, words, res, qword, qres = prune_inputs(B, n, N, alphabet, 7)
    rng = np.random.default_rng(N)
    alive = rng.random(B) < 0.8
    got = lo.prune_level(torch.as_tensor(alive), res, words, qword, qres,
                         eps, n, alphabet).numpy()
    want = np.asarray(jops.prune_level(
        jnp.asarray(alive), jnp.asarray(res.numpy()),
        jnp.asarray(words.numpy()), jnp.asarray(qword), jnp.float32(qres),
        jnp.float32(eps), n, alphabet, block_b=128))
    assert not (got & ~alive).any()
    # Equal except rows whose C9 gap or C10 bound lies within the f32
    # band of its threshold (the two MINDIST sums differ in order).
    gap = np.abs(res.numpy().astype(np.float64) - qres)
    tab = mindist_table(alphabet)
    md2 = (n / N) * np.sum(tab[words.numpy(), qword[None, :]] ** 2, -1)
    near = (np.abs(gap - eps) <= 1e-5 * max(1.0, eps)) | (
        np.abs(md2 - eps * eps) <= 1e-5 * max(1.0, eps * eps))
    assert not ((got != want) & ~near).any()
    assert got.any() or eps < 1


@pytest.mark.parametrize("N", [4, 8, 16])
def test_linfit_residual_backend_parity(N):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 128))
    want = jrep.linfit_residual_sq(x, N, backend="numpy")
    np.testing.assert_array_equal(trep.linfit_residual_sq(x, N), want)
    tx = torch.as_tensor(x, dtype=torch.float32)
    via_torch = trep.linfit_residual_sq(tx, N, backend="torch")
    via_cuda = trep.linfit_residual_sq(tx, N, backend="cuda")
    np.testing.assert_allclose(via_torch.numpy(), want, rtol=2e-4, atol=2e-4)
    # On a CPU tensor the kernel backend runs its plain version: the same
    # expression as the torch backend, bit for bit.
    assert torch.equal(via_cuda, via_torch)
    np.testing.assert_allclose(
        via_torch.numpy(),
        np.asarray(jrep.linfit_residual_sq(jnp.asarray(x, jnp.float32), N,
                                           backend="pallas")),
        rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="unknown linfit backend"):
        trep.linfit_residual_sq(x, N, backend="pallas")


def test_plain_versions_follow_row_sum_order():
    # Odd segment lengths carry a tail: the plain versions are the
    # engine's row_sum expressions, not library reductions.
    x = torch.as_tensor(make_wafer_like(33, 96, seed=5), dtype=torch.float32)
    for N in (1, 8, 32, 96):
        assert torch.equal(tref.paa_ref(x, N), tpaa_fn(x, N))
        assert torch.equal(tref.linfit_residual_sq_ref(x, N),
                           tpoly.linfit_residual_sq(x, N))
    assert torch.equal(lo.linfit_residual_sq(x, 96), torch.zeros(33))


def test_wrappers_check_their_inputs():
    x = torch.zeros((10, 64))
    with pytest.raises(TypeError, match="float32"):
        lo.paa(x.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        lo.linfit_residual_sq(torch.zeros((64, 10)).t(), 8)
    with pytest.raises(ValueError, match="divide"):
        lo.paa(x, 7)
    with pytest.raises(ValueError, match=r"q must have shape \(64,\)"):
        lo.sqdist(x, torch.zeros(63))
    words = torch.zeros((10, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        lo.mindist_sq(words.long(), np.zeros(8, np.int32), 64, 10)
    with pytest.raises(ValueError, match="leaves"):
        lo.mindist_sq(words, np.full(8, 10), 64, 10)
    with pytest.raises(ValueError, match="symbols"):
        lo.mindist_sq(words, np.zeros(4, np.int32), 64, 10)
    with pytest.raises(TypeError, match="bool"):
        lo.prune_level(torch.ones(10, dtype=torch.int32), torch.zeros(10),
                       words, np.zeros(8, np.int32), 0.0, 1.0, 64, 10)
    with pytest.raises(ValueError, match="10 rows"):
        lo.prune_level(torch.ones(9, dtype=torch.bool), torch.zeros(9),
                       words, np.zeros(8, np.int32), 0.0, 1.0, 64, 10)
    # An empty batch needs no launch on either device.
    assert lo.paa(torch.zeros((0, 64)), 8).shape == (0, 8)
    assert lo.sqdist(torch.zeros((0, 64)), torch.zeros(64)).shape == (0,)
    # CPU tensors count no launch.
    before = [k.launches for k in lo.KERNELS]
    lo.paa(x, 8)
    assert [k.launches for k in lo.KERNELS] == before
