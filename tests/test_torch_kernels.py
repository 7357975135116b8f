"""The port's fused kernels against the reference's Pallas kernels.

On the CPU the wrappers of ``repro_torch.kernels.fused_query`` run their
plain PyTorch versions (``kernels/ref.py``); the reference's
``fused_range_pallas`` / ``fused_topk_pallas`` run in interpret mode, as
``tests/test_kernels.py`` runs them.  Both see the same index (the
reference's leaves carried across by ``engine.device_index_from_numpy``)
and the same query representation.  The CUDA kernels themselves are held
against the plain versions on the card by ``tests/test_torch_gpu.py``
(skipped without a card) and by ``chip_smoke.py``.

Tolerances: d² is compared within ``1e-3 + 1e-5·d²`` — the order of the
engine's top-k tie window (``_TOPK_TIE_ABS/REL``): the matmul form
‖q‖² − 2·q·u + ‖u‖² cancels terms of size ~n = 128 for z-normalised
series, so two f32 summation orders differ by ~1e-5 absolute.  Range
answer sets must be equal except on rows whose d² lies inside that band
around ε²; those rows are counted, and the grid must have none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.fastsax import FastSAXConfig, build_index
from repro.kernels import fused_query as jfq
from repro.kernels import ops as jops
from repro_torch.core import engine as teng
from repro_torch.data.timeseries import make_wafer_like
from repro_torch.kernels import fused_query as tfq
from repro_torch.kernels import ops as tops

# (Q, B, levels, alphabet), as tests/test_kernels.py::FUSED_GRID: single
# and multi level, small and large alphabet, B and Q not multiples of
# any tile.
FUSED_GRID = [
    (1, 64, (8,), 3),
    (4, 200, (8, 16), 10),
    (7, 513, (8, 16), 20),
]


def d2_band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def carry_index(jdev):
    return teng.device_index_from_numpy(
        np.asarray(jdev.series), np.asarray(jdev.norms_sq),
        [np.asarray(w) for w in jdev.words],
        [np.asarray(r) for r in jdev.residuals], jdev.levels, jdev.alphabet,
        device="cpu")


def carry_queries(jqr):
    t = lambda a: torch.as_tensor(np.array(a))
    return teng.QueryReprDev(q=t(jqr.q), words=tuple(t(w) for w in jqr.words),
                             residuals=tuple(t(r) for r in jqr.residuals))


def fused_case(Q, B, levels, alphabet, seed=2):
    n = 128
    db = make_wafer_like(B, n, seed=seed)
    idx = build_index(db, FastSAXConfig(n_segments=levels, alphabet=alphabet),
                      normalize=False)
    jdev = jeng.device_index_from_host(idx)
    rng = np.random.default_rng(seed)
    q = db[rng.integers(0, B, Q)] + 0.05 * rng.standard_normal((Q, n))
    jqr = jeng.represent_queries(jnp.asarray(q, jnp.float32), levels,
                                 alphabet, normalize=False)
    return jdev, jqr, carry_index(jdev), carry_queries(jqr)


def pack(tdev, tqr, eps):
    # The wrappers take the query words (the kernel reads the MINDIST table
    # through them); the reference takes their panels (j_panels).
    return dict(series=tdev.series, norms_sq=tdev.norms_sq, words=tdev.words,
                residuals=tdev.residuals, q=tqr.q, q_words=tqr.words,
                q_residuals=tqr.residuals,
                eps=torch.as_tensor(eps, dtype=torch.float32),
                levels=tdev.levels, alphabet=tdev.alphabet, n=tdev.n)


def j_panels(jdev, jqr):
    return tuple(jops.query_panels(w, jdev.alphabet) for w in jqr.words)


def assert_range_parity(got_a, got_d, want_a, want_d, eps):
    """Equal answer sets outside the ε² band (counted: must be 0);
    distances within the band where both answer."""
    got_a, want_a = np.asarray(got_a), np.asarray(want_a)
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    eps2 = (np.asarray(eps, np.float32) ** 2)[:, None]
    d_ref = np.where(np.isfinite(want_d), want_d, got_d)
    in_band = np.abs(d_ref - eps2) <= d2_band(eps2)
    differ = got_a != want_a
    assert int((differ & ~in_band).sum()) == 0
    assert int((differ & in_band).sum()) == 0, "boundary rows on the grid"
    both = got_a & want_a
    np.testing.assert_array_less(np.abs(got_d[both] - want_d[both]),
                                 d2_band(want_d[both]) + 1e-12)
    assert np.all(np.isinf(got_d[~got_a]))


@pytest.mark.parametrize("case", FUSED_GRID)
def test_query_panels_equal(case):
    jdev, jqr, tdev, tqr = fused_case(*case)
    for jw, tw in zip(jqr.words, tqr.words):
        np.testing.assert_array_equal(
            tops.query_panels(tw, tdev.alphabet).numpy(),
            np.asarray(jops.query_panels(jw, jdev.alphabet)))


@pytest.mark.parametrize("case", FUSED_GRID)
def test_fused_range_matches_pallas(case):
    Q, B, levels, alphabet = case
    jdev, jqr, tdev, tqr = fused_case(Q, B, levels, alphabet)
    eps = np.linspace(1.0, 3.0, Q).astype(np.float32)
    want_a, want_d = jfq.fused_range_pallas(
        jdev.series, jdev.norms_sq, jdev.words, jdev.residuals, jqr.q,
        j_panels(jdev, jqr), jqr.residuals, jnp.asarray(eps),
        levels=levels, alphabet=alphabet, n=128, block_q=8, block_b=128,
        interpret=True)
    before = tfq.fused_range.launches
    got_a, got_d = tfq.fused_range(**pack(tdev, tqr, eps), block_q=16,
                                   block_b=128)
    assert tfq.fused_range.launches == before    # CPU: plain version
    assert got_a.dtype == torch.bool and got_d.dtype == torch.float32
    assert got_a.shape == (Q, B)
    assert_range_parity(got_a.numpy(), got_d.numpy(), want_a, want_d, eps)
    assert int(np.asarray(want_a).sum()) > 0


@pytest.mark.parametrize("case", FUSED_GRID)
@pytest.mark.parametrize("wide", [False, True])
def test_fused_topk_merge_matches_pallas(case, wide):
    Q, B, levels, alphabet = case
    jdev, jqr, tdev, tqr = fused_case(Q, B, levels, alphabet)
    k = 5
    eps = (np.full(Q, 100.0) if wide
           else np.linspace(1.0, 3.0, Q)).astype(np.float32)
    jidx, jd2 = jfq.fused_topk_pallas(
        jdev.series, jdev.norms_sq, jdev.words, jdev.residuals, jqr.q,
        j_panels(jdev, jqr), jqr.residuals, jnp.asarray(eps),
        levels=levels, alphabet=alphabet, n=128, k=k, block_q=8,
        block_b=128, interpret=True)
    tidx, td2 = tfq.fused_topk(**pack(tdev, tqr, eps), k=k, block_q=32,
                               block_b=128)
    assert tidx.shape == (Q, -(-B // 128) * k) == np.asarray(jidx).shape
    assert tidx.dtype == torch.int32
    # Partial lists: same rows in the same slots (this data has no
    # near-ties inside a block), +inf / −1 on the same empty slots.
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    fin = np.isfinite(np.asarray(jd2))
    np.testing.assert_array_equal(np.isfinite(td2.numpy()), fin)
    np.testing.assert_array_less(
        np.abs(td2.numpy()[fin] - np.asarray(jd2)[fin]),
        d2_band(np.asarray(jd2)[fin]) + 1e-12)
    # The merge epilogue on the reference's own partials.
    mi, md = tfq.merge_topk_partials(torch.as_tensor(np.asarray(jidx)),
                                     torch.as_tensor(np.asarray(jd2)), k)
    wi, wd = jfq.merge_topk_partials(jidx, jd2, k)
    np.testing.assert_array_equal(mi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(md.numpy(), np.asarray(wd))


def test_merge_tie_order_and_empty_slots():
    # Equal d² resolve to the lower index wherever they sit in the
    # partials; −1 slots (+inf) sort last and stay −1; a row with fewer
    # than k candidates pads with −1 / +inf.
    inf = np.inf
    idx = np.array([[9, 3, -1, 7, 2, -1], [-1, -1, -1, 4, -1, -1]], np.int32)
    d2 = np.array([[0.0, 0.0, inf, 0.5, 0.0, inf],
                   [inf, inf, inf, 2.0, inf, inf]], np.float32)
    got_i, got_d = tfq.merge_topk_partials(torch.as_tensor(idx),
                                           torch.as_tensor(d2), 4)
    want_i, want_d = jfq.merge_topk_partials(jnp.asarray(idx),
                                             jnp.asarray(d2), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_i.numpy()[0], [2, 3, 9, 7])
    np.testing.assert_array_equal(got_i.numpy()[1], [4, -1, -1, -1])


def test_fused_knn_valid_mask_excludes_rows():
    jdev, jqr, tdev, tqr = fused_case(2, 200, (8, 16), 10)
    base_i, _, _ = teng.knn_query_fused(tdev, tqr, 3, block_b=128)
    banned = np.unique(base_i.numpy().ravel())
    vmask = np.ones(200, dtype=bool)
    vmask[banned] = False
    got_i, got_d, got_e = teng.knn_query_fused(
        tdev, tqr, 3, valid_mask=torch.as_tensor(vmask), block_b=128)
    want_i, want_d, want_e = jeng.knn_query_pallas(
        jdev, jqr, 3, valid_mask=jnp.asarray(vmask), block_q=8, block_b=128,
        interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5,
                               atol=1e-5)
    assert not np.isin(got_i.numpy(), banned).any()
    assert bool(got_e.all()) and bool(np.asarray(want_e).all())


def test_fused_knn_mostly_padding_shard_exact():
    # The strided seed sample holds no valid row: the seed radius falls
    # back to the finite 1e28 stand-in, so C9 still kills the sentinel
    # residual of every masked row inside the kernel.
    jdev, jqr, tdev, tqr = fused_case(2, 200, (8, 16), 10)
    vmask = np.zeros(200, dtype=bool)
    vmask[[5, 7]] = True
    series = tdev.series.numpy().astype(np.float64)
    qs = tqr.q.numpy().astype(np.float64)
    d2 = ((series[None] - qs[:, None]) ** 2).sum(-1)
    d2[:, ~vmask] = np.inf
    for k in (1, 2):
        got_i, _, got_e = teng.knn_query_fused(
            tdev, tqr, k, valid_mask=torch.as_tensor(vmask), block_b=128)
        want_i, _, _ = jeng.knn_query_pallas(
            jdev, jqr, k, valid_mask=jnp.asarray(vmask), block_q=8,
            block_b=128, interpret=True)
        assert bool(got_e.all())
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        for qi in range(2):
            np.testing.assert_array_equal(
                got_i.numpy()[qi], np.lexsort((np.arange(200), d2[qi]))[:k])
    is_knn = torch.tensor([True, True])
    got = teng.mixed_query_fused(tdev, tqr, torch.zeros(2), is_knn, 2,
                                 valid_mask=torch.as_tensor(vmask),
                                 block_b=128)
    gki, _ = teng.mixed_topk(got[0], got[2], 2)
    for qi in range(2):
        np.testing.assert_array_equal(
            gki.numpy()[qi], np.lexsort((np.arange(200), d2[qi]))[:2])
    assert not got[1].numpy()[:, ~vmask].any()


def test_fused_knn_huge_scale_finite_seed_radius():
    # A legitimately finite sampled radius on un-normalised data far
    # above any small ceiling passes through untouched.
    rng = np.random.default_rng(1)
    big = (rng.standard_normal((64, 128)) * 1e16).astype(np.float32)
    tdev = teng.build_device_index(torch.as_tensor(big), (8,), 10,
                                   normalize=False)
    tqr = teng.represent_queries(torch.as_tensor(big[:2] + 1e15), (8,), 10,
                                 normalize=False)
    got_i, _, got_e = teng.knn_query_fused(tdev, tqr, 3, block_b=128)
    d2 = ((big[None].astype(np.float64)
           - tqr.q.numpy()[:, None].astype(np.float64)) ** 2).sum(-1)
    bf = np.stack([np.lexsort((np.arange(64), d2[i]))[:3] for i in range(2)])
    np.testing.assert_array_equal(got_i.numpy(), bf)
    assert bool(got_e.all())


def test_reverify_rows_discards_out_of_range_and_invalid():
    _, _, tdev, tqr = fused_case(1, 64, (8,), 3)
    idx = torch.tensor([[0, 5, -1, 63, 64, 200]], dtype=torch.int32)
    d2 = teng._reverify_rows(tdev, tqr, idx).numpy()
    assert np.isfinite(d2[0, [0, 1, 3]]).all()
    assert np.isinf(d2[0, [2, 4, 5]]).all()
    ref_d2 = ((tdev.series.numpy()[[0, 5, 63]]
               - tqr.q.numpy()[0][None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2[0, [0, 1, 3]], ref_d2, rtol=1e-6)
    vmask = torch.ones(64, dtype=torch.bool)
    vmask[5] = False
    d2m = teng._reverify_rows(tdev, tqr, idx, vmask).numpy()
    assert np.isinf(d2m[0, 1]) and np.isfinite(d2m[0, [0, 3]]).all()


def test_fused_knn_certificate_flags_boundary_ties():
    # 16 zero-distance duplicates in one block: the full partial list's
    # worst re-verified distance ties the merged k-th, so no exactness
    # claim — though the answer (lowest-index duplicate) is right.
    n, alphabet, levels = 128, 10, (8,)
    rng = np.random.default_rng(7)
    base = rng.standard_normal(n)
    rest = base[None, :] + 5.0 * rng.standard_normal((48, n))
    db = np.concatenate([np.repeat(base[None, :], 16, axis=0), rest])
    idx = build_index(db, FastSAXConfig(n_segments=levels, alphabet=alphabet),
                      normalize=False)
    tdev = teng.device_index_from_host(idx, device="cpu")
    tqr = teng.represent_queries(torch.as_tensor(base[None, :],
                                                 dtype=torch.float32),
                                 levels, alphabet, normalize=False)
    got_i, got_d, got_e = teng.knn_query_fused(tdev, tqr, 1, block_b=128)
    assert not bool(got_e.any())
    assert int(got_i[0, 0]) == 0
    assert float(got_d[0, 0]) == 0.0


def test_wrappers_reject_what_they_do_not_take():
    _, _, tdev, tqr = fused_case(4, 200, (8, 16), 10)
    eps = np.full(4, 2.0, np.float32)
    good = pack(tdev, tqr, eps)
    tfq.fused_range(**good)
    bad = dict(good, eps=good["eps"].double())
    with pytest.raises(TypeError, match="eps"):
        tfq.fused_range(**bad)
    bad = dict(good, words=(good["words"][0].long(), good["words"][1]))
    with pytest.raises(TypeError, match="words"):
        tfq.fused_range(**bad)
    bad = dict(good, series=good["series"].T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        tfq.fused_range(**bad)
    bad = dict(good, q_residuals=(good["q_residuals"][0][:3],
                                  good["q_residuals"][1]))
    with pytest.raises(ValueError, match="shape"):
        tfq.fused_range(**bad)
    with pytest.raises(ValueError, match="levels"):
        tfq.fused_range(**dict(good, levels=(8, 16, 32, 64, 128),
                               words=good["words"] * 3))
    with pytest.raises(ValueError, match="k="):
        tfq.fused_topk(**good, k=129, block_b=256)
    with pytest.raises(ValueError, match="k="):
        tfq.fused_topk(**good, k=65, block_b=64)
    with pytest.raises(ValueError, match="block_b"):
        tfq.fused_range(**good, block_b=100)
    with pytest.raises(ValueError, match="block_q"):
        tfq.fused_range(**good, block_q=8)


def test_tile_chooser_respects_shared_memory():
    bq, bb = tops.choose_fused_blocks(32, 1 << 20, 128, (8, 16), 10, k_sel=12)
    assert bq in tops.FUSED_BLOCK_Q and bb in tops.FUSED_BLOCK_B
    assert tops.fused_smem_bytes(bq, 128, (8, 16), 10, 32, 12) \
        <= tops.SMEM_BYTES
    # Fewer blocks than SMs would idle the card: small B takes small tiles.
    _, bb_small = tops.choose_fused_blocks(32, 65536, 128, (8, 16), 10)
    assert bb_small < bb
    with pytest.raises(ValueError, match="shared memory"):
        tops.choose_fused_blocks(32, 4096, 10 ** 5, (8, 16), 10)
    with pytest.raises(ValueError, match="shared memory"):
        teng._fused_blocks(teng.build_device_index(
            np.zeros((64, 4096), np.float32), (8,), 20, normalize=False,
            device="cpu"), 32, 0, 32, 64)
