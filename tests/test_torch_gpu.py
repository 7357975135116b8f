"""The port's CUDA kernels on the card (skipped without one).

Run on a machine with an NVIDIA Hopper GPU and the CUDA toolkit:

    PYTHONPATH=src python -m pytest tests/test_torch_gpu.py -q

This file imports neither JAX nor the reference package, so it runs where
only PyTorch is installed.  Each CUDA kernel is held against its plain
PyTorch version (``repro_torch/kernels/ref.py``) on the same tensors on
the card.  d² within 1e-3 + 1e-5·d²: the kernel sums the verify's dot
product in another f32 order than the library's matrix-vector product,
and the matmul form cancels terms of size ~n = 128.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model, engine
from repro_torch.core.paa import znormalize_np
from repro_torch.core.sax import discretize
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import level_ops as lo
from repro_torch.kernels import ops, ref
from repro_torch.serve import (SearchService, ServeConfig, WorkloadSpec,
                               check_exactness, make_workload,
                               run_closed_loop)

pytestmark = pytest.mark.gpu

# (Q, B, levels, alphabet): ragged B and Q, one to four levels, and more
# queries than one shared-memory chunk.
CASES = [
    (1, 64, (8,), 3),
    (4, 200, (8, 16), 10),
    (7, 513, (8, 16), 20),
    (33, 1000, (8, 16), 10),
    (5, 300, (4, 8, 16, 32), 10),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def plain_args(args):
    """A wrapper's keyword arguments as its plain version takes them: the
    query words' MINDIST panels in place of the words, no alphabet."""
    out = {k: v for k, v in args.items() if k not in ("alphabet", "q_words")}
    out["q_panels"] = tuple(ops.query_panels(w, args["alphabet"])
                            for w in args["q_words"])
    return out


def quant_plain(args):
    """The quantized wrappers' positional arguments as the plain versions
    take them (panels in place of the query words)."""
    qdev, q, q_words, q_res, eps = args
    return (qdev, q, tuple(ops.query_panels(w, qdev.alphabet)
                           for w in q_words), q_res, eps)


def kernel_args(case, device, seed=2):
    Q, B, levels, alphabet = case
    db = make_wafer_like(B, 128, seed=seed)
    index = engine.build_device_index(db, levels, alphabet, normalize=False,
                                      device=device)
    qr = engine.represent_queries(
        torch.as_tensor(make_queries(db, Q, seed=seed + 1),
                        dtype=torch.float32, device=device), levels, alphabet,
        normalize=False)
    eps = torch.linspace(1.0, 3.0, Q, device=device)
    return index, qr, engine._fused_inputs(index, qr, index.residuals, eps)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("block_q", [16, 32])
def test_kernels_match_plain_versions(cuda, case, block_q):
    _, _, args = kernel_args(case, cuda)
    plain = plain_args(args)
    n0 = fq.fused_range.launches
    ga, gd = fq.fused_range(**args, block_q=block_q, block_b=128)
    torch.cuda.synchronize()
    assert fq.fused_range.launches == n0 + 1
    wa, wd = ref.fused_range_ref(**plain)
    ga, gd, wa, wd = (t.cpu().numpy() for t in (ga, gd, wa, wd))
    eps2 = (args["eps"] ** 2).cpu().numpy()[:, None]
    d_ref = np.where(np.isfinite(wd), wd, gd)
    differ = ga != wa
    assert not (differ & (np.abs(d_ref - eps2) > band(eps2))).any()
    both = ga & wa
    assert np.all(np.abs(gd[both] - wd[both]) <= band(wd[both]))
    assert np.all(np.isinf(gd[~ga]))

    for k, block_b in ((9, 128), (1, 64), (64, 64)):
        gi, gdd = fq.fused_topk(**args, k=k, block_q=block_q,
                                block_b=block_b)
        torch.cuda.synchronize()
        wi, wdd = ref.fused_topk_ref(**plain, k=k, block_b=block_b)
        assert gi.shape == wi.shape
        # Empty slots agree exactly; filled ones hold the same rows up to
        # swaps of near-equal d² within a block.
        np.testing.assert_array_equal(gi.cpu().numpy() < 0,
                                      wi.cpu().numpy() < 0)
        mg = fq.merge_topk_partials(gi, gdd, min(k, 5))
        mw = fq.merge_topk_partials(wi, wdd, min(k, 5))
        gd_m, wd_m = mg[1].cpu().numpy(), mw[1].cpu().numpy()
        fin = np.isfinite(wd_m)
        np.testing.assert_array_equal(np.isfinite(gd_m), fin)
        assert np.all(np.abs(gd_m[fin] - wd_m[fin]) <= band(wd_m[fin]))
        differ = mg[0].cpu().numpy() != mw[0].cpu().numpy()
        assert np.all(np.abs(gd_m[differ] - wd_m[differ])
                      <= band(wd_m[differ]))


@pytest.mark.parametrize("case", CASES)
def test_shared_memory_layout_matches_chooser(cuda, case):
    Q, _, levels, alphabet = case
    for topk, k_sel in ((False, 0), (True, 12)):
        for bq in ops.FUSED_BLOCK_Q:
            assert fq.smem_bytes_of_kernel(topk, 128, levels, alphabet, bq,
                                           Q, k_sel) == \
                ops.fused_smem_bytes(bq, 128, levels, alphabet, Q, k_sel)


def test_fused_engine_on_card_matches_torch_engine_on_cpu(cuda):
    case = (8, 3000, (8, 16), 10)
    index_g, qr_g, _ = kernel_args(case, cuda)
    index_c, qr_c, _ = kernel_args(case, "cpu")
    for k in (1, 5):
        gi, gd, ge = engine.knn_query_fused(index_g, qr_g, k)
        ci, cd, _ = engine.knn_query_auto(index_c, qr_c, k)
        assert bool(ge.all())
        np.testing.assert_array_equal(gi.cpu().numpy(), ci.numpy())
        np.testing.assert_allclose(gd.cpu().numpy(), cd.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_batch_and_replay_are_bit_equal_on_card(cuda):
    # What the serving exactness replay relies on: a query's
    # representation and its kernel rows do not depend on its batch.
    db = make_wafer_like(5000, 128, seed=4)
    svc = SearchService.from_series(db, ServeConfig())
    qs = make_queries(db, 32, seed=5).astype(np.float32) * 2 + 1
    eps = np.full(32, 2.0, np.float32)
    is_knn = np.arange(32) % 2 == 0
    full = engine.represent_queries(torch.as_tensor(qs, device=cuda),
                                    (8, 16), 10)
    idx, ans, d2 = svc.backend.dispatch(qs, eps, is_knn, 8)
    for i in (0, 1, 17, 31):
        one = engine.represent_queries(
            torch.as_tensor(qs[i:i + 1], device=cuda), (8, 16), 10)
        assert torch.equal(one.q[0], full.q[i])
        assert all(torch.equal(a[0], b[i]) for a, b in
                   zip(one.residuals + one.words, full.residuals + full.words))
        _, a1, d1 = svc.backend.dispatch(qs[i:i + 1], eps[i:i + 1],
                                         is_knn[i:i + 1], 8)
        np.testing.assert_array_equal(a1[0], ans[i])
        np.testing.assert_array_equal(d1[0], d2[i])


def test_masked_rows_and_huge_seed_radius_on_card(cuda):
    # Only rows 5 and 7 are valid, and neither is in the strided seed
    # sample: the seed radius is the 1e28 stand-in, whose square is +inf
    # in f32 (C10 open) while C9 still kills the 1e30 sentinel residual
    # of every masked row inside the kernel.
    index, qr, _ = kernel_args((2, 200, (8, 16), 10), cuda)
    vmask = torch.zeros(200, dtype=torch.bool, device=cuda)
    vmask[[5, 7]] = True
    series = index.series.double().cpu().numpy()
    qs = qr.q.double().cpu().numpy()
    d2 = ((series[None] - qs[:, None]) ** 2).sum(-1)
    d2[:, ~vmask.cpu().numpy()] = np.inf
    for k in (1, 2):
        got_i, _, got_e = engine.knn_query_fused(index, qr, k,
                                                 valid_mask=vmask)
        assert bool(got_e.all())
        for qi in range(2):
            np.testing.assert_array_equal(
                got_i.cpu().numpy()[qi],
                np.lexsort((np.arange(200), d2[qi]))[:k])
    got = engine.mixed_query_fused(index, qr, torch.zeros(2, device=cuda),
                                   torch.ones(2, dtype=torch.bool,
                                              device=cuda), 2,
                                   valid_mask=vmask)
    assert not got[1][:, ~vmask].any()


def test_wrappers_raise_on_mixed_devices(cuda):
    _, _, args = kernel_args((4, 200, (8, 16), 10), cuda)
    with pytest.raises(ValueError, match="expected cuda"):
        fq.fused_range(**dict(args, q=args["q"].cpu()))


def test_service_on_card_is_exact_and_uses_the_kernels(cuda):
    db = make_wafer_like(4096, 128, seed=0)
    svc = SearchService.from_series(db, ServeConfig())
    assert svc.backend.backend == "cuda"
    svc.warmup(qs=(1, 32))
    wl = make_workload(make_queries(db, 16, seed=1),
                       WorkloadSpec(n_requests=48, k=5, epsilon=2.0))
    fq.reset_launch_counts()
    with svc:
        result = run_closed_loop(svc, wl, clients=8)
        assert fq.fused_range.launches > 0 and fq.fused_topk.launches > 0
        assert check_exactness(svc, wl, result) == 0
    assert result.served == len(wl)


# ---------------------------------------------------------------------------
# The quantized resident tier: fused_quant_range / fused_quant_topk.
# ---------------------------------------------------------------------------


def quant_case(Q, B, mode, device, seed=5, levels=(8, 16)):
    """A tiered index over B wafer-like rows with three planted blocks of
    level 0's residuals — block 1 all sentinel codes (int8) or 1e30
    (bf16), block 2 of span 0 (int8 scale 1) — plus one constant series
    row (series scale 1), and the kernel inputs of Q queries."""
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.index import quantized as quant

    db = make_wafer_like(B, 128, seed=seed)
    host = build_index(db, FastSAXConfig(n_segments=levels, alphabet=10))
    host.series[3] = 0.25
    host.levels[0].residuals[256:384] = 1.5
    qhost = quant.quantize_host_index(host, mode)
    lv0 = qhost.levels[0]
    codes = lv0.residuals.copy()
    codes[128:256] = (quant.SENTINEL_CODE if mode == "int8"
                      else quant.bf16_encode(np.full(128, 1e30)))
    qhost = dataclasses.replace(qhost, levels=(
        dataclasses.replace(lv0, residuals=codes),) + qhost.levels[1:])
    if mode == "int8":
        assert lv0.scale[2] == 1.0 and qhost.series_scale[3] == 1.0
    qdev = engine.quantized_device_index(qhost, device)
    qr = engine.represent_queries(
        torch.as_tensor(make_queries(db, Q, seed=seed + 1),
                        dtype=torch.float32, device=device), levels, 10)
    eps = torch.linspace(1.0, 3.0, Q, device=device)
    return qdev, qr, eps, qr.words


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("shape", [(27, 50_001), (32, 65_536)])
def test_quant_kernels_match_plain_versions(cuda, mode, shape):
    Q, B = shape
    qdev, qr, eps, q_words = quant_case(Q, B, mode, cuda)
    args = (qdev, qr.q, q_words, qr.residuals, eps)
    n0 = fq.fused_quant_range.launches
    gk, gd = fq.fused_quant_range(*args, block_q=32, block_b=1024)
    torch.cuda.synchronize()
    assert fq.fused_quant_range.launches == n0 + 1
    wk, wd = ref.fused_quant_range_ref(*quant_plain(args))
    lim2 = ref.screen_limit_sq(eps, qdev.series_err).cpu().numpy()
    gk, gd, wk, wd = (t.cpu().numpy() for t in (gk, gd, wk, wd))
    assert not wk[:, 128:256].any() and not gk[:, 128:256].any()
    d_ref = np.where(np.isfinite(wd), wd, gd)
    differ = gk != wk
    assert not (differ & (np.abs(d_ref - lim2) > band(lim2))).any()
    both = gk & wk
    assert both.sum() > 0
    assert np.all(np.abs(gd[both] - wd[both]) <= band(wd[both]))
    assert np.all(np.isinf(gd[~gk]))

    for k, block_b in ((9, 1024), (64, 256)):
        gi, gdd = fq.fused_quant_topk(*args, k=k, block_q=16,
                                      block_b=block_b)
        torch.cuda.synchronize()
        wi, wdd = ref.fused_quant_topk_ref(*quant_plain(args), k=k,
                                           block_b=block_b)
        mg = fq.merge_topk_partials(gi, gdd, 5)
        mw = fq.merge_topk_partials(wi, wdd, 5)
        gd_m, wd_m = mg[1].cpu().numpy(), mw[1].cpu().numpy()
        fin = np.isfinite(wd_m)
        np.testing.assert_array_equal(np.isfinite(gd_m), fin)
        assert np.all(np.abs(gd_m[fin] - wd_m[fin]) <= band(wd_m[fin]))
        differ = mg[0].cpu().numpy() != mw[0].cpu().numpy()
        assert np.all(np.abs(gd_m[differ] - wd_m[differ])
                      <= band(wd_m[differ]))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quant_shared_memory_layout_matches_chooser(cuda, mode):
    for topk, k_sel in ((False, 0), (True, 12)):
        for bq in ops.FUSED_BLOCK_Q:
            assert fq.smem_bytes_of_kernel(topk, 128, (8, 16), 10, bq, 32,
                                           k_sel, quant=mode) == \
                ops.fused_smem_bytes(bq, 128, (8, 16), 10, 32, k_sel,
                                     quant=mode)


def test_tiered_service_on_card_is_exact_and_uses_the_kernel(cuda):
    db = make_wafer_like(6000, 128, seed=0)
    svc = SearchService.from_series(db, ServeConfig(quantization="int8"))
    full = SearchService.from_series(db, ServeConfig())
    assert svc.backend.backend == "cuda"
    assert svc.backend.tindex.dev.series.dtype == torch.int8
    wl = make_workload(make_queries(db, 16, seed=1),
                       WorkloadSpec(n_requests=48, k=5, epsilon=2.0))
    fq.reset_launch_counts()
    with svc:
        result = run_closed_loop(svc, wl, clients=8)
        assert fq.fused_quant_range.launches > 0
        assert check_exactness(svc, wl, result) == 0
    with full:
        want = run_closed_loop(full, wl, clients=8)
    assert result.served == len(wl)
    # The two indexes z-normalise in f64 (host) and f32 (device), and the
    # tier verifies in the diff² form, the fused path in the matmul form:
    # answers may differ only on rows within the band of the boundary.
    series = svc.backend.tindex.raw.astype(np.float64)
    for (kind, q, eps, k), got, exp in zip(wl, result.requests,
                                          want.requests):
        qz = znormalize_np(np.asarray(q, np.float64))
        d2 = ((series - qz) ** 2).sum(-1)
        if kind == "range":
            sym = np.setxor1d(got.ids, exp.ids)
            assert np.all(np.abs(d2[sym] - eps * eps) <= band(eps * eps))
        else:
            off = got.ids != exp.ids
            assert np.all(np.abs(d2[got.ids[off]] - d2[exp.ids[off]])
                          <= band(d2[exp.ids[off]]))


def test_verify_prefetch_is_bit_identical_on_card(cuda):
    # The double-buffered fetch (pinned staging, non_blocking upload on
    # the current stream) verifies the same rows as the synchronous one.
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.core.options import SearchOptions

    db = make_wafer_like(3000, 128, seed=7)
    tier = engine.TieredIndex.from_host(
        build_index(db, FastSAXConfig(n_segments=(8, 16))), "int8")
    qr = engine.represent_queries(
        torch.as_tensor(make_queries(db, 8, seed=8), dtype=torch.float32,
                        device=cuda), (8, 16), 10)
    eps = torch.full((8,), 2.0, device=cuda)
    is_knn = torch.arange(8, device=cuda) % 2 == 0
    n0 = fq.fused_quant_range.launches
    sync = engine.quantized_mixed_query(tier, qr, eps, is_knn, 5)
    pre = engine.quantized_mixed_query(tier, qr, eps, is_knn, 5,
                                       SearchOptions(verify_prefetch=True))
    assert fq.fused_quant_range.launches == n0 + 2
    assert bool(sync[1].any())
    for a, b in zip(sync, pre):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Streaming subsequence search: fused_subseq_range / fused_subseq_topk /
# fused_quant_subseq_range.
# ---------------------------------------------------------------------------

# (streams, stream length, window, stride, levels, Q): windows per stream
# not a multiple of 64 (sub-tiles cross stream boundaries), a ragged last
# block, a stride of 1, fewer than 64 windows per stream (several
# boundaries in one sub-tile: the loader reads the streams directly) and
# a stride too long for the staged range.
SUBSEQ_CASES = [
    (3, 1000, 64, 3, (4, 8), 5),
    (2, 700, 128, 1, (8, 16), 33),
    (4, 300, 32, 4, (4, 8), 7),
    (5, 120, 32, 2, (8,), 3),
    (2, 40_000, 64, 150, (4, 8), 9),
]


def subseq_case(case, device, seed=3, flat=False):
    """A subsequence index and its kernel inputs (half the queries at
    ε = 2, half at their k-NN seed radius).  ``flat``: stream 0 starts
    with a constant stretch, so some windows have σ floored at 1e-8."""
    from repro_torch.core import subseq as ss
    from repro_torch.core.fastsax import FastSAXConfig
    from repro_torch.data.timeseries import make_subseq_queries

    S, n_stream, window, stride, levels, Q = case
    streams = make_wafer_like(S, n_stream, seed=seed, normalize=False)
    if flat:
        streams[0, :3 * window] = 0.75
    hidx = ss.build_subseq_index(
        streams, FastSAXConfig(n_segments=levels, alphabet=10), window,
        stride)
    sidx = ss.subseq_device_index(hidx, device)
    qr = ss.represent_subseq_queries(
        sidx, make_subseq_queries(streams, Q, window, seed=seed + 1))
    knn = (torch.arange(Q, device=device) % 2 == 0).reshape(Q, 1)
    seed_eps = engine._slacked(engine._seed_eps(sidx.index, qr, 8, None))
    eps = torch.where(knn, seed_eps, torch.full_like(seed_eps, 2.0))
    args = dict(streams=sidx.streams, mu=sidx.mu, sd=sidx.sd,
                norms_sq=sidx.index.norms_sq, words=sidx.index.words,
                residuals=sidx.index.residuals, q=qr.q,
                q_words=qr.words,
                q_residuals=qr.residuals, eps=eps.reshape(-1).contiguous(),
                levels=levels, alphabet=10, window=window, stride=stride)
    return hidx, sidx, qr, args


def rows_args(sidx, args):
    """The whole-series kernels' inputs over the materialised windows."""
    return dict(series=sidx.index.series, norms_sq=args["norms_sq"],
                words=args["words"], residuals=args["residuals"],
                q=args["q"], q_words=args["q_words"],
                q_residuals=args["q_residuals"], eps=args["eps"],
                levels=args["levels"], alphabet=10, n=args["window"])


@pytest.mark.parametrize("case", SUBSEQ_CASES)
@pytest.mark.parametrize("block_q,block_b", [(32, 1024), (16, 128)])
def test_subseq_kernels_match_plain_versions(cuda, case, block_q, block_b):
    _, sidx, _, args = subseq_case(case, cuda)
    tile = dict(block_q=block_q, block_b=block_b)
    n0 = fq.fused_subseq_range.launches
    ga, gd = fq.fused_subseq_range(**args, **tile)
    torch.cuda.synchronize()
    assert fq.fused_subseq_range.launches == n0 + 1
    # The same f32 windows and the same verify order: bit for bit the
    # whole-series kernel over the materialised windows.
    ra, rd = fq.fused_range(**rows_args(sidx, args), **tile)
    assert torch.equal(ga, ra) and torch.equal(gd, rd)
    wa, wd = ref.fused_subseq_range_ref(**plain_args(args))
    ga, gd, wa, wd = (t.cpu().numpy() for t in (ga, gd, wa, wd))
    eps2 = (args["eps"] ** 2).cpu().numpy()[:, None]
    d_ref = np.where(np.isfinite(wd), wd, gd)
    assert not ((ga != wa) & (np.abs(d_ref - eps2) > band(eps2))).any()
    both = ga & wa
    assert both.sum() > 0
    assert np.all(np.abs(gd[both] - wd[both]) <= band(wd[both]))
    assert np.all(np.isinf(gd[~ga]))

    k = min(12, block_b)
    gi, gdd = fq.fused_subseq_topk(**args, k=k, **tile)
    torch.cuda.synchronize()
    ri, rdd = fq.fused_topk(**rows_args(sidx, args), k=k, **tile)
    assert torch.equal(gi, ri) and torch.equal(gdd, rdd)
    wi, wdd = ref.fused_subseq_topk_ref(**plain_args(args), k=k,
                                        block_b=block_b)
    np.testing.assert_array_equal(gi.cpu().numpy() < 0, wi.cpu().numpy() < 0)
    mg = fq.merge_topk_partials(gi, gdd, 5)
    mw = fq.merge_topk_partials(wi, wdd, 5)
    gd_m, wd_m = mg[1].cpu().numpy(), mw[1].cpu().numpy()
    fin = np.isfinite(wd_m)
    np.testing.assert_array_equal(np.isfinite(gd_m), fin)
    assert np.all(np.abs(gd_m[fin] - wd_m[fin]) <= band(wd_m[fin]))
    differ = mg[0].cpu().numpy() != mw[0].cpu().numpy()
    assert np.all(np.abs(gd_m[differ] - wd_m[differ]) <= band(wd_m[differ]))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("case", SUBSEQ_CASES[:3])
def test_quant_subseq_kernel_is_set_identical(cuda, mode, case):
    from repro_torch.core import subseq as ss

    hidx, sidx, _, args = subseq_case(case, cuda)
    qmeta = ss.quantize_subseq_meta(hidx, mode, cuda)
    full = {k: v for k, v in args.items() if k not in ("words", "residuals")}
    n0 = fq.fused_quant_subseq_range.launches
    ga, gd = fq.fused_quant_subseq_range(**full, qmeta=qmeta, block_q=16,
                                         block_b=256)
    torch.cuda.synchronize()
    assert fq.fused_quant_subseq_range.launches == n0 + 1
    fa, fd = fq.fused_subseq_range(**args, block_q=16, block_b=256)
    assert ga.sum() > 0
    assert torch.equal(ga, fa) and torch.equal(gd, fd)
    wa, wd = ref.fused_quant_subseq_range_ref(**plain_args(full),
                                              qmeta=qmeta)
    eps2 = (args["eps"] ** 2).cpu().numpy()[:, None]
    ga, gd, wa, wd = (t.cpu().numpy() for t in (ga, gd, wa, wd))
    d_ref = np.where(np.isfinite(wd), wd, gd)
    assert not ((ga != wa) & (np.abs(d_ref - eps2) > band(eps2))).any()


def test_subseq_constant_windows_on_card(cuda):
    # A flat stretch: σ is floored at 1e-8 and the windows z-normalise to
    # 0 in both the kernel and the plain version.
    _, sidx, _, args = subseq_case((2, 800, 64, 2, (4, 8), 6), cuda,
                                   flat=True)
    assert float(sidx.sd[0]) == pytest.approx(1e-8)
    ga, gd = fq.fused_subseq_range(**args, block_q=16, block_b=128)
    ra, rd = fq.fused_range(**rows_args(sidx, args), block_q=16,
                            block_b=128)
    assert torch.equal(ga, ra) and torch.equal(gd, rd)
    z = ref.device_windows(args["streams"], 64, 2, args["mu"], args["sd"])
    assert torch.equal(z, sidx.index.series)


@pytest.mark.parametrize("case", SUBSEQ_CASES)
def test_subseq_shared_memory_layout_matches_chooser(cuda, case):
    # The streaming Layout at one and two ring stages and at the
    # launcher's choice, and that choice, equal to the ops mirror.
    _, _, window, stride, levels, Q = case
    for topk, k_sel, quant in ((False, 0, None), (True, 12, None),
                               (False, 0, "int8"), (False, 0, "bf16")):
        for bq in ops.FUSED_BLOCK_Q:
            for stages in (None, 1, 2):
                assert fq.smem_bytes_of_kernel(
                    topk, window, levels, 10, bq, Q, k_sel, quant,
                    stride=stride, stages=stages) == ops.subseq_smem_bytes(
                        bq, window, stride, levels, 10, Q, k_sel, quant,
                        stages)
            assert fq.stages_of_kernel(
                topk, window, levels, 10, bq, Q, k_sel, quant,
                stride=stride) == ops.ring_stages(
                    bq, window, levels, 10, Q, k_sel, quant,
                    ops.subseq_seg_cap(window, stride))


@pytest.mark.parametrize("case", SUBSEQ_CASES)
def test_subseq_stage_count_does_not_change_results(cuda, case):
    # The streaming ring at one stage (the loop waits for each copy) and
    # at two (the next sub-tile's copies in flight while the z tile is
    # built and evaluated): kernels 3, 4 and 7 give the same bits, equal
    # to the whole-series kernels over the materialised windows.
    from repro_torch.core import subseq as ss

    hidx, sidx, _, args = subseq_case(case, cuda)
    rows = rows_args(sidx, args)
    for tile in (dict(block_q=32, block_b=1024), dict(block_q=16,
                                                      block_b=128)):
        ra, rd = fq.fused_range(**rows, **tile)
        k = min(12, tile["block_b"])
        ri, rdd = fq.fused_topk(**rows, k=k, **tile)
        for stages in (1, 2):
            ga, gd = fq.fused_subseq_range(**args, **tile, stages=stages)
            assert torch.equal(ga, ra)
            assert torch.equal(gd.view(torch.int32), rd.view(torch.int32))
            gi, gdd = fq.fused_subseq_topk(**args, k=k, **tile,
                                           stages=stages)
            assert torch.equal(gi, ri)
            assert torch.equal(gdd.view(torch.int32), rdd.view(torch.int32))
    full = {k: v for k, v in args.items() if k not in ("words", "residuals")}
    for mode in ("int8", "bf16"):
        qmeta = ss.quantize_subseq_meta(hidx, mode, cuda)
        fa, fd = fq.fused_subseq_range(**args, block_q=32, block_b=1024)
        for stages in (1, 2):
            qa, qd = fq.fused_quant_subseq_range(
                **full, qmeta=qmeta, block_q=32, block_b=1024, stages=stages)
            assert torch.equal(qa, fa)
            assert torch.equal(qd.view(torch.int32), fd.view(torch.int32))


def test_subseq_range_copy_clipped_at_the_buffer_end(cuda):
    # One stream of 1,001 samples at stride 1: the buffer ends off a
    # 16-byte boundary, so the last sub-tile's last chunk is clipped with
    # src-size (tests/test_torch_fused_layout.py models it); the result
    # equals the whole-series kernel's at both stage counts.
    _, sidx, _, args = subseq_case((1, 1001, 64, 1, (4, 8), 5), cuda)
    rows = rows_args(sidx, args)
    ra, rd = fq.fused_range(**rows, block_q=16, block_b=256)
    for stages in (1, 2):
        ga, gd = fq.fused_subseq_range(**args, block_q=16, block_b=256,
                                       stages=stages)
        assert torch.equal(ga, ra) and torch.equal(gd, rd)


def test_z_tile_divide_is_the_ieee_divide(cuda):
    # The streaming loader builds z = (x − μ)/σ with div.rn.f32 unrolled
    # (σ's reciprocal once per row, three FMAs per sample, __fdiv_rn out
    # of its range): bit for bit __fdiv_rn and torch's division on 2^22
    # random pairs whose exponents run across and past that range, on
    # divisors of all-ones mantissa, and on the edge values.
    rng = np.random.default_rng(5)
    n = 1 << 22

    def rand(size):
        return (rng.choice([-1.0, 1.0], size) * rng.uniform(1, 2, size)
                * np.exp2(rng.integers(-45, 46, size))).astype(np.float32)

    edges = np.array([0.0, -0.0, 1e-8, 2.0 ** -31, np.nextafter(
        np.float32(2.0 ** -31), np.float32(0)), 2.0 ** 32, np.nextafter(
        np.float32(2.0 ** 32), np.float32(0)), 1.0, -3.0, np.inf, -np.inf,
        np.nan, 1e-40, 3.4e38, 1.1754944e-38], np.float32)
    ones = (np.float32(2 - 2.0 ** -23)
            * np.exp2(np.arange(-40, 41))).astype(np.float32)
    ea, eb = np.meshgrid(edges, edges)
    a = np.concatenate([rand(n), ea.ravel(), rand(ones.size * 64)])
    b = np.concatenate([rand(n), eb.ravel(), np.repeat(ones, 64)])
    in_range = ((np.abs(a) >= 2.0 ** -31) & (np.abs(a) < 2.0 ** 32)
                & (np.abs(b) >= 2.0 ** -31) & (np.abs(b) < 2.0 ** 32))
    assert 0.2 < in_range.mean() < 0.9
    ta, tb = (torch.as_tensor(v, device=cuda) for v in (a, b))
    fast, rn = fq.divide_check(ta, tb)
    want = ta / tb
    nan = torch.isnan(rn)
    assert torch.equal(torch.isnan(fast), nan)
    assert torch.equal(torch.isnan(want), nan)
    assert torch.equal(fast.view(torch.int32)[~nan],
                       rn.view(torch.int32)[~nan])
    assert torch.equal(want.view(torch.int32)[~nan],
                       rn.view(torch.int32)[~nan])


def test_subseq_wrappers_refuse_misaligned_inputs(cuda):
    # The loader copies the streams, μ and σ with 16-byte cp.async: a view
    # off a 16-byte boundary is refused, never staged another way.
    _, _, _, args = subseq_case((3, 1000, 64, 3, (4, 8), 5), cuda)
    S, n_stream = args["streams"].shape
    W = args["mu"].shape[0]
    flat = torch.empty(S * n_stream + 1, device=cuda)
    streams = flat[1:].view(S, n_stream)
    streams.copy_(args["streams"])
    col = torch.empty(W + 1, device=cuda)[1:]
    col.copy_(args["mu"])
    for name, bad in (("streams", streams), ("mu", col), ("sd", col)):
        with pytest.raises(ValueError, match=f"{name} must be 16-byte"):
            fq.fused_subseq_range(**dict(args, **{name: bad}))
        with pytest.raises(ValueError, match=f"{name} must be 16-byte"):
            fq.fused_subseq_topk(**dict(args, **{name: bad}), k=5)


def test_subseq_engine_on_card_matches_torch_engine(cuda):
    from repro_torch.core import subseq as ss
    from repro_torch.core.options import SearchOptions

    _, sidx, qr, _ = subseq_case((3, 3000, 128, 4, (8, 16), 8), cuda)
    fq.reset_launch_counts()
    got = ss.subseq_range_query(sidx, qr, 2.0)
    want = ss.subseq_range_query(sidx, qr, 2.0,
                                 options=SearchOptions(backend="torch"))
    a, d = (t.cpu().numpy() for t in got)
    wa, wd = (t.cpu().numpy() for t in want)
    assert a.sum() > 0
    assert not ((a != wa) & (np.abs(np.where(np.isfinite(wd), wd, d) - 4.0)
                             > band(4.0))).any()
    gi, gd, ge = ss.subseq_knn_query(sidx, qr, 3, excl=64)
    wi, wd2, we = ss.subseq_knn_query(sidx, qr, 3, excl=64,
                                      options=SearchOptions(backend="torch"))
    assert ge.all() and we.all()
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd2, rtol=1e-5, atol=1e-5)
    assert fq.fused_subseq_range.launches == 1
    assert fq.fused_subseq_topk.launches == 2
    assert fq.fused_range.launches == fq.fused_topk.launches == 0


# ---------------------------------------------------------------------------
# The per-level kernels (csrc/level_ops.cu): bit for bit their plain
# versions, which are the engine's own device expressions.
# ---------------------------------------------------------------------------

# (B, n, N): B = 1; ragged B at n = 96 with L = 12 and L = 3; L = 1
# (N = n); N = 1 (L = n); a segment longer than a warp (n = 1024, L = 128).
# linfit's register body takes L = 2, 4, 8, 16, 32 with N ≤ 32 (N = 24 and
# 3 leave idle lanes and odd tails in its shuffle tree), the generic body
# the others.
SEG_CASES = [(1, 128, 8), (50_001, 96, 8), (700, 96, 32), (513, 128, 128),
             (300, 128, 1), (257, 1024, 8), (4096, 128, 16),
             (1000, 64, 32), (777, 128, 32), (2049, 256, 8), (999, 96, 24),
             (501, 96, 3)]
# (B, N, alphabet): B = 1, ragged B, N = 1 and N = 128, alphabets 3-20.
# The register word body takes N = 1, 2, 4, …, 128; 12 and 200 (a query
# word past the short parameter array) go through the generic one.
WORD_CASES = [(1, 8, 10), (50_001, 16, 10), (513, 128, 3), (300, 1, 20),
              (4096, 8, 20), (700, 4, 10), (333, 2, 5), (1000, 32, 10),
              (500, 64, 7), (300, 12, 10), (257, 200, 20), (5000, 16, 3)]


def level_rows(device, B, n, dtype, seed=6):
    x = torch.as_tensor(make_wafer_like(B, n, seed=seed), dtype=torch.float32,
                        device=device)
    return x.to(dtype).contiguous()


@pytest.mark.parametrize("case", SEG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_kernels_are_bit_identical(cuda, case, dtype):
    B, n, N = case
    x = level_rows(cuda, B, n, dtype)
    for wrapper, plain in ((lo.paa, ref.paa_ref),
                           (lo.linfit_residual_sq, ref.linfit_residual_sq_ref)):
        n0 = wrapper.launches
        got = wrapper(x, N)
        torch.cuda.synchronize()
        assert wrapper.launches == n0 + 1
        assert torch.equal(got, plain(x, N)), wrapper.__name__
    for q in (x[B // 2].clone(), x[B // 3].float() * 0.5):
        got = lo.sqdist(x, q)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.sqdist_ref(x, q))


# sqdist's register body (csrc ``sqdist_fast``): n = 2^k up to 1024; a
# row of 2048 goes through the segment body.
SQDIST_FAST_N = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
SQDIST_B = (1, 31, 33, 50_914, 1 << 20)


def sqdist_warp_rows(n):
    """Rows a warp of the register body takes (csrc ``sqdist_warp_rows``):
    32 below n = 32, else as many as 16 values a lane hold (at least 1)."""
    return 32 if n < 32 else max(1, 16 * 32 // n)


def spread_rows(device, shape, seed):
    """float32 values over many binades, made on the card, so that
    another summation order would show."""
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn(shape, generator=g, device=device)
    return v * torch.exp2(torch.randint(-12, 12, shape, generator=g,
                                        device=device).float())


def padded(t, width):
    """Rows (or the query) padded with zeros to ``width`` elements: a
    zero difference adds +0 at row_sum's first steps, so the squared
    distance is the same bit for bit."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


@pytest.mark.parametrize("n", SQDIST_FAST_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sqdist_register_body_is_bit_identical(cuda, n, dtype):
    # Against the plain version at ragged B, and against the segment body
    # on the same rows padded to 2048 elements (up to 50,914 rows).
    assert lo.tile_of("sqdist", n, 1) == (8 * sqdist_warp_rows(n), 0)
    assert lo.tile_of("sqdist", 2048, 1)[1] > 0
    for B in SQDIST_B:
        x = spread_rows(cuda, (B, n), B + n).to(dtype)
        q = spread_rows(cuda, (n,), 7 * n).to(dtype)
        n0 = lo.sqdist.launches
        got = lo.sqdist(x, q)
        torch.cuda.synchronize()
        assert lo.sqdist.launches == n0 + 1
        assert torch.equal(got, ref.sqdist_ref(x, q)), B
        if B <= 50_914:
            generic = lo.sqdist(padded(x, 2048), padded(q, 2048))
            assert torch.equal(got, generic), B
        del x, got


@pytest.mark.parametrize("n", [8, 128, 256])
def test_sqdist_mixed_dtypes_and_offsets(cuda, n):
    # A query in the other dtype than the rows; rows 4 bytes past a
    # 16-byte boundary (f32) and one element (2 bytes) past a 4-byte one
    # (bf16): the register body reads single elements and takes them all.
    B = 5003
    x32 = spread_rows(cuda, (B, n), n)
    q32 = spread_rows(cuda, (n,), n + 1)
    for x, q in ((x32, q32.bfloat16()), (x32.bfloat16(), q32),
                 (x32.bfloat16(), q32.bfloat16())):
        assert torch.equal(lo.sqdist(x, q), ref.sqdist_ref(x, q))
    for dtype, off in ((torch.float32, 4), (torch.bfloat16, 2)):
        flat = spread_rows(cuda, (B * n + 1,), 3 * n).to(dtype)
        x = flat[1:].view(B, n)
        assert x.data_ptr() % 16 == off and x.is_contiguous()
        q = x[B // 2].clone()
        got = lo.sqdist(x, q)
        assert torch.equal(got, ref.sqdist_ref(x, q)), dtype
        assert float(got[B // 2]) == 0.0
    # paa keeps the segment body, bit for bit.
    for N in (1, min(n, 16)):
        assert torch.equal(lo.paa(x32, N), ref.paa_ref(x32, N))


def test_sqdist_width_picks_the_body(cuda):
    # Powers of two up to 1024 take the register body (no shared memory);
    # other widths the segment body, the query staged beside the tile.
    for n in (1, 3, 16, 64, 96, 100, 128, 256, 1024, 2048):
        rows, smem = lo.tile_of("sqdist", n, 1)
        fast = n <= 1024 and n & (n - 1) == 0
        assert (smem == 0) == fast, n
        if fast:
            assert rows == 8 * sqdist_warp_rows(n), n
        else:
            assert smem == 4 * (rows * n + n), n


@pytest.mark.parametrize("case", WORD_CASES)
def test_word_kernels_are_bit_identical(cuda, case):
    B, N, alphabet = case
    n = 8 * N
    rng = np.random.default_rng(B + N)
    words = rng.integers(0, alphabet, (B, N)).astype(np.int32)
    words[0] = 0                                 # the extreme symbols
    words[-1] = alphabet - 1
    qword = rng.integers(0, alphabet, N)
    w = torch.as_tensor(words, device=cuda)
    tq = lo.query_table(qword, alphabet, cuda)
    n0 = lo.mindist_sq.launches
    got = lo.mindist_sq(w, qword, n, alphabet)
    torch.cuda.synchronize()
    assert lo.mindist_sq.launches == n0 + 1
    assert torch.equal(got, ref.mindist_sq_level_ref(w, tq, n))
    alive = torch.as_tensor(rng.random(B) < 0.7, device=cuda)
    res = torch.as_tensor(rng.random(B).astype(np.float32) * 4, device=cuda)
    res[B // 2] = 1e30                           # PAD_RESIDUAL
    for eps in (0.5, 2.0, 1e20):
        got = lo.prune_level(alive, res, w, qword, 1.3, eps, n, alphabet)
        torch.cuda.synchronize()
        want = ref.prune_level_ref(alive, res, w, tq, float(np.float32(1.3)),
                                   float(np.float32(eps)), n)
        assert torch.equal(got, want)
        assert not bool(got[B // 2])
        assert not bool((got & ~alive).any())


def test_level_kernels_take_unaligned_inputs(cuda):
    # Rows and words that start 4 bytes past a 16-byte boundary cannot be
    # loaded in vectors: the generic bodies take them, bit for bit.
    B, n, N = 1001, 128, 16
    flat = level_rows(cuda, B + 1, n, torch.float32).flatten()
    x = flat[1:1 + B * n].view(B, n)
    assert x.data_ptr() % 16 == 4
    for N_ in (8, 16):
        got = lo.linfit_residual_sq(x, N_)
        assert torch.equal(got, ref.linfit_residual_sq_ref(x, N_))
    rng = np.random.default_rng(3)
    buf = torch.as_tensor(rng.integers(0, 10, B * N + 1).astype(np.int32),
                          device=cuda)
    w = buf[1:].view(B, N)
    qword = rng.integers(0, 10, N)
    tq = lo.query_table(qword, 10, cuda)
    assert torch.equal(lo.mindist_sq(w, qword, 8 * N, 10),
                       ref.mindist_sq_level_ref(w, tq, 8 * N))
    alive = torch.ones(B, dtype=torch.bool, device=cuda)
    res = torch.zeros(B, device=cuda)
    got = lo.prune_level(alive, res, w, qword, 0.0, 2.0, 8 * N, 10)
    assert torch.equal(got, ref.prune_level_ref(alive, res, w, tq, 0.0, 2.0,
                                                8 * N))


@pytest.mark.parametrize("kind", ["mindist_sq", "prune_level"])
def test_word_wrappers_launch_once_and_allocate_only_the_output(cuda, kind):
    # One launch per call: no per-query panel, no index kernel, no
    # host-to-device copy (a call that copied from the host could not be
    # captured in a CUDA graph), nothing allocated but the output.
    B, N, alphabet, n = 4096, 16, 10, 128
    rng = np.random.default_rng(11)
    w = torch.as_tensor(rng.integers(0, alphabet, (B, N)).astype(np.int32),
                        device=cuda)
    qword = rng.integers(0, alphabet, N)
    alive = torch.as_tensor(rng.random(B) < 0.8, device=cuda)
    res = torch.as_tensor((rng.random(B) * 3).astype(np.float32),
                          device=cuda)
    wrapper = getattr(lo, kind)

    def call():
        if kind == "mindist_sq":
            return lo.mindist_sq(w, qword, n, alphabet)
        return lo.prune_level(alive, res, w, qword, 1.0, 2.0, n, alphabet)
    eager = call()                     # caches the table on the device
    torch.cuda.synchronize()
    n0 = wrapper.launches
    torch.cuda.reset_peak_memory_stats(cuda)
    live = torch.cuda.memory_allocated(cuda)
    out = call()
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    out_bytes = -(-out.numel() * out.element_size() // 512) * 512
    assert torch.cuda.max_memory_allocated(cuda) - live == out_bytes
    assert torch.equal(out, eager)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.parametrize("n,levels", [(128, (8, 16)), (96, (8, 32))])
def test_build_kernels_reproduce_the_device_index(cuda, n, levels):
    index = engine.build_device_index(make_wafer_like(20_001, n, seed=8),
                                      levels, 10, device=cuda)
    for li, N in enumerate(index.levels):
        res = torch.sqrt(lo.linfit_residual_sq(index.series, N))
        assert torch.equal(res, index.residuals[li])
        words = discretize(lo.paa(index.series, N), index.alphabet)
        assert torch.equal(words, index.words[li])


def test_level_wrappers_refuse_without_copying(cuda):
    x = torch.zeros((64, 128), device=cuda)
    words = torch.zeros((64, 8), dtype=torch.int32, device=cuda)
    x64, xt = x.double(), torch.zeros((128, 64), device=cuda).t()
    q_cpu, q_dev = torch.zeros(128), torch.zeros(64, device=cuda)
    w64 = words.long()
    alive_t = torch.ones((64, 2), dtype=torch.bool, device=cuda)[:, 0]
    res = torch.zeros(64, device=cuda)
    long = torch.zeros((1, lo.WORD_N_MAX + 1), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    launches = [k.launches for k in lo.KERNELS]
    torch.cuda.reset_peak_memory_stats(cuda)
    live = torch.cuda.memory_allocated(cuda)
    with pytest.raises(TypeError, match="float32"):
        lo.paa(x64, 8)
    with pytest.raises(ValueError, match="contiguous"):
        lo.linfit_residual_sq(xt, 8)
    with pytest.raises(ValueError, match="contiguous"):
        lo.sqdist(x[:, ::2], q_dev)
    with pytest.raises(ValueError, match="is on cpu"):
        lo.sqdist(x, q_cpu)
    with pytest.raises(TypeError, match="int32"):
        lo.mindist_sq(w64, np.zeros(8, np.int32), 128, 10)
    with pytest.raises(ValueError, match="contiguous"):
        lo.prune_level(alive_t, res, words, np.zeros(8, np.int32), 0.0, 1.0,
                       128, 10)
    with pytest.raises(ValueError, match="at most 16000"):
        lo.mindist_sq(long, np.zeros(lo.WORD_N_MAX + 1, np.int32),
                      lo.WORD_N_MAX + 1, 10)
    torch.cuda.synchronize()
    # Nothing was launched, and nothing was allocated: no input was copied.
    assert [k.launches for k in lo.KERNELS] == launches
    assert torch.cuda.max_memory_allocated(cuda) == live


def test_level_tiles_keep_four_blocks_per_sm(cuda):
    # The path's shapes (n = 128, levels 8 and 16) keep at least four
    # thread blocks resident per SM.
    for kind, N in (("paa", 16), ("linfit", 8), ("linfit", 16),
                    ("sqdist", 1), ("words", 16)):
        rows, smem = lo.tile_of(kind, 128, N)
        assert rows >= 1 and cost_model.blocks_per_sm(smem) >= 4, (kind, N)
    # linfit's register body holds 32 / N rows a warp and no shared
    # memory; the word body 32 rows a warp and the 20 × 20 table: both
    # full occupancy, eight blocks of 256 threads (sqdist's as linfit's).
    for N in (8, 16):
        assert lo.tile_of("linfit", 128, N) == (8 * (32 // N), 0)
        assert lo.tile_of("words", 128, N) == (256, 1600)
    # sqdist's register body: 4 rows a warp at n = 128, no shared memory.
    assert lo.tile_of("sqdist", 128, 1) == (32, 0)
    assert cost_model.blocks_per_sm(1600) == cost_model.blocks_per_sm(0) == 8
    # The generic bodies: one row per thread, its slices at odd strides.
    rows, smem = lo.tile_of("linfit", 96, 8)     # L = 12
    assert (rows, smem) == (256, 256 * 23 * 4)
    rows, smem = lo.tile_of("words", 96, 12)
    assert (rows, smem) == (256, 1600 + 256 * 13 * 4)


# ---------------------------------------------------------------------------
# The warp-parallel top-k selection, held exactly.  At the no-information
# radius ε = 1e28 (ε² = +inf in f32) C10 is open and C9 kills only the
# 1e30 sentinel residual, so every valid row is both a range answer and a
# top-k candidate, and the range form's d² is the top-k form's input bit
# for bit (one body, one arithmetic): the partials must be
# ``ref.block_topk`` of it exactly, idx and d² (compared as bits).
# ---------------------------------------------------------------------------

OPEN_EPS = 1e28
# (k_sel, block_b) with k_sel ≤ block_b.
SELECT_GRID = [(k, bb) for k in (1, 9, 67, 128) for bb in (64, 1024, 4096)
               if k <= bb]
SELECT_Q = 37                       # not a multiple of block_q 16 or 32
SELECT_B = 2 * 4096 + 1234          # a ragged last block
# Rows 5..4095 carry the C9 sentinel: the first block of every block_b
# keeps 5 valid rows (fewer than k_sel) or none.
DEAD_ROWS = slice(5, 4096)


def assert_selection_exact(got, range_d2, k, block_b):
    wi, wd = ref.block_topk(range_d2, k, block_b)
    gi, gd = got
    assert torch.equal(gi, wi)
    assert torch.equal(gd.view(torch.int32), wd.view(torch.int32))


def assert_selection_prefix(got, range_d2, k, block_b):
    """At a path's ε the top-k candidates are all survivors and the range
    answers those with d² ≤ ε²: each block's first min(k, answers) slots
    must be ``ref.block_topk`` of the range d² exactly."""
    wi, wd = ref.block_topk(range_d2, k, block_b)
    Q, B = range_d2.shape
    nb = wi.shape[1] // k
    fin = torch.isfinite(range_d2)
    fin = torch.cat([fin, fin.new_zeros((Q, nb * block_b - B))], dim=1)
    n_ans = fin.reshape(Q, nb, block_b).sum(-1).clamp(max=k)
    keep = torch.arange(k, device=wi.device)[None, None, :] < n_ans[..., None]
    gi, gd = (t.reshape(Q, nb, k) for t in got)
    wi, wd = wi.reshape(Q, nb, k), wd.reshape(Q, nb, k)
    assert int(keep.sum()) > 0
    assert torch.equal(gi[keep], wi[keep])
    assert torch.equal(gd[keep].view(torch.int32), wd[keep].view(torch.int32))


def tie_rows(B, seed=11):
    """B rows that repeat 600 distinct wafer-like series: d² ties are
    common (a repeated row has the same d² bit for bit)."""
    base = make_wafer_like(600, 128, seed=seed)
    return np.ascontiguousarray(np.resize(base, (B, 128)))


@pytest.fixture(scope="module")
def select_case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    db = tie_rows(SELECT_B)
    index = engine.build_device_index(db, (8, 16), 10, normalize=False,
                                      device=dev)
    qr = engine.represent_queries(
        torch.as_tensor(make_queries(db, SELECT_Q, seed=12),
                        dtype=torch.float32, device=dev), (8, 16), 10,
        normalize=False)
    res0 = index.residuals[0].clone()
    res0[DEAD_ROWS] = fq.PAD_RESIDUAL
    residuals = (res0,) + tuple(index.residuals[1:])
    open_eps = torch.full((SELECT_Q,), OPEN_EPS, device=dev)
    path_eps = torch.linspace(1.0, 3.0, SELECT_Q, device=dev)
    return {name: engine._fused_inputs(index, qr, residuals, eps)
            for name, eps in (("open", open_eps), ("path", path_eps))}


@pytest.mark.parametrize("k,block_b", SELECT_GRID)
@pytest.mark.parametrize("block_q", [16, 32])
def test_fused_topk_selection_is_exact(select_case, k, block_b, block_q):
    tile = dict(block_q=block_q, block_b=block_b)
    for name, check in (("open", assert_selection_exact),
                        ("path", assert_selection_prefix)):
        args = select_case[name]
        _, rd = fq.fused_range(**args, **tile)
        got = fq.fused_topk(**args, k=k, **tile)
        torch.cuda.synchronize()
        if name == "open":
            assert int(torch.isfinite(rd).sum()) == SELECT_Q * (
                SELECT_B - (DEAD_ROWS.stop - DEAD_ROWS.start))
        check(got, rd, k, block_b)


@pytest.fixture(scope="module")
def select_subseq_case():
    """Four streams of 6,000 samples, windows of 64 at stride 4 (W = 5,940,
    a ragged last block); streams 1 and 3 repeat a 64-sample pattern, so
    many windows are equal and their d² tie."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import subseq as ss
    from repro_torch.core.fastsax import FastSAXConfig
    from repro_torch.data.timeseries import make_subseq_queries

    dev = torch.device("cuda")
    streams = make_wafer_like(4, 6000, seed=13, normalize=False)
    for s in (1, 3):
        streams[s] = np.resize(streams[s, :64], 6000)
    hidx = ss.build_subseq_index(
        streams, FastSAXConfig(n_segments=(4, 8), alphabet=10), 64, 4)
    sidx = ss.subseq_device_index(hidx, dev)
    qr = ss.represent_subseq_queries(
        sidx, make_subseq_queries(streams, SELECT_Q, 64, seed=14))
    res0 = sidx.index.residuals[0].clone()
    res0[DEAD_ROWS] = fq.PAD_RESIDUAL
    base = dict(streams=sidx.streams, mu=sidx.mu, sd=sidx.sd,
                norms_sq=sidx.index.norms_sq, words=sidx.index.words,
                residuals=(res0,) + tuple(sidx.index.residuals[1:]),
                q=qr.q, q_words=qr.words,
                q_residuals=qr.residuals, levels=(4, 8), alphabet=10,
                window=64, stride=4)
    # The path's radii: alternate rows at the k-NN seed radius and at 2.
    knn = (torch.arange(SELECT_Q, device=dev) % 2 == 0).reshape(-1, 1)
    seed = engine._slacked(engine._seed_eps(sidx.index, qr, 8, None))
    path_eps = torch.where(knn, seed, torch.full_like(seed, 2.0))
    return sidx, {
        "open": dict(base, eps=torch.full((SELECT_Q,), OPEN_EPS,
                                          device=dev)),
        "path": dict(base, eps=path_eps.reshape(-1).contiguous())}


@pytest.mark.parametrize("k,block_b", SELECT_GRID)
@pytest.mark.parametrize("block_q", [16, 32])
def test_subseq_topk_selection_is_exact(select_subseq_case, k, block_b,
                                        block_q):
    sidx, cases = select_subseq_case
    tile = dict(block_q=block_q, block_b=block_b)
    for name, check in (("open", assert_selection_exact),
                        ("path", assert_selection_prefix)):
        args = cases[name]
        _, rd = fq.fused_subseq_range(**args, **tile)
        got = fq.fused_subseq_topk(**args, k=k, **tile)
        torch.cuda.synchronize()
        check(got, rd, k, block_b)
        # The same partials as the whole-series kernel over the windows.
        rows = fq.fused_topk(**rows_args(sidx, args), k=k, **tile)
        assert torch.equal(got[0], rows[0]) and torch.equal(
            got[1].view(torch.int32), rows[1].view(torch.int32))


@pytest.fixture(scope="module", params=["int8", "bf16"])
def select_quant_case(request):
    """The tier of :func:`tie_rows`, with level 0's residual codes of
    ``DEAD_ROWS`` set to the padding sentinel (int8 127, bf16 1e30)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.index import quantized as quant

    mode, dev = request.param, torch.device("cuda")
    db = tie_rows(SELECT_B)
    qhost = quant.quantize_host_index(
        build_index(db, FastSAXConfig(n_segments=(8, 16), alphabet=10)),
        mode)
    lv0 = qhost.levels[0]
    codes = lv0.residuals.copy()
    n_dead = DEAD_ROWS.stop - DEAD_ROWS.start
    codes[DEAD_ROWS] = (quant.SENTINEL_CODE if mode == "int8"
                        else quant.bf16_encode(np.full(n_dead, 1e30)))
    qhost = dataclasses.replace(qhost, levels=(
        dataclasses.replace(lv0, residuals=codes),) + qhost.levels[1:])
    qdev = engine.quantized_device_index(qhost, dev)
    qr = engine.represent_queries(
        torch.as_tensor(make_queries(db, SELECT_Q, seed=12),
                        dtype=torch.float32, device=dev), (8, 16), 10)
    return {name: (qdev, qr.q, qr.words, qr.residuals, eps) for name, eps in (
        ("open", torch.full((SELECT_Q,), OPEN_EPS, device=dev)),
        ("path", torch.linspace(1.0, 3.0, SELECT_Q, device=dev)))}


@pytest.mark.parametrize("k,block_b", SELECT_GRID)
@pytest.mark.parametrize("block_q", [16, 32])
def test_quant_topk_selection_is_exact(select_quant_case, k, block_b,
                                       block_q):
    # The tier's top-k candidates are the kept rows at any ε (the screen's
    # thresh² filters both forms), so the partials are exact at both radii.
    tile = dict(block_q=block_q, block_b=block_b)
    for name in ("open", "path"):
        args = select_quant_case[name]
        _, rd = fq.fused_quant_range(*args, **tile)
        got = fq.fused_quant_topk(*args, k=k, **tile)
        torch.cuda.synchronize()
        assert int(torch.isfinite(rd).sum()) > 0
        assert_selection_exact(got, rd, k, block_b)


def test_topk_tiles_keep_two_blocks_per_sm(cuda):
    # The top-k form at the subseq-1M tile (window 128, stride 4, k_sel
    # 67) and the serve-1M tiles (k_sel 9 and the served k bucket 8 + 4),
    # Q = 32, block_q 32: two thread blocks resident per SM.
    for k_sel, stride in ((67, 4), (9, 0), (12, 0)):
        smem = fq.smem_bytes_of_kernel(True, 128, (8, 16), 10, 32, 32, k_sel,
                                       stride=stride)
        assert cost_model.blocks_per_sm(smem) == 2, (k_sel, stride, smem)


# ---------------------------------------------------------------------------
# The ring of asynchronous stages (csrc/fused_query.cu): its room at the
# path's tiles, its ragged edges and its independence of the stage count.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [None, "int8", "bf16"])
def test_range_tiles_keep_two_blocks_per_sm(cuda, quant):
    # The range form at the serve-1M tile (Q = 32, block_q 32, n = 128,
    # levels (8, 16)), full precision and both quantized tiers: two
    # ring stages and two thread blocks resident per SM.
    smem = fq.smem_bytes_of_kernel(False, 128, (8, 16), 10, 32, 32, 0,
                                   quant=quant)
    assert smem == ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, 0, quant)
    assert cost_model.fused_blocks_per_sm(smem) == 2, (quant, smem)
    assert fq.stages_of_kernel(False, 128, (8, 16), 10, 32, 32, 0,
                               quant=quant) == 2


def test_ring_stages_match_the_mirror(cuda):
    # Two stages wherever they keep the block count one stage gives: the
    # serve-1M tiles and subseq-1M's streaming range and top-k (k_sel 67);
    # one at k_sel 67 over 128-sample rows (the lists leave no room) and
    # on the streaming loader at k_sel 128 from stride 12 and at stride
    # 150's 32 KB stages.
    for topk, k_sel, quant, stride, want in (
            (False, 0, None, 0, 2), (True, 12, None, 0, 2),
            (True, 12, "int8", 0, 2), (True, 12, "bf16", 0, 2),
            (True, 67, None, 0, 1), (True, 128, None, 0, 1),
            (False, 0, None, 4, 2), (True, 67, None, 4, 2),
            (False, 0, "int8", 4, 2), (True, 128, None, 12, 1),
            (False, 0, None, 150, 1)):
        got = fq.stages_of_kernel(topk, 128, (8, 16), 10, 32, 32, k_sel,
                                  quant=quant, stride=stride)
        seg = ops.subseq_seg_cap(128, stride) if stride else 0
        assert got == want == ops.ring_stages(32, 128, (8, 16), 10, 32,
                                              k_sel, quant, seg)
        for stages in (1, 2):
            assert fq.smem_bytes_of_kernel(
                topk, 128, (8, 16), 10, 32, 32, k_sel, quant=quant,
                stride=stride, stages=stages) == (
                ops.subseq_smem_bytes(32, 128, stride, (8, 16), 10, 32,
                                      k_sel, quant, stages) if stride else
                ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, k_sel, quant,
                                     stages=stages))


def padded_views(index, B):
    """The first B rows of ``index``'s columns as views of buffers whose
    rows past B hold NaN (series) and out-of-range words and residuals."""
    def pad(t, fill):
        buf = torch.full((t.shape[0] + 64,) + tuple(t.shape[1:]), fill,
                         dtype=t.dtype, device=t.device)
        buf[:B] = t[:B]
        return buf[:B]
    return dict(series=pad(index.series, float("nan")),
                norms_sq=pad(index.norms_sq, float("nan")),
                words=tuple(pad(w, 1 << 20) for w in index.words),
                residuals=tuple(pad(r, float("nan"))
                                for r in index.residuals))


@pytest.mark.parametrize("B", [37, 50_001])
def test_ring_ragged_edges(cuda, B):
    # A B smaller than one 64-row sub-tile and a ragged B: the kernels
    # agree with their plain versions, give the same bits whatever lies
    # past row B in the columns' buffers (nothing past B is read, the
    # masked rows of the last sub-tile are zero-filled), and with one or
    # two stages.
    index, qr, args = kernel_args((9, B, (8, 16), 10), cuda)
    tile = dict(block_q=32, block_b=1024)
    ga, gd = fq.fused_range(**args, **tile)
    wa, wd = ref.fused_range_ref(**plain_args(args))
    ga_, gd_, wa, wd = (t.cpu().numpy() for t in (ga, gd, wa, wd))
    eps2 = (args["eps"] ** 2).cpu().numpy()[:, None]
    d_ref = np.where(np.isfinite(wd), wd, gd_)
    assert not ((ga_ != wa) & (np.abs(d_ref - eps2) > band(eps2))).any()
    gi, gdd = fq.fused_topk(**args, k=9, **tile)
    assert int(gi.max()) < B and bool((gi >= 0).any())
    views = dict(args, **padded_views(index, B))
    for stages in (1, 2):
        va, vd = fq.fused_range(**views, **tile, stages=stages)
        assert torch.equal(va, ga) and torch.equal(vd.view(torch.int32),
                                                   gd.view(torch.int32))
        vi, vdd = fq.fused_topk(**views, k=9, **tile, stages=stages)
        assert torch.equal(vi, gi) and torch.equal(vdd.view(torch.int32),
                                                   gdd.view(torch.int32))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("B", [37, 50_001])
def test_quant_ring_ragged_edges(cuda, mode, B):
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.index import quantized as quant

    db = make_wafer_like(B, 128, seed=9)
    qhost = quant.quantize_host_index(
        build_index(db, FastSAXConfig(n_segments=(8, 16), alphabet=10)),
        mode)
    qdev = engine.quantized_device_index(qhost, cuda)
    qr = engine.represent_queries(
        torch.as_tensor(make_queries(db, 9, seed=10), dtype=torch.float32,
                        device=cuda), (8, 16), 10)
    eps = torch.linspace(1.0, 3.0, 9, device=cuda)
    args = (qdev, qr.q, qr.words, qr.residuals, eps)
    gk, gd = fq.fused_quant_range(*args, block_q=32, block_b=1024)
    wk, wd = ref.fused_quant_range_ref(*quant_plain(args))
    lim2 = ref.screen_limit_sq(eps, qdev.series_err).cpu().numpy()
    gk_, gd_, wk, wd = (t.cpu().numpy() for t in (gk, gd, wk, wd))
    d_ref = np.where(np.isfinite(wd), wd, gd_)
    assert not ((gk_ != wk) & (np.abs(d_ref - lim2) > band(lim2))).any()
    for stages in (1, 2):
        sk, sd = fq.fused_quant_range(*args, block_q=32, block_b=1024,
                                      stages=stages)
        assert torch.equal(sk, gk) and torch.equal(sd.view(torch.int32),
                                                   gd.view(torch.int32))
    gi, _ = fq.fused_quant_topk(*args, k=9, block_q=16, block_b=1024)
    assert int(gi.max()) < B


def test_stage_count_does_not_change_results(cuda):
    # One stage (synchronous) and two (the ring) run the same arithmetic:
    # range answers, d² and top-k partials equal bit for bit, at Q > one
    # query chunk and with four levels.
    for case in ((33, 1000, (8, 16), 10), (5, 300, (4, 8, 16, 32), 10)):
        _, _, args = kernel_args(case, cuda)
        for tile in (dict(block_q=32, block_b=128),
                     dict(block_q=16, block_b=1024)):
            one = fq.fused_range(**args, **tile, stages=1)
            two = fq.fused_range(**args, **tile, stages=2)
            assert torch.equal(one[0], two[0])
            assert torch.equal(one[1].view(torch.int32),
                               two[1].view(torch.int32))
            one = fq.fused_topk(**args, k=9, **tile, stages=1)
            two = fq.fused_topk(**args, k=9, **tile, stages=2)
            assert torch.equal(one[0], two[0])
            assert torch.equal(one[1].view(torch.int32),
                               two[1].view(torch.int32))


# ---------------------------------------------------------------------------
# The index lifecycle on the card: stores, warm starts, generation swaps.
# ---------------------------------------------------------------------------

def _lifecycle_host(B=6000):
    from repro_torch.core.fastsax import FastSAXConfig, build_index

    db = make_wafer_like(B + 512, 128, seed=0)
    return db, build_index(db[:B], FastSAXConfig(n_segments=(8, 16)),
                           normalize=False)


def _launches():
    return {k.__name__: k.launches for k in fq.KERNELS}


def _lifecycle_workload(db, n=48):
    return make_workload(make_queries(db, 16, seed=1), WorkloadSpec(
        n_requests=n, knn_frac=0.5, k=5, epsilon=2.0))


def test_upload_host_array_chunks_match_the_cast(cuda, tmp_path,
                                                 monkeypatch):
    # A read-only f64 memmap, in pinned chunks of a few rows, lands as
    # the f32 cast of the whole array; int and bf16-bit columns as they
    # are.
    a = np.random.default_rng(0).standard_normal((1001, 37))
    np.save(tmp_path / "a.npy", a)
    mm = np.load(tmp_path / "a.npy", mmap_mode="r")
    monkeypatch.setattr(engine, "_UPLOAD_CHUNK_BYTES", 37 * 4 * 7)
    got = engine.upload_host_array(mm, torch.float32, cuda)
    assert torch.equal(got.cpu(), torch.from_numpy(a.astype(np.float32)))
    w = np.random.default_rng(1).integers(0, 10, (999, 16), dtype=np.int32)
    assert torch.equal(engine.upload_host_array(w, torch.int32, cuda).cpu(),
                       torch.from_numpy(w))
    assert engine.upload_host_array(a[:0], torch.float32, cuda).shape == \
        (0, 37)


def test_store_round_trip_is_the_direct_upload(cuda, tmp_path):
    from repro_torch.index.store import save_index
    from repro_torch.serve.service import _SingleBackend

    db, host = _lifecycle_host()
    save_index(host, tmp_path / "idx")
    warm = engine.DeviceIndex.from_store(tmp_path / "idx")
    direct = engine.device_index_from_host(host, cuda)
    assert warm.device.type == "cuda"
    for a, b in zip((warm.series, warm.norms_sq, *warm.words,
                     *warm.residuals),
                    (direct.series, direct.norms_sq, *direct.words,
                     *direct.residuals)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    svc = SearchService.from_store(tmp_path / "idx")
    assert svc.backend.backend == "cuda"
    ref_svc = SearchService(_SingleBackend(direct, ServeConfig()))
    workload = _lifecycle_workload(db)
    fq.reset_launch_counts()
    with svc:
        result = run_closed_loop(svc, workload, clients=8)
        assert result.served == len(workload)
        launches = _launches()
        assert launches["fused_range"] > 0 and launches["fused_topk"] > 0
        assert check_exactness(svc, workload, result) == 0
    for kind, q, eps, k in workload:
        ids, dist = svc.direct_query(kind, q, epsilon=eps, k=k)
        ids2, dist2 = ref_svc.direct_query(kind, q, epsilon=eps, k=k)
        assert np.array_equal(ids, ids2) and np.array_equal(dist, dist2)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_store_served_zero_copy(cuda, tmp_path, monkeypatch,
                                          mode):
    from repro_torch.index import quantized as tq
    from repro_torch.index import store

    db, host = _lifecycle_host()
    store.save_index(host, tmp_path / "qidx", quantization=mode)

    def no_requantize(*a, **k):
        raise AssertionError("the stored tier was quantized again")

    monkeypatch.setattr(tq, "quantize_host_index", no_requantize)
    svc = SearchService.from_store(tmp_path / "qidx",
                                   ServeConfig(quantization=mode))
    monkeypatch.undo()
    qdev = svc.backend.tindex.dev
    stored = store.load_quantized(tmp_path / "qidx", mode=mode)
    want = np.asarray(stored.series)
    got = qdev.series.view(torch.int16).cpu().numpy().view(np.uint16) \
        if mode == "bf16" else qdev.series.cpu().numpy()
    assert np.array_equal(got, want)
    cold = SearchService.from_series(db[:6000], ServeConfig(
        quantization=mode), normalize=False)
    workload = _lifecycle_workload(db)
    fq.reset_launch_counts()
    with svc:
        result = run_closed_loop(svc, workload, clients=8)
        assert _launches()["fused_quant_range"] > 0
        assert check_exactness(svc, workload, result) == 0
    for (kind, q, eps, k), req in zip(workload, result.requests):
        ids, dist = cold.direct_query(kind, q, epsilon=eps, k=k)
        assert np.array_equal(ids, req.ids)
        np.testing.assert_allclose(dist, req.distances, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_generation_swap_under_requests_in_flight(cuda, tmp_path,
                                                  quantization):
    """The background swap uploads on a side stream while batches run on
    the current one; every request submitted after the install replays
    exactly, and the inserted rows are found by their external ids."""
    import threading
    import time

    from repro_torch.core.fastsax import FastSAXConfig
    from repro_torch.index.mutable import MutableIndex

    db = make_wafer_like(40_000, 128, seed=0)
    MutableIndex.create(tmp_path / "root", db[:32_000],
                        FastSAXConfig(n_segments=(8, 16)), normalize=False)
    svc = SearchService.from_store(tmp_path / "root", ServeConfig(
        quantization=quantization))
    workload = _lifecycle_workload(db[:32_000], n=64)
    new_rows = db[32_000:40_000]
    rounds = []
    with svc:
        svc.delete(np.arange(0, 32_000, 97))
        inserter = threading.Thread(target=svc.insert, args=(new_rows,))
        inserter.start()
        deadline = time.perf_counter() + 120.0
        while (svc.generation < 2 or not rounds
               or rounds[-1][0] <= svc._last_refresh):
            assert time.perf_counter() < deadline, "no swap landed"
            rounds.append((time.perf_counter(),
                           run_closed_loop(svc, workload, clients=16)))
        inserter.join()
        swapped_at = svc._last_refresh
        after = [(w, r) for _, res in rounds
                 for w, r in zip(workload, res.requests)
                 if r.t_submit > swapped_at]
        assert after and all(r.status == "ok" for _, r in after)
        for (kind, q, eps, k), req in after:
            ids, dist = svc.direct_query(kind, q, epsilon=eps, k=k)
            assert np.array_equal(ids, req.ids)
            np.testing.assert_allclose(dist, req.distances, rtol=1e-6,
                                       atol=1e-9)
        for j in (0, 4_000, 7_999):
            got, _ = svc.knn(new_rows[j], 1)
            assert got[0] == 32_000 + j
        deleted = set(range(0, 32_000, 97))
        assert not deleted & set(np.concatenate(
            [r.ids for _, res in rounds for r in res.requests
             if r.t_submit > swapped_at]).tolist())
    events = svc.stats.snapshot()["events"]
    assert events["refresh_swaps"] >= 1 and events["refresh_failures"] == 0
    assert svc.generation == svc.mutable.generation == 2
    assert set(svc.last_refresh_times) == {"snapshot_s", "upload_s",
                                           "install_s"}


def test_traced_counters_on_card_equal_the_cpu(cuda):
    # The counting pass is torch glue: on the card it counts what the same
    # call counts on the CPU.  Radii are handed over from the CPU, so both
    # count at the same f32 values.
    from repro_torch.obs.trace import to_host

    case = (8, 3000, (8, 16), 10)
    index_g, qr_g, _ = kernel_args(case, cuda)
    index_c, qr_c, _ = kernel_args(case, "cpu")
    eps = torch.linspace(0.5, 3.0, 8)
    knn = torch.arange(8) % 3 == 0
    ans_c, _, tr_c = engine.range_query_traced(index_c, qr_c, eps)
    ans_g, _, tr_g = engine.range_query_traced(index_g, qr_g, eps.to(cuda))
    _, nn_d2, _ = engine.knn_query_auto(index_c, qr_c, 5)
    out_c = engine.mixed_query_dense(index_c, qr_c, eps, knn, 8)
    pairs = [(tr_g, tr_c),
             (engine.knn_radius_trace(index_g, qr_g, nn_d2.to(cuda), 5),
              engine.knn_radius_trace(index_c, qr_c, nn_d2, 5)),
             (engine.mixed_trace(index_g, qr_g, eps.to(cuda), knn.to(cuda),
                                 8, out_c[1].to(cuda), out_c[2].to(cuda)),
              engine.mixed_trace(index_c, qr_c, eps, knn, 8, out_c[1],
                                 out_c[2]))]
    for got, want in pairs:
        got, want = to_host(got), to_host(want)
        for f in ("after_c9", "after_c10", "screen_survivors", "verified"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    # The range answers came from kernel 1; their count is the trace's.
    np.testing.assert_array_equal(to_host(tr_g).answers,
                                  ans_g.sum(-1).cpu().numpy())


def test_profiler_capture_names_the_fused_kernels(cuda, tmp_path):
    import json

    from repro_torch.obs.spans import prepare_profiler, profiler_capture

    case = (8, 3000, (8, 16), 10)
    index, qr, _ = kernel_args(case, cuda)
    eps = torch.full((8,), 2.0, device=cuda)
    knn = torch.arange(8, device=cuda) % 2 == 0
    engine.mixed_query_fused(index, qr, eps, knn, 5)      # built, warm
    torch.cuda.synchronize()
    prepare_profiler(cuda)
    with profiler_capture(tmp_path, cuda):
        engine.mixed_query_fused(index, qr, eps, knn, 5)
        torch.cuda.synchronize()
    (path,) = sorted(tmp_path.glob("dispatch_*.json"))
    names = {e.get("name", "") for e in json.loads(path.read_text())
             ["traceEvents"] if e.get("cat") == "kernel"}
    assert any("fused_range_kernel" in n for n in names), names
    assert any("fused_topk_kernel" in n for n in names), names


# ---------------------------------------------------------------------------
# Extended representation stacks on the card: the kernels keep answering.
# ---------------------------------------------------------------------------

EXT_STACK = ("linfit_residual", "sax_word", "trend_slope")


def ext_case(device, B=4096, Q=8):
    from repro_torch.data.timeseries import make_trending
    db = make_trending(B, 128, seed=3)
    qs = make_queries(db, Q, seed=4)
    out = {}
    for stack in (EXT_STACK, engine.DEFAULT_STACK):
        index = engine.build_device_index(db, (8, 16), 10, normalize=False,
                                          stack=stack, device=device)
        qr = engine.represent_queries(
            torch.as_tensor(qs, dtype=torch.float32, device=device),
            (8, 16), 10, stack=stack)
        out[stack] = (index, qr)
    return db, qs, out


def test_extended_stack_serves_on_card_through_the_kernels(cuda):
    """The extended stack's service runs kernels 1-2 on the card like the
    paper stack's; asked for the torch engine, it runs none.  All three
    replay exactly and give the same answers."""
    db, qs, _ = ext_case(cuda)
    wl = make_workload(qs, WorkloadSpec(n_requests=32, k=5, epsilon=1.0))
    results = {}
    for stack, backend in ((EXT_STACK, "auto"), (engine.DEFAULT_STACK, "auto"),
                           (EXT_STACK, "torch")):
        svc = SearchService.from_series(
            db, ServeConfig(stack=stack, backend=backend), normalize=False)
        assert svc.backend.index.device.type == "cuda"
        assert svc.backend.index.stack == stack
        fq.reset_launch_counts()
        with svc:
            result = run_closed_loop(svc, wl, clients=4)
            assert check_exactness(svc, wl, result) == 0
        launched = fq.fused_range.launches + fq.fused_topk.launches
        if backend == "torch":
            assert svc.backend.backend == "torch" and launched == 0
        else:
            assert svc.backend.backend == "cuda" and launched > 0
        results[stack, backend] = result
    want = results[engine.DEFAULT_STACK, "auto"].requests
    for key in ((EXT_STACK, "auto"), (EXT_STACK, "torch")):
        for a, b in zip(results[key].requests, want):
            assert sorted(a.ids.tolist()) == sorted(b.ids.tolist())


def test_extended_answers_equal_fused_paper_stack(cuda):
    """The torch engine's cascade with trend_slope on the card against
    kernels 1-2 on the paper stack; on the extended index the backend
    dispatchers reach the kernels and equal them on the paper index."""
    _, _, out = ext_case(cuda)
    eindex, eqr = out[EXT_STACK]
    pindex, pqr = out[engine.DEFAULT_STACK]
    for eps in (0.5, 1.0, 2.0):
        ea, ed = engine.range_query(eindex, eqr, eps)
        pa, pd = engine.range_query_fused(pindex, pqr, eps)
        differ = (ea != pa).cpu().numpy()
        d2 = torch.where(pa, pd, ed).cpu().numpy()
        near = np.abs(d2 - eps * eps) <= band(eps * eps)
        assert not (differ & ~near).any()
        fq.reset_launch_counts()
        ba, bd = engine.range_query_backend(eindex, eqr, eps)
        assert fq.fused_range.launches == 1
        assert torch.equal(ba, pa) and torch.equal(bd, pd)
    ei, ed, ee = engine.knn_query_auto(eindex, eqr, 5)
    pi, pdd, pe = engine.knn_query_fused(pindex, pqr, 5)
    assert bool(ee.all()) and bool(pe.all())
    same = (ei == pi).cpu().numpy()
    gap = np.abs(ed.cpu().numpy() - pdd.cpu().numpy())
    assert np.all(same | (gap <= band(pdd.cpu().numpy())))
    bi, bd, be = engine.knn_query_backend(eindex, eqr, 5)
    assert torch.equal(bi, pi) and torch.equal(bd, pdd) and bool(be.all())


def test_mindist_sq_at_n_equal_N_is_trend_slope_bound(cuda):
    from repro_torch.core import representation as rep_registry
    _, _, out = ext_case(cuda, B=50_001)
    index, qr = out[EXT_STACK]
    rep = rep_registry.get("trend_slope")
    tab = ops.mindist_table_cached(10, str(cuda))
    for li, N in enumerate(index.levels):
        words = index.extra[li]["trend_slope"]
        for qi in range(2):
            qword = qr.extra[li]["trend_slope"][qi].cpu().numpy()
            got = lo.mindist_sq(words, qword, N, 10)
            torch.cuda.synchronize()
            want = ref.mindist_sq_level_ref(
                words, lo.query_table(qword, 10, cuda), N)
            assert torch.equal(got, want)
            bound = rep.dev_bound_sq(
                words, qr.extra[li]["trend_slope"][qi:qi + 1], n=index.n,
                N=N, tab=tab)[0]
            assert torch.equal(got, bound)


@pytest.mark.parametrize("Q", [1, 32])
def test_dense_switch_replays_exactly_at_2_20_rows(cuda, Q):
    """The torch engine's two layouts at B = 2^20: a mixed batch served
    compact (capacity escalation) and dense (``mixed_query_dense``, every
    row in chunks) gives each row the same answers and bit-identical
    distances, so a request replayed across the service's dense switch
    gets what it was served."""
    B, n, levels, k = 1 << 20, 128, (8, 16), 5
    gen = torch.Generator(device=cuda).manual_seed(11)
    walk = torch.cumsum(torch.randn((B, n), generator=gen, device=cuda),
                        dim=-1)
    index = engine.build_device_index(walk, levels, 10)
    rows = torch.arange(Q, device=cuda) * (B // 32 - 1)
    noise = 0.1 * torch.randn((Q, n), generator=gen, device=cuda)
    qr = engine.represent_queries(index.series[rows] + noise, levels, 10)
    is_knn = torch.arange(Q, device=cuda) % 2 == 1
    eps = torch.full((Q,), 4.0, device=cuda)
    idx, ans, d2, _ = engine.mixed_query_auto(index, qr, eps, is_knn, k)
    didx, dans, dd2, _ = engine.mixed_query_dense(index, qr, eps, is_knn, k)
    for qi in range(Q):
        if bool(is_knn[qi]):
            ci, cd = engine.mixed_topk(idx[qi:qi + 1], d2[qi:qi + 1], k)
            di, dd = engine.mixed_topk(didx[qi:qi + 1], dd2[qi:qi + 1], k)
            assert torch.equal(ci, di) and torch.equal(cd, dd)
        else:
            got = idx[qi][ans[qi]].long()
            assert torch.equal(torch.sort(got).values,
                               torch.nonzero(dans[qi]).flatten())
            assert torch.equal(d2[qi][ans[qi]], dd2[qi][got])
