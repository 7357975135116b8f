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
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.kernels import fused_query as fq
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
    return index, qr, engine._fused_inputs(
        index, qr, index.residuals, engine._query_panels(qr, alphabet), eps)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("block_q", [16, 32])
def test_kernels_match_plain_versions(cuda, case, block_q):
    _, _, args = kernel_args(case, cuda)
    plain = {k: v for k, v in args.items() if k != "alphabet"}
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
