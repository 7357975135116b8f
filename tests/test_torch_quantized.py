"""The port's quantized resident tier against the reference's, on the CPU.

Host quantization (``repro_torch.index.quantized``) must equal
``repro.index.quantized`` bit for bit.  The screen's plain version (what
``kernels.fused_query.fused_quant_range`` runs on CPU tensors) is held
against the reference's XLA oracle ``engine.quantized_screen`` and its
Pallas kernel in interpret mode, on the reference's own quantized index
carried across by ``engine.quantized_device_index``; the tiered engines
and the service against the reference's and against the port's
full-precision engine.  The CUDA kernels themselves are held against the
plain versions on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: d̂² within ``1e-3 + 1e-5·d̂²``, the band of the other engine
tests: the matmul form ‖q‖² − 2·q·û + ‖û‖² cancels terms of size ~n, so
two f32 summation orders differ there by ~1e-5 (the reference's Pallas
screen and its own oracle differ by up to ~1e-4 on jax 0.9).  Keep masks
and answer sets must be equal except on rows within that band of the
boundary (thresh² for the screen, ε² for answers).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.fastsax import FastSAXConfig as JConfig
from repro.core.fastsax import build_index as jbuild
from repro.index import quantized as jq
from repro.kernels import fused_query as jfq
from repro.kernels import ops as jops
import repro.serve as jserve
from repro_torch.core import engine as teng
from repro_torch.core.fastsax import FastSAXConfig, build_index
from repro_torch.core.options import SearchOptions
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.index import quantized as tq
from repro_torch.index import store as tstore
from repro_torch.kernels import fused_query as tfq
from repro_torch.kernels import ref as tref
from repro_torch.serve import (SearchService, ServeConfig, WorkloadSpec,
                               check_exactness, make_workload,
                               run_closed_loop)

MODES = ("bf16", "int8")
N_LEN, LEVELS, ALPHABET = 64, (4, 8), 10
# B = 640 is a multiple of RESID_BLOCK; 300 and 1000 end on a ragged block.
SIZES = (300, 640, 1000)


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def host_indexes(B, seed=2):
    """The same (B, 64) series built by the reference and by the port."""
    db = make_wafer_like(B, N_LEN, seed=seed)
    jhost = jbuild(db, JConfig(n_segments=LEVELS, alphabet=ALPHABET),
                   normalize=False)
    thost = build_index(db, FastSAXConfig(n_segments=LEVELS,
                                          alphabet=ALPHABET), normalize=False)
    return db, jhost, thost


def queries(db, Q, seed=3):
    """A reference query representation and the same carried across."""
    q = make_queries(db, Q, seed=seed)
    jqr = jeng.represent_queries(jnp.asarray(q, jnp.float32), LEVELS,
                                 ALPHABET, normalize=False)
    t = lambda a: torch.as_tensor(np.array(a))
    tqr = teng.QueryReprDev(q=t(jqr.q), words=tuple(t(w) for w in jqr.words),
                            residuals=tuple(t(r) for r in jqr.residuals))
    return jqr, tqr


def assert_same_qhost(a, b):
    for f in ("mode", "n", "alphabet", "stack"):
        assert getattr(a, f) == getattr(b, f)
    for f in ("series", "series_scale", "series_zero", "series_err",
              "norms_sq"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
        else:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    for la, lb in zip(a.levels, b.levels, strict=True):
        assert la.n_segments == lb.n_segments
        for f in ("words", "residuals", "scale", "zero", "err"):
            x, y = getattr(la, f), getattr(lb, f)
            if x is None or y is None:
                assert x is None and y is None, f
            else:
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.resident_bytes() == b.resident_bytes()


# ---------------------------------------------------------------------------
# 1. Host quantization, bit for bit.
# ---------------------------------------------------------------------------

_ADVERSARIAL = {
    "constant": np.full(300, 3.14159),
    "all_zero": np.zeros(300),
    "huge_dynamic_range": np.concatenate(
        [np.logspace(-30, 30, 150), -np.logspace(-30, 28, 150)]),
    "single_outlier_per_block": np.where(
        np.arange(300) % tq.RESID_BLOCK == 7, 1e6, 1e-3),
    "gaussian": np.random.default_rng(5).standard_normal(300) * 3.0,
}


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_quantize_host_index_equals_reference(B, mode):
    _, jhost, thost = host_indexes(B)
    want = jq.quantize_host_index(jhost, mode)
    # The reference's host index through the port's quantizer, and the
    # port's own host index through it: both equal the reference.
    assert_same_qhost(tq.quantize_host_index(jhost, mode), want)
    assert_same_qhost(tq.quantize_host_index(thost, mode), want)
    assert tq.full_precision_resident_bytes(B, N_LEN, LEVELS) == \
        jq.full_precision_resident_bytes(B, N_LEN, LEVELS)


@pytest.mark.parametrize("name", sorted(_ADVERSARIAL))
@pytest.mark.parametrize("mode", MODES)
def test_quantize_adversarial_columns_equal_reference(name, mode):
    x = np.abs(_ADVERSARIAL[name])
    for got, want in zip(tq.quantize_residuals(x, mode),
                         jq.quantize_residuals(x, mode), strict=True):
        if want is None:
            assert got is None
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    rows = np.resize(_ADVERSARIAL[name], (3, 128))
    for got, want in zip(tq.quantize_series(rows, mode),
                         jq.quantize_series(rows, mode), strict=True):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_bf16_codec_equals_ml_dtypes():
    # Normal values, a double-rounding tie (1 + 2⁻⁸ + 2⁻⁴⁰), the
    # sentinel, signed zeros, subnormal and overflowing magnitudes.
    x = np.concatenate([
        np.random.default_rng(0).standard_normal(20000) * 10.0 ** np.random.
        default_rng(1).integers(-30, 30, 20000),
        [1 + 2.0 ** -8 + 2.0 ** -40, 1e30, 0.0, -0.0, 1e-40, 3.5e38, -7.0]])
    np.testing.assert_array_equal(tq.bf16_encode(x), jq.bf16_encode(x))
    u16 = jq.bf16_encode(x)
    np.testing.assert_array_equal(tq.bf16_decode(u16), jq.bf16_decode(u16))
    assert tq.bf16_decode(tq.bf16_encode(np.array([1e30])))[0] > 0.5e30


def test_quantization_refusals():
    _, _, thost = host_indexes(300)
    with pytest.raises(tq.QuantizationError, match="no quantized tier"):
        tq.quantize_host_index(thost, "none")
    with pytest.raises(tq.QuantizationError, match="must be one of"):
        tq.check_mode("int4")
    with pytest.raises(tq.QuantizationError, match="int8 range"):
        tq.narrow_words(np.array([[0, 127]]))
    assert np.array_equal(tq.narrow_words(np.array([[0, 126]])),
                          np.array([[0, 126]], np.int8))


# ---------------------------------------------------------------------------
# 2-3. The screen and its top-k form.
# ---------------------------------------------------------------------------


def screen_case(B, mode, Q=5, seed=2):
    db, jhost, _ = host_indexes(B, seed)
    jtier = jeng.TieredIndex.from_host(jhost, mode)
    jqr, tqr = queries(db, Q, seed + 1)
    tdev = teng.quantized_device_index(jq.quantize_host_index(jhost, mode),
                                       device="cpu")
    eps = np.linspace(0.5, 3.0, Q).astype(np.float32)
    return jtier, jqr, tdev, tqr, eps


def assert_screen_parity(got_k, got_d, want_k, want_d, lim2):
    got_k, want_k = np.asarray(got_k), np.asarray(want_k)
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    d_ref = np.where(np.isfinite(want_d), want_d, got_d)
    in_band = np.abs(d_ref - lim2) <= band(lim2)
    differ = got_k != want_k
    assert int((differ & ~in_band).sum()) == 0
    both = got_k & want_k
    assert np.all(np.abs(got_d[both] - want_d[both]) <= band(want_d[both]))
    assert np.all(np.isinf(got_d[~got_k]))
    assert int(want_k.sum()) > 0


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_fused_quant_range_plain_matches_oracle(B, mode):
    jtier, jqr, tdev, tqr, eps = screen_case(B, mode)
    Q = eps.size
    want_k, want_d = jeng.quantized_screen(
        jtier.dev, jqr, jnp.asarray(eps).reshape(Q, 1))
    eps_t = torch.as_tensor(eps)
    before = tfq.fused_quant_range.launches
    got_k, got_d = tfq.fused_quant_range(tdev, tqr.q, tqr.words,
                                         tqr.residuals, eps_t, block_q=16,
                                         block_b=128)
    assert tfq.fused_quant_range.launches == before    # CPU: plain version
    assert got_k.dtype == torch.bool and got_k.shape == (Q, B)
    lim2 = tref.screen_limit_sq(eps_t, tdev.series_err).numpy()
    assert_screen_parity(got_k.numpy(), got_d.numpy(), want_k, want_d, lim2)
    # The engine's oracle form is the same function.
    ok, od = teng.quantized_screen(tdev, tqr, eps_t)
    assert torch.equal(ok, got_k) and torch.equal(od, got_d)


@pytest.mark.parametrize("B", (300, 640))
@pytest.mark.parametrize("mode", MODES)
def test_fused_quant_range_plain_matches_pallas_interpret(B, mode):
    jtier, jqr, tdev, tqr, eps = screen_case(B, mode, Q=4)
    Q = eps.size
    want_k, want_d = jfq.fused_quant_range_pallas(
        jtier.dev, jqr.q, tuple(jops.query_panels(w, ALPHABET)
                                for w in jqr.words),
        jqr.residuals, jnp.asarray(eps).reshape(Q, 1), block_q=8,
        block_b=128, interpret=True)
    eps_t = torch.as_tensor(eps)
    got_k, got_d = tfq.fused_quant_range(
        tdev, tqr.q, tqr.words, tqr.residuals, eps_t)
    lim2 = tref.screen_limit_sq(eps_t, tdev.series_err).numpy()
    assert_screen_parity(got_k.numpy(), got_d.numpy(), want_k, want_d, lim2)


@pytest.mark.parametrize("mode", MODES)
def test_screen_kills_sentinel_rows_and_keeps_span_zero_blocks(mode):
    # Level 0's block 1 is all sentinel (int8 code 127 / bf16 1e30): no
    # row of it survives at any finite radius.  Block 2 has span 0 (int8
    # scale 1): its rows decode to the zero point and stay.
    _, jhost, _ = host_indexes(640)
    jhost.levels[0].residuals[256:384] = 1.5
    qhost = tq.quantize_host_index(jhost, mode)
    lv0 = qhost.levels[0]
    codes = lv0.residuals.copy()
    codes[128:256] = (tq.SENTINEL_CODE if mode == "int8"
                      else tq.bf16_encode(np.full(128, 1e30)))
    qhost = dataclasses.replace(qhost, levels=(
        dataclasses.replace(lv0, residuals=codes),) + qhost.levels[1:])
    if mode == "int8":
        assert lv0.scale[2] == 1.0
    tdev = teng.quantized_device_index(qhost, device="cpu")
    res0 = teng._dequant_residuals_dev(tdev, 0).numpy()
    assert np.all(res0[128:256] >= 0.5 * tq.PAD_RESIDUAL)
    np.testing.assert_array_equal(res0, qhost.levels[0].dequant_residuals())
    q = torch.as_tensor(make_wafer_like(3, N_LEN, seed=9), dtype=torch.float32)
    qr = teng.represent_queries(q, LEVELS, ALPHABET, normalize=False)
    keep, _ = teng.quantized_screen(tdev, qr, torch.full((3,), 1e6))
    assert not keep[:, 128:256].any()
    assert keep[:, 256:384].all() and keep[:, :128].all()


@pytest.mark.parametrize("B", (300, 1000))
@pytest.mark.parametrize("mode", MODES)
def test_fused_quant_topk_plain_matches_oracle_top_k(B, mode):
    jtier, jqr, tdev, tqr, eps = screen_case(B, mode, Q=5)
    Q, k = eps.size, 6
    _, dense = jeng.quantized_screen(jtier.dev, jqr,
                                     jnp.asarray(eps).reshape(Q, 1))
    dense = np.asarray(dense)
    eps_t = torch.as_tensor(eps)
    for block_b in (64, 128):
        idx, d2 = tfq.fused_quant_topk(tdev, tqr.q, tqr.words, tqr.residuals,
                                       eps_t, k=k, block_q=16,
                                       block_b=block_b)
        assert idx.shape == (Q, -(-B // block_b) * k)
        got_i, got_d = (t.numpy() for t in tfq.merge_topk_partials(idx, d2,
                                                                   k))
        for qi in range(Q):
            order = np.lexsort((np.arange(B), dense[qi]))[:k]
            want_d = dense[qi, order]
            fin = np.isfinite(want_d)
            np.testing.assert_array_equal(np.isfinite(got_d[qi]), fin)
            assert np.all(np.abs(got_d[qi][fin] - want_d[fin])
                          <= band(want_d[fin]))
            swap = got_i[qi][fin] != order[fin]
            assert np.all(np.abs(dense[qi, got_i[qi][fin][swap]]
                                 - want_d[fin][swap]) <= band(want_d[fin][swap]))


def test_carried_and_port_built_tiers_are_equal():
    _, jhost, thost = host_indexes(300)
    for mode in MODES:
        a = teng.quantized_device_index(jq.quantize_host_index(jhost, mode),
                                        device="cpu")
        b = teng.quantized_device_index(tq.quantize_host_index(thost, mode),
                                        device="cpu")
        for f in ("series", "series_scale", "series_zero", "series_err",
                  "norms_sq", "words", "residuals", "resid_scale",
                  "resid_zero", "resid_err"):
            x, y = getattr(a, f), getattr(b, f)
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            for u, v in zip(xs, ys, strict=True):
                assert (u is None and v is None) or torch.equal(u, v), f
        want_dtype = torch.bfloat16 if mode == "bf16" else torch.int8
        assert a.series.dtype == want_dtype and a.words[0].dtype == torch.int8
        np.testing.assert_array_equal(
            teng._dequant_series_dev(a).numpy(),
            jq.quantize_host_index(jhost, mode).dequant_series())


def test_wrapper_checks_its_inputs():
    _, _, tdev, tqr, eps = screen_case(300, "int8", Q=2)
    qw = tqr.words
    eps_t = torch.as_tensor(eps)
    bad = dataclasses.replace(tdev, series_scale=None)
    with pytest.raises(TypeError, match="series_scale"):
        tfq.fused_quant_range(bad, tqr.q, qw, tqr.residuals, eps_t)
    bad = dataclasses.replace(tdev, words=tuple(w.int() for w in tdev.words))
    with pytest.raises(TypeError, match="words"):
        tfq.fused_quant_range(bad, tqr.q, qw, tqr.residuals, eps_t)
    with pytest.raises(ValueError, match="k=0"):
        tfq.fused_quant_topk(tdev, tqr.q, qw, tqr.residuals, eps_t, k=0)


# ---------------------------------------------------------------------------
# 4. The tiered engines.
# ---------------------------------------------------------------------------


def tiers(B, mode, Q=6, seed=4):
    db, jhost, thost = host_indexes(B, seed)
    jqr, tqr = queries(db, Q, seed + 1)
    jtier = jeng.TieredIndex.from_host(jhost, mode)
    ttier = teng.TieredIndex.from_host(thost, mode, device="cpu")
    full = teng.device_index_from_host(thost, device="cpu")
    return jtier, jqr, ttier, tqr, full, thost.series


def assert_sets_within_band(got_ids, want_ids, d2_row, eps):
    sym = np.setxor1d(got_ids, want_ids)
    assert np.all(np.abs(d2_row[sym] - eps * eps) <= band(eps * eps))


def f64_d2(series, q):
    return ((series[None, :, :] - np.asarray(q, np.float64)[:, None, :])
            ** 2).sum(-1)


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_quantized_range_query_matches_reference_and_full_precision(B, mode):
    jtier, jqr, ttier, tqr, full, series = tiers(B, mode)
    Q = tqr.q.shape[0]
    eps = np.linspace(1.0, 3.0, Q).astype(np.float32)
    idx, ans, d2, exact = teng.quantized_range_query(
        ttier, tqr, torch.as_tensor(eps), SearchOptions(capacity=8))
    assert bool(exact.all()) and idx.shape[-1] >= 8 and bool(ans.any())
    jidx, jans, jd2, jexact = jeng.quantized_range_query(
        jtier, jqr, jnp.asarray(eps), jeng.SearchOptions(capacity=8))
    assert bool(np.asarray(jexact).all())
    fidx, fans, fd2, fover = teng.range_query_compact(
        full, tqr, torch.as_tensor(eps), B)
    assert not bool(fover.any())
    dd = f64_d2(series, tqr.q.numpy())
    for qi in range(Q):
        got = np.sort(idx[qi][ans[qi]].numpy())
        assert_sets_within_band(got, np.asarray(jidx)[qi][np.asarray(jans)[qi]],
                                dd[qi], eps[qi])
        assert_sets_within_band(got, fidx[qi][fans[qi]].numpy(), dd[qi],
                                eps[qi])
        rows = idx[qi][ans[qi]].numpy()
        np.testing.assert_allclose(d2[qi][ans[qi]].numpy(), dd[qi][rows],
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_quantized_knn_query_matches_reference_and_full_precision(B, mode):
    jtier, jqr, ttier, tqr, full, series = tiers(B, mode)
    dd = f64_d2(series, tqr.q.numpy())
    for k in (1, 5):
        ni, nd, ex = teng.quantized_knn_query(ttier, tqr, k)
        ji, jd, jex = jeng.quantized_knn_query(jtier, jqr, k)
        fi, fd, fex = teng.knn_query_auto(full, tqr, k)
        np.testing.assert_array_equal(ex.numpy(), np.asarray(jex))
        assert bool(ex.all()) and bool(fex.all())
        for want in (np.asarray(ji), fi.numpy()):
            off = ni.numpy() != want
            assert np.all(np.abs(dd[np.nonzero(off)[0], ni.numpy()[off]]
                                 - dd[np.nonzero(off)[0], want[off]])
                          <= band(dd[np.nonzero(off)[0], want[off]]))
        np.testing.assert_allclose(nd.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("B", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_quantized_mixed_query_matches_reference_and_prefetch(B, mode):
    jtier, jqr, ttier, tqr, full, series = tiers(B, mode)
    Q, k = tqr.q.shape[0], 4
    eps = np.full(Q, 2.0, np.float32)
    is_knn = np.arange(Q) % 2 == 0
    got = teng.quantized_mixed_query(ttier, tqr, torch.as_tensor(eps),
                                     torch.as_tensor(is_knn), k)
    pre = teng.quantized_mixed_query(
        ttier, tqr, torch.as_tensor(eps), torch.as_tensor(is_knn), k,
        SearchOptions(verify_prefetch=True))
    for a, b in zip(got, pre, strict=True):
        assert torch.equal(a, b)                      # bit for bit
    want = jeng.quantized_mixed_query(jtier, jqr, jnp.asarray(eps),
                                      jnp.asarray(is_knn), k)
    idx, ans, d2, over = got
    assert not bool(over.any()) and bool(ans[~torch.as_tensor(is_knn)].any())
    dd = f64_d2(series, tqr.q.numpy())
    ti, td = teng.mixed_topk(idx, d2, k)
    wi, wd = jeng.mixed_topk(want[0], want[2], k)
    for qi in range(Q):
        if is_knn[qi]:
            off = ti[qi].numpy() != np.asarray(wi)[qi]
            assert np.all(np.abs(dd[qi, ti[qi].numpy()[off]]
                                 - dd[qi, np.asarray(wi)[qi][off]])
                          <= band(dd[qi, np.asarray(wi)[qi][off]]))
        else:
            assert_sets_within_band(
                idx[qi][ans[qi]].numpy(),
                np.asarray(want[0])[qi][np.asarray(want[1])[qi]], dd[qi],
                eps[qi])


def test_verify_prefetch_chunks_equal_the_synchronous_gather():
    _, _, ttier, tqr, _, _ = tiers(640, "int8")
    valid = torch.zeros((6, 40), dtype=torch.bool)
    valid[:, ::3] = True
    valid[2] = False
    idx = torch.randint(0, 640, (6, 40), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(0))
    d_sync = teng._verify_tier(ttier.raw, idx, tqr.q, valid, SearchOptions())
    d_pre = teng._verify_tier(ttier.raw, idx, tqr.q, valid,
                              SearchOptions(verify_prefetch=True))
    assert torch.equal(d_sync, d_pre)
    assert torch.isinf(d_sync[~valid]).all()
    assert torch.isfinite(d_sync[valid]).all()
    empty = torch.zeros_like(valid)
    assert torch.isinf(teng._verify_tier(
        ttier.raw, idx, tqr.q, empty,
        SearchOptions(verify_prefetch=True))).all()


def test_gather_rows_clamps_and_checks():
    raw = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(tstore.gather_rows(raw, [[0, 9], [-2, 1]]),
                                  raw[[[0, 3], [0, 1]]])
    out = np.empty((2, 3), np.float32)
    assert tstore.gather_rows(raw, [3, 7], out=out) is out
    np.testing.assert_array_equal(out, raw[[3, 3]])
    np.testing.assert_array_equal(
        tstore.gather_rows(np.zeros((0, 3), np.float32), [1, 2]),
        np.zeros((2, 3), np.float32))

    class Torn:                       # a raw tier whose reads come back short
        shape = (4, 3)
        dtype = np.float64

        def __getitem__(self, ids):
            return np.zeros((np.size(ids) - 1, 3))

    with pytest.raises(IOError, match="truncated"):
        tstore.gather_rows(Torn(), [0, 1])


def test_tiered_seed_strides_over_the_raw_tier():
    _, _, ttier, tqr, _, _ = tiers(300, "int8")
    short = dataclasses.replace(ttier, raw=ttier.raw[:200])
    eps = teng._tiered_seed_eps(short, tqr, 3)
    sample = (np.arange(64) * 200) // 64
    dd = f64_d2(ttier.raw[sample].astype(np.float64), tqr.q.numpy())
    np.testing.assert_allclose(eps.numpy()[:, 0],
                               np.sqrt(np.sort(dd, -1)[:, 2]), rtol=1e-5)
    empty = dataclasses.replace(ttier, raw=ttier.raw[:0])
    assert torch.equal(teng._tiered_seed_eps(empty, tqr, 3),
                       torch.zeros((tqr.q.shape[0], 1)))


# ---------------------------------------------------------------------------
# 5. The service.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_tiered_service_matches_reference_service(mode):
    db = make_wafer_like(700, N_LEN, seed=0)
    wl = make_workload(make_queries(db, 12, seed=1),
                       WorkloadSpec(n_requests=24, knn_frac=0.5, k=5,
                                    epsilon=2.0, seed=3))
    cfg = ServeConfig(levels=LEVELS, quantization=mode)
    svc = SearchService.from_series(db, cfg, device="cpu")
    assert svc.backend.tindex.mode == mode and svc.backend.backend == "torch"
    with svc:
        got = run_closed_loop(svc, wl, clients=4)
        assert check_exactness(svc, wl, got) == 0
    assert got.served == len(wl)
    assert svc.backend.last_capacity >= 64 and svc.backend.last_d2h_bytes > 0
    jsvc = jserve.SearchService.from_series(
        db, jserve.ServeConfig(levels=LEVELS, quantization=mode))
    with jsvc:
        want = run_closed_loop(jsvc, wl, clients=4)
    series = svc.backend.tindex.raw.astype(np.float64)
    from repro_torch.core.paa import znormalize_np
    for (kind, q, eps, k), g, w in zip(wl, got.requests, want.requests):
        d2 = ((series - znormalize_np(np.asarray(q, np.float64))) ** 2).sum(-1)
        if kind == "range":
            assert_sets_within_band(g.ids, w.ids, d2, eps)
        else:
            off = g.ids != w.ids
            assert np.all(np.abs(d2[g.ids[off]] - d2[w.ids[off]])
                          <= band(d2[w.ids[off]]))
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-4,
                                       atol=1e-4)


def test_launcher_serves_the_tier_on_cpu(capsys):
    import json

    from repro_torch.launch.serve import main

    main(["--serve", "--device", "cpu", "--quantization", "int8",
          "--verify-prefetch", "--db-size", "300", "--bench-requests", "12",
          "--clients", "4", "--verify-exact"])
    out = capsys.readouterr().out
    assert "int8 resident tier" in out
    line = [ln for ln in out.splitlines()
            if ln.startswith("[serve] summary ")][-1]
    s = json.loads(line[len("[serve] summary "):])
    assert s["served"] == 12 and s["exact_mismatches"] == 0


# ---------------------------------------------------------------------------
# 6. What the slice leaves to later ones.
# ---------------------------------------------------------------------------


def test_unported_settings_raise():
    with pytest.raises(tq.QuantizationError, match="must be one of"):
        ServeConfig(quantization="int4")
    with pytest.raises(NotImplementedError, match="multi-device"):
        ServeConfig(quantization="int8", failover_shards=2)
    _, jhost, _ = host_indexes(300)
    qhost = jq.quantize_host_index(jhost, "int8")
    # A column the stack does not name is refused, not dropped; under a
    # stack that names it, it uploads.
    lv = dataclasses.replace(qhost.levels[0],
                             extra={"trend_slope": qhost.levels[0].words})
    stray = dataclasses.replace(qhost, levels=(lv,) + qhost.levels[1:])
    with pytest.raises(ValueError, match="trend_slope"):
        teng.quantized_device_index(stray, device="cpu")
    named = dataclasses.replace(
        stray, stack=("linfit_residual", "sax_word", "trend_slope"),
        levels=tuple(dataclasses.replace(
            q, extra={"trend_slope": q.words}) for q in stray.levels))
    qdev = teng.quantized_device_index(named, device="cpu")
    assert torch.equal(qdev.extra[0]["trend_slope"], qdev.words[0])
    with pytest.raises(TypeError, match="unexpected kwargs"):
        teng.quantized_range_query(None, None, 1.0, block_q=8)
