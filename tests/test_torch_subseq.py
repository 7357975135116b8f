"""The port's subsequence search against the reference's, on the CPU.

The host index (``repro_torch.core.subseq.build_subseq_index``, numpy f64)
must give the reference's words and its residuals to 1e-12 relative; the
windows and their norms ‖z‖² built on the device (f32) the reference's to
1e-6.  The plain versions of the three streaming kernels (what
``kernels.fused_query.fused_subseq_range`` / ``fused_subseq_topk`` /
``fused_quant_subseq_range`` run on CPU tensors) are held against the
reference's Pallas kernels in interpret mode and its ``xla`` backend, on
the reference's own index carried across by
``subseq_host_index_from_numpy``; the k-NN entry point, the exclusion
zone and the service against the reference and an f64 brute force.  The
CUDA kernels themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances: d² within ``1e-3 + 1e-5·d²``, the band of the other engine
tests — the matmul form ‖q‖² − 2·q·z + ‖z‖² cancels terms of size ~w, so
two f32 summation orders differ by ~1e-5 — and answers equal outside
that band around ε².  The exact-verify forms (k-NN re-verify in the diff²
form) are compared to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import subseq as jss
from repro.core.fastsax import FastSAXConfig as JConfig
from repro.core.options import SearchOptions as JOptions
from repro.data.timeseries import make_subseq_queries as jqueries
from repro.kernels import fused_query as jfq
import repro.serve as jserve
from repro_torch.core import engine as teng
from repro_torch.core import subseq as tss
from repro_torch.core.fastsax import FastSAXConfig
from repro_torch.core.options import SearchOptions
from repro_torch.data.timeseries import make_subseq_queries, make_wafer_like
from repro_torch.kernels import fused_query as tfq
from repro_torch.kernels import ref as tref
from repro_torch.serve import ServeConfig, SubseqSearchService

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                  # pragma: no cover
    from _mini_hypothesis import given, settings, strategies as st

LEVELS, ALPHABET = (4, 8), 10
# (streams, stream length, window, stride): strides 1, 3 and 4; windows
# per stream not a multiple of the reference's 64-window blocks.
CASES = [(3, 600, 64, 1), (4, 1000, 64, 3), (3, 800, 32, 4)]
CUDA = SearchOptions(backend="cuda")     # the fused path (plain on CPU)
TORCH = SearchOptions(backend="torch")


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def joptions(backend):
    return JOptions(backend=backend)


def carry(jh):
    """A reference host index carried into the port."""
    return tss.subseq_host_index_from_numpy(
        jh.streams, jh.mu, jh.sd, [lv.words for lv in jh.levels],
        [lv.residuals for lv in jh.levels], jh.config.levels,
        jh.config.alphabet, jh.window, jh.stride)


def make_case(S, n, window, stride, Q=4, seed=0):
    """The same streams and queries in both packages: the reference's
    device index and query representation, and the port's over the
    carried host index."""
    streams = make_wafer_like(S, n, seed=seed, normalize=False)
    jh = jss.build_subseq_index(
        streams, JConfig(n_segments=LEVELS, alphabet=ALPHABET), window,
        stride)
    jd = jss.subseq_device_index(jh)
    td = tss.subseq_device_index(carry(jh), device="cpu")
    qs = make_subseq_queries(streams, Q, window, seed=seed + 1)
    return (streams, jh, jd, jss.represent_subseq_queries(jd, qs), td,
            tss.represent_subseq_queries(td, qs), qs)


def eps_of(Q):
    return np.linspace(1.0, 4.0, Q).astype(np.float32)


def assert_range_agrees(got, want, eps):
    """Answers equal outside the band around ε², d² within the band."""
    ga, gd = (np.asarray(t) for t in got)
    wa, wd = (np.asarray(t) for t in want)
    eps2 = (np.asarray(eps, np.float64) ** 2)[:, None]
    d_ref = np.where(np.isfinite(wd), wd, gd)
    assert not ((ga != wa) & (np.abs(d_ref - eps2) > band(eps2))).any()
    both = ga & wa
    assert both.sum() > 0
    assert np.all(np.abs(gd[both] - wd[both]) <= band(wd[both]))
    assert np.all(np.isinf(gd[~ga]))


# ---------------------------------------------------------------------------
# Host half: the amortised features, the carried index, the queries.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 3, 4])
@pytest.mark.parametrize("window,levels", [(64, (4, 8)), (32, (4, 16))])
def test_host_index_matches_reference(stride, window, levels):
    streams = make_wafer_like(3, 500, seed=2, normalize=False)
    jh = jss.build_subseq_index(streams, JConfig(n_segments=levels), window,
                                stride)
    th = tss.build_subseq_index(streams, FastSAXConfig(n_segments=levels),
                                window, stride)
    assert th.n_windows == jh.n_windows and th.window_meta(7) == \
        jh.window_meta(7)
    np.testing.assert_allclose(th.mu, jh.mu, rtol=1e-12, atol=0)
    np.testing.assert_allclose(th.sd, jh.sd, rtol=1e-12, atol=0)
    for jl, tl in zip(jh.levels, th.levels):
        assert tl.n_segments == jl.n_segments
        np.testing.assert_array_equal(tl.words, jl.words)
        np.testing.assert_allclose(tl.residuals, jl.residuals, rtol=1e-12,
                                   atol=1e-300)
    np.testing.assert_allclose(tss.materialize_windows_np(th),
                               jss.materialize_windows_np(jh), rtol=1e-12,
                               atol=1e-12)


def test_carried_index_equals_own_build():
    streams = make_wafer_like(2, 400, seed=3, normalize=False)
    jh = jss.build_subseq_index(
        streams, JConfig(n_segments=LEVELS, level_order="paper"), 64, 2)
    th = tss.build_subseq_index(
        streams, FastSAXConfig(n_segments=LEVELS, level_order="paper"), 64, 2)
    got = carry(jh)
    assert got.config.levels == th.config.levels == (8, 4)
    for a, b in zip(got.levels, th.levels):
        np.testing.assert_array_equal(a.words, b.words)
        np.testing.assert_allclose(a.residuals, b.residuals, rtol=1e-12)
    with pytest.raises(ValueError, match="words must be"):
        tss.subseq_host_index_from_numpy(
            jh.streams, jh.mu, jh.sd, [lv.words[:-1] for lv in jh.levels],
            [lv.residuals for lv in jh.levels], (8, 4), 10, 64, 2)


def test_subseq_queries_match_reference():
    streams = make_wafer_like(3, 700, seed=4, normalize=False)
    np.testing.assert_array_equal(make_subseq_queries(streams, 9, 64, seed=5),
                                  jqueries(streams, 9, 64, seed=5))


# ---------------------------------------------------------------------------
# Device half: the windows, their norms, the query representation.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_device_windows_and_norms_match_reference(case):
    _, _, jd, jqr, td, tqr, _ = make_case(*case)
    np.testing.assert_allclose(td.index.series.numpy(),
                               np.asarray(jd.index.series), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.index.norms_sq.numpy(),
                               np.asarray(jd.index.norms_sq), rtol=1e-6)
    # The streaming kernels' window build is the same expression.
    z = tref.device_windows(td.streams, td.window, td.stride, td.mu, td.sd)
    assert torch.equal(z, td.index.series)
    wid = torch.tensor([0, 5, td.windows_per_stream, td.n_windows - 1])
    assert torch.equal(tref.device_windows(td.streams, td.window, td.stride,
                                           td.mu, td.sd, wid),
                       td.index.series[wid])
    np.testing.assert_allclose(tqr.q.numpy(), np.asarray(jqr.q), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(tqr.words, jqr.words):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_window_meta_maps_canonical_ids():
    _, jh, jd, _, td, _, _ = make_case(3, 600, 64, 3)
    wid = np.array([0, 1, td.windows_per_stream, td.n_windows - 1, -1])
    for got, want in zip(td.window_meta(wid), jd.window_meta(wid)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The three plain kernels against the reference's Pallas kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_subseq_range_matches_reference_pallas_and_xla(case):
    _, _, jd, jqr, td, tqr, _ = make_case(*case)
    eps = eps_of(4)
    got = tss.subseq_range_query(td, tqr, torch.as_tensor(eps), CUDA)
    want_p = jss.subseq_range_query_pallas(jd, jqr, jnp.asarray(eps),
                                           block_q=8, block_w=64,
                                           interpret=True)
    want_x = jss.subseq_range_query(jd, jqr, jnp.asarray(eps),
                                    joptions("xla"))
    assert got[0].shape == (4, td.n_windows)
    assert_range_agrees(got, want_p, eps)
    assert_range_agrees(got, want_x, eps)
    # The torch backend is the engine over the materialised windows.
    assert_range_agrees(tss.subseq_range_query(td, tqr, torch.as_tensor(eps),
                                               TORCH), want_x, eps)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("block_b", [64, 256])
def test_subseq_topk_partials_match_reference_pallas(case, block_b):
    _, _, jd, jqr, td, tqr, _ = make_case(*case)
    eps = eps_of(4)
    k = 6
    gi, gd = tfq.fused_subseq_topk(
        td.streams, td.mu, td.sd, td.index.norms_sq, td.index.words,
        td.index.residuals, tqr.q, tqr.words, tqr.residuals,
        torch.as_tensor(eps), levels=td.levels, alphabet=ALPHABET,
        window=td.window, stride=td.stride, k=k, block_b=block_b)
    assert gi.shape == (4, -(-td.n_windows // block_b) * k)
    jp = jeng._query_panels(jqr, ALPHABET)
    wi, wd = jfq.fused_subseq_topk_pallas(
        jd.streams, jd.mu, jd.sd, jd.index.norms_sq, jd.index.words,
        jd.index.residuals, jqr.q, jp, jqr.residuals, jnp.asarray(eps),
        levels=jd.levels, alphabet=ALPHABET, window=jd.window,
        stride=jd.stride, k=k, block_q=8, block_w=64, interpret=True)
    # The two layouts block differently; the merged top-k must agree up
    # to swaps of near-equal d².
    mg = [t.numpy() for t in tfq.merge_topk_partials(gi, gd, 5)]
    mw = [np.asarray(t) for t in jfq.merge_topk_partials(wi, wd, 5)]
    fin = np.isfinite(mw[1])
    np.testing.assert_array_equal(np.isfinite(mg[1]), fin)
    assert np.all(np.abs(mg[1][fin] - mw[1][fin]) <= band(mw[1][fin]))
    differ = mg[0] != mw[0]
    assert np.all(np.abs(mg[1][differ] - mw[1][differ])
                  <= band(mw[1][differ]))
    assert (mg[0][fin] < td.n_windows).all() and (mg[0][~fin] == -1).all()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_quant_subseq_range_is_set_identical(mode, case):
    _, jh, jd, jqr, td, tqr, _ = make_case(*case)
    eps = torch.as_tensor(eps_of(4))
    qmeta = tss.quantize_subseq_meta(carry(jh), mode, device="cpu")
    got = tss.subseq_range_query_quantized(td, qmeta, tqr, eps)
    full = tss.subseq_range_query(td, tqr, eps, CUDA)
    assert got[0].sum() > 0
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    jmeta = jss.quantize_subseq_meta(jh, mode)
    want = jss.subseq_range_query_quantized(jd, jmeta, jqr,
                                            jnp.asarray(eps.numpy()),
                                            block_q=8, block_w=64,
                                            interpret=True)
    assert_range_agrees(got, want, eps.numpy())


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quant_meta_matches_reference(mode):
    _, jh, _, _, td, _, _ = make_case(3, 800, 32, 4)
    got = tss.quantize_subseq_meta(carry(jh), mode, device="cpu")
    want = jss.quantize_subseq_meta(jh, mode)
    W = td.n_windows
    assert got.mode == mode
    for li in range(len(LEVELS)):
        np.testing.assert_array_equal(got.words[li].numpy(),
                                      np.asarray(want.words[li]))
        res = got.residuals[li]
        if mode == "bf16":
            res = res.view(torch.int16)
            np.testing.assert_array_equal(
                res.numpy(), np.asarray(want.residuals[li]).view(np.int16))
        else:
            np.testing.assert_array_equal(res.numpy(),
                                          np.asarray(want.residuals[li]))
        for name in ("scale", "zero", "err"):
            g, w = getattr(got, name)[li], getattr(want, name)[li]
            if w is None:
                assert g is None
                continue
            assert g.shape == (-(-W // 128),)
            np.testing.assert_array_equal(
                tref.expand_block_col(g, W).numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The entry points: k-NN with the exclusion zone, the demotion.
# ---------------------------------------------------------------------------


def brute_greedy(streams, qs, window, stride, k, excl):
    """The exclusion-zone greedy over the full f64 distance profile."""
    bf = tss.subseq_brute_force_d2(streams, qs, window, stride)
    W_s = tss.n_windows_per_stream(streams.shape[1], window, stride)
    order = np.argsort(bf, axis=1, kind="stable")
    wid = np.arange(bf.shape[1])
    return tss.suppress_trivial_matches(
        order, np.take_along_axis(bf, order, 1), wid // W_s,
        (wid % W_s) * stride, k, excl)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("excl", [0, 8, None])
def test_subseq_knn_matches_reference_and_brute_force(case, excl):
    streams, _, jd, jqr, td, tqr, qs = make_case(*case)
    k = 3
    e = td.window // 2 if excl is None else excl
    kf = tss.knn_fetch_count(k, e, td.stride, td.n_windows)
    fused = teng.resolve_knn_backend("cuda", kf, "cpu") == "cuda"
    got = tss.subseq_knn_query(td, tqr, k, excl=excl, options=CUDA)
    tor = tss.subseq_knn_query(td, tqr, k, excl=excl, options=TORCH)
    want = jss.subseq_knn_query(jd, jqr, k, excl=excl,
                                options=joptions("xla"))
    bi, bd = brute_greedy(streams, qs, td.window, td.stride, k, e)
    assert got[2].all() and tor[2].all()
    assert got[0].dtype == np.int64 and got[1].shape == (4, k)
    for g in (got, tor):
        np.testing.assert_array_equal(g[0], want[0])
        np.testing.assert_array_equal(g[0], bi)
        np.testing.assert_allclose(g[1], bd, rtol=1e-5, atol=1e-5)
    # The diff² re-verify is the torch engine's expression.
    np.testing.assert_array_equal(got[1], tor[1])
    assert fused == (kf + teng._TOPK_GUARD <= 100)


def test_fetch_count_and_large_fetch_demotion(monkeypatch):
    assert tss.exclusion_zone_span(0, 4) == 1
    assert tss.exclusion_zone_span(64, 4) == 31
    assert tss.knn_fetch_count(3, 64, 4, 1_048_080) == 63
    assert tss.knn_fetch_count(5, 64, 4, 1_048_080) == 125
    assert tss.knn_fetch_count(3, 64, 2, 50) == 50
    assert tss.knn_fetch_count(1, 64, 1, 10_000) == 1
    assert teng.resolve_knn_backend("cuda", 63, "cpu") == "cuda"
    assert teng.resolve_knn_backend("cuda", 125, "cpu") == "torch"
    # k = 5 at excl = 64, stride 4 fetches 125 windows: the fused k-NN
    # demotes to the torch engine, with the same answers.
    streams, _, jd, jqr, td, tqr, _ = make_case(3, 1000, 128, 4)
    want = jss.subseq_knn_query(jd, jqr, 5, excl=64,
                                options=joptions("xla"))
    called = []
    monkeypatch.setattr(tss, "_subseq_knn_fused",
                        lambda *a, **k: called.append(1))
    got = tss.subseq_knn_query(td, tqr, 5, excl=64, options=CUDA)
    assert not called
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)


def test_subseq_range_against_brute_force():
    streams, _, _, _, td, tqr, qs = make_case(4, 1000, 64, 3)
    eps = eps_of(4)
    bf = tss.subseq_brute_force_d2(streams, qs, 64, 3)
    ans, d2 = tss.subseq_range_query(td, tqr, torch.as_tensor(eps), CUDA)
    want = bf <= (eps.astype(np.float64) ** 2)[:, None]
    off = ans.numpy() != want
    assert not (off & (np.abs(bf - (eps ** 2)[:, None]) > band(bf))).any()


@settings(max_examples=6, deadline=None, database=None)
@given(st.integers(1, 5), st.integers(0, 2 ** 16), st.integers(0, 24))
def test_subseq_knn_property(stride, seed, excl):
    rng = np.random.default_rng(seed)
    streams = np.cumsum(rng.standard_normal((2, 300)), axis=1)
    hidx = tss.build_subseq_index(streams, FastSAXConfig(n_segments=(4, 8)),
                                  32, stride)
    td = tss.subseq_device_index(hidx, device="cpu")
    qs = make_subseq_queries(streams, 3, 32, seed=seed)
    tqr = tss.represent_subseq_queries(td, qs)
    got = tss.subseq_knn_query(td, tqr, 2, excl=excl, options=CUDA)
    bi, bd = brute_greedy(streams, qs, 32, stride, 2, excl)
    assert got[2].all()
    np.testing.assert_array_equal(got[0], bi)
    np.testing.assert_allclose(got[1], bd, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The service, the launcher and what needs a later slice.
# ---------------------------------------------------------------------------


def test_service_replay_exact_and_matches_engine_and_reference():
    streams = make_wafer_like(2, 600, seed=0, normalize=False)
    cfg = ServeConfig(levels=LEVELS, alphabet=ALPHABET, max_batch=8,
                      max_wait_ms=5.0)
    svc = SubseqSearchService.from_streams(streams, 64, 2, cfg, excl=16,
                                           device="cpu")
    assert svc.backend.backend == "torch"
    qs = make_subseq_queries(streams, 6, 64, seed=1)
    k = 3
    with svc:
        reqs = [svc.submit_subseq_knn(q, k) for q in qs]
        reqs += [svc.submit_subseq_range(q, 4.0) for q in qs]
        for r in reqs:
            assert r.wait(120.0) == "ok"
    sidx = svc.sidx
    qr = tss.represent_subseq_queries(sidx, qs)
    eng_idx, eng_d2, _ = tss.subseq_knn_query(sidx, qr, k, excl=16)
    jsvc = jserve.SubseqSearchService.from_streams(
        streams, 64, 2, jserve.ServeConfig(levels=LEVELS, alphabet=ALPHABET),
        excl=16)
    for i, q in enumerate(qs):
        ids, dist = svc.direct_subseq_knn(q, k)
        np.testing.assert_array_equal(reqs[i].ids, ids)
        np.testing.assert_array_equal(reqs[i].distances, dist)
        keep = eng_idx[i] >= 0
        np.testing.assert_array_equal(ids, eng_idx[i][keep])
        np.testing.assert_allclose(dist, np.sqrt(eng_d2[i][keep]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(ids, jsvc.direct_subseq_knn(q, k)[0])
    mask, _ = tss.subseq_range_query(sidx, qr, 4.0)
    for i, q in enumerate(qs):
        req = reqs[len(qs) + i]
        ids, dist = svc.direct_subseq_range(q, 4.0)
        np.testing.assert_array_equal(req.ids, ids)
        np.testing.assert_array_equal(req.distances, dist)
        np.testing.assert_array_equal(np.sort(ids),
                                      np.nonzero(mask[i].numpy())[0])
    sid, start = svc.window_meta(np.asarray([0, sidx.windows_per_stream]))
    assert sid.tolist() == [0, 1] and start.tolist() == [0, 0]


def test_launcher_serves_subsequences_on_cpu(capsys):
    from repro_torch.launch import serve as launch

    summary = launch.main(["--serve", "--subseq", "--device", "cpu",
                           "--streams", "3", "--stream-len", "700",
                           "--bench-requests", "24", "--clients", "4",
                           "--verify-exact"])
    assert "[subseq-serve]" in capsys.readouterr().out
    assert summary["served"] == 24 and summary["exact_mismatches"] == 0
    with pytest.raises(NotImplementedError, match="item 8"):
        launch.main(["--search", "--subseq"])


def test_later_slices_raise_naming_their_items():
    # The extended stack builds (its trend words from the window hook, as
    # the reference's); the subsequence service still serves full
    # precision only.
    streams = make_wafer_like(2, 300, seed=0, normalize=False)
    ext = ("linfit_residual", "sax_word", "trend_slope")
    hidx = tss.build_subseq_index(
        streams, FastSAXConfig(n_segments=LEVELS, stack=ext), 64, 2)
    jhidx = jss.build_subseq_index(
        streams, JConfig(n_segments=LEVELS, stack=ext), 64, 2)
    for lv, jlv in zip(hidx.levels, jhidx.levels):
        np.testing.assert_array_equal(lv.extra["trend_slope"],
                                      jlv.extra["trend_slope"])
    with pytest.raises(ValueError, match="quantization"):
        SubseqSearchService.from_streams(
            streams, 64, 2, ServeConfig(levels=LEVELS, quantization="int8"),
            device="cpu")


def test_subseq_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    streams = make_wafer_like(2, 300, seed=0, normalize=False)
    hidx = tss.build_subseq_index(streams, FastSAXConfig(n_segments=LEVELS),
                                  64, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tss.subseq_device_index(hidx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tss.quantize_subseq_meta(hidx, "int8")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SubseqSearchService.from_streams(streams, 64, 2,
                                         ServeConfig(levels=LEVELS))
