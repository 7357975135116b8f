"""The port's op-counted host engines and representation registry against
the reference's, on the CPU.

``repro_torch.core.search`` runs the same float64 numpy operations as
``repro.core.search`` on the same index, so everything is held to
equality: the indexes the two ``build_index`` make, bit for bit; answers
and distances; the telemetry counts; and the ``OpCounter`` totals and
``latency`` (integer op counts and the float computed from them).  Both
level orders, the paper stack and the ``trend_slope`` stack.

The level-at-a-time composition of the per-level kernels' plain versions
(what ``chip_smoke.py`` phase 13 runs on the card) is held against the
host engines with the f32 band rule: float32 columns may fall on the
other side of a threshold than float64 ones only within the band.
"""
import functools
import math
import warnings

import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import fastsax as jfs
from repro.core import representation as jrep
from repro.core import search as jsearch
from repro.core import subseq as jsubseq
from repro.core.options import SearchOptions as JOptions
from repro.index import quantized as jq
from repro_torch.core import cost_model as tcm
from repro_torch.core import engine as teng
from repro_torch.core import fastsax as tfs
from repro_torch.core import representation as trep
from repro_torch.core import search as tsearch
from repro_torch.core import subseq as tsubseq
from repro_torch.core.options import SearchOptions
from repro_torch.core.paa import znormalize_np
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.index import quantized as tq
from repro_torch.kernels import level_ops as lo
from repro_torch.kernels import ref as tref
from repro_torch.serve import ServeConfig

TREND = ("linfit_residual", "sax_word", "trend_slope")
STACKS = [trep.DEFAULT_STACK, TREND]
ORDERS = ["coarse_first", "paper"]
LEVELS = (8, 16)


def trending(B, n, seed):
    """Random walks with per-row linear trends (exercises slope symbols),
    not z-normalised: the builders normalise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / n
    return (np.cumsum(rng.standard_normal((B, n)), axis=-1) / np.sqrt(n)
            + rng.uniform(-4.0, 4.0, (B, 1)) * t[None, :])


@functools.lru_cache(maxsize=None)
def indexes(stack, order, B=600, n=128):
    db = np.concatenate([make_wafer_like(B // 2, n, seed=3),
                         trending(B - B // 2, n, 4)])
    kw = dict(n_segments=LEVELS, alphabet=10, level_order=order, stack=stack)
    jidx = jfs.build_index(db, jfs.FastSAXConfig(**kw))
    tidx = tfs.build_index(db, tfs.FastSAXConfig(**kw))
    queries = make_queries(db, 4, seed=5)
    return db, jidx, tidx, queries


def eps_at(idx, q, quantile):
    qz = znormalize_np(q)
    d = np.sqrt(np.sum((idx.series - qz) ** 2, axis=-1))
    return float(np.quantile(d, quantile))


def assert_counter(t, j):
    assert t.counter.as_dict() == j.counter.as_dict()
    assert t.counter.total_ops() == j.counter.total_ops()
    assert t.latency == j.latency


def assert_range(t, j):
    np.testing.assert_array_equal(t.answers, j.answers)
    np.testing.assert_array_equal(t.distances, j.distances)
    for f in ("candidates", "excluded_c9", "excluded_c10",
              "levels_visited"):
        assert getattr(t, f) == getattr(j, f), f
    assert_counter(t, j)


def assert_knn(t, j):
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.distances, j.distances)
    for f in ("verified", "excluded_c9", "excluded_c10", "pruned_bsf",
              "levels_visited", "seed_radius"):
        assert getattr(t, f) == getattr(j, f), f
    assert_counter(t, j)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("order", ORDERS)
def test_build_index_equals_reference(stack, order):
    _, jidx, tidx, _ = indexes(stack, order)
    np.testing.assert_array_equal(tidx.series, jidx.series)
    assert tidx.config.levels == jidx.config.levels
    assert tidx.config.extra_stack == jidx.config.extra_stack
    for tl, jl in zip(tidx.levels, jidx.levels, strict=True):
        assert tl.n_segments == jl.n_segments
        np.testing.assert_array_equal(tl.words, jl.words)
        np.testing.assert_array_equal(tl.residuals, jl.residuals)
        assert tl.extra.keys() == jl.extra.keys()
        for name in jl.extra:
            np.testing.assert_array_equal(tl.extra[name], jl.extra[name])
        assert tidx.level_for(tl.n_segments) is tl
    q = indexes(stack, order)[3][0]
    tq_, jq_ = (m.represent_query(q, i.config)
                for m, i in ((tfs, tidx), (jfs, jidx)))
    np.testing.assert_array_equal(tq_.q, jq_.q)
    assert tq_.residuals == jq_.residuals
    for li in range(len(LEVELS)):
        np.testing.assert_array_equal(tq_.words[li], jq_.words[li])
        assert tq_.extra[li].keys() == jq_.extra[li].keys()
        for name in jq_.extra[li]:
            np.testing.assert_array_equal(tq_.extra[li][name],
                                          jq_.extra[li][name])


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("quantile", [0.02, 0.2])
def test_range_engines_equal_reference(stack, order, quantile):
    _, jidx, tidx, queries = indexes(stack, order)
    for q in queries:
        eps = eps_at(tidx, q, quantile)
        for lazy in (True, False):
            assert_range(
                tsearch.fastsax_range_query(tidx, q, eps,
                                            lazy_query_levels=lazy),
                jsearch.fastsax_range_query(jidx, q, eps,
                                            lazy_query_levels=lazy))
        for N in (None, LEVELS[0]):
            assert_range(tsearch.sax_range_query(tidx, q, eps, N),
                         jsearch.sax_range_query(jidx, q, eps, N))
        t = tsearch.linear_scan(tidx, q, eps)
        assert_range(t, jsearch.linear_scan(jidx, q, eps))
        # Every engine returns the brute-force answer set.
        np.testing.assert_array_equal(
            tsearch.fastsax_range_query(tidx, q, eps).answers, t.answers)


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("k", [1, 5])
def test_knn_engines_equal_reference(stack, order, k):
    _, jidx, tidx, queries = indexes(stack, order)
    for q in queries[:3]:
        truth = tsearch.linear_scan_knn(tidx, q, k)
        assert_knn(truth, jsearch.linear_scan_knn(jidx, q, k))
        for N in (None, LEVELS[0]):
            t = tsearch.sax_knn_query(tidx, q, k, N)
            assert_knn(t, jsearch.sax_knn_query(jidx, q, k, N))
            np.testing.assert_array_equal(t.indices, truth.indices)
        for kw in ({}, dict(adaptive_c10=False, seed_factor=3)):
            t = tsearch.fastsax_knn_query(tidx, q, k,
                                          options=SearchOptions(**kw))
            assert_knn(t, jsearch.fastsax_knn_query(
                jidx, q, k, options=JOptions(**kw)))
            np.testing.assert_array_equal(t.indices, truth.indices)


def test_knn_legacy_keywords_and_errors():
    _, jidx, tidx, queries = indexes(TREND, "coarse_first")
    with pytest.warns(DeprecationWarning, match="seed_factor"):
        t = tsearch.fastsax_knn_query(tidx, queries[0], 3, seed_factor=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j = jsearch.fastsax_knn_query(jidx, queries[0], 3, seed_factor=4)
    assert_knn(t, j)
    with pytest.raises(TypeError, match="unexpected keyword"):
        tsearch.fastsax_knn_query(tidx, queries[0], 3, block_b=8)


@pytest.mark.parametrize("data", ["trending", "wafer"])
def test_advise_stack_equals_reference(data):
    rng = np.random.default_rng(4)
    B, n = 512, 128
    if data == "trending":
        t = np.arange(n) / n
        x = znormalize_np(rng.uniform(-6, 6, (B, 1)) * t[None, :]
                          + 0.15 * rng.standard_normal((B, n)))
    else:
        x = make_wafer_like(B, n, seed=6)
    kw = dict(n_segments=LEVELS, alphabet=8, stack=TREND)
    jidx = jfs.build_index(x, jfs.FastSAXConfig(**kw), normalize=False)
    tidx = tfs.build_index(x, tfs.FastSAXConfig(**kw), normalize=False)
    qs = znormalize_np(x[:8] + 0.1 * rng.standard_normal((8, n)))
    d2 = ((qs[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    for quant in (0.02, 0.3):
        eps = float(np.quantile(np.sqrt(d2), quant))
        got = tsearch.advise_stack(tidx, qs, eps)
        assert got == jsearch.advise_stack(jidx, qs, eps)
        assert set(trep.DEFAULT_STACK) <= set(got)
    if data == "trending":
        assert "trend_slope" in tsearch.advise_stack(
            tidx, qs, float(np.quantile(np.sqrt(d2), 0.02)))
    paper = tfs.build_index(x, tfs.FastSAXConfig(n_segments=LEVELS))
    assert tsearch.advise_stack(paper, qs, 1.0) == trep.DEFAULT_STACK


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("stack", STACKS)
def test_quantized_range_engine_equals_reference(mode, stack):
    _, jidx, tidx, queries = indexes(stack, "coarse_first")
    jqh = jq.quantize_host_index(jidx, mode)
    tqh = tq.quantize_host_index(tidx, mode)
    assert tqh.resident_bytes() == jqh.resident_bytes()
    for lv_t, lv_j in zip(tqh.levels, jqh.levels, strict=True):
        assert lv_t.extra.keys() == lv_j.extra.keys()
        for name in lv_j.extra:
            np.testing.assert_array_equal(lv_t.extra[name], lv_j.extra[name])
    for q in queries:
        eps = eps_at(tidx, q, 0.1)
        want = jsearch.quantized_fastsax_range_query(
            jqh, jidx.series, q, eps, config=jidx.config)
        # The reference's tier handed to the port, and the port's own.
        for qh in (jqh, tqh):
            assert_range(tsearch.quantized_fastsax_range_query(
                qh, tidx.series, q, eps, config=tidx.config), want)
        np.testing.assert_array_equal(
            want.answers, tsearch.fastsax_range_query(tidx, q, eps).answers)
    with pytest.raises(ValueError, match="config"):
        tsearch.quantized_fastsax_range_query(tqh, tidx.series, queries[0],
                                              1.0)


# ---------------------------------------------------------------------------
# The registry's conformance, on the port's registrations.
# ---------------------------------------------------------------------------

def test_registrations_equal_reference():
    assert trep.registered_names() == jrep.registered_names()
    assert trep.DEFAULT_STACK == jrep.DEFAULT_STACK
    for name in trep.registered_names():
        t, j = trep.get(name), jrep.get(name)
        assert (t.kind, t.canonical_field, t.residual_rule) == \
            (j.kind, j.canonical_field, j.residual_rule)
        assert t.column.__dict__ == j.column.__dict__
        assert (t.window_symbolize_np is None) == \
            (j.window_symbolize_np is None)
        for n in (64, 128):
            for N in (4, 8, 16):
                for alphabet in (3, 10, 20):
                    assert t.exclude_cost(n, N, alphabet) == \
                        j.exclude_cost(n, N, alphabet)
                    assert t.query_cost(n, N, alphabet) == \
                        j.query_cost(n, N, alphabet)
    assert trep.extra_names(TREND) == jrep.extra_names(TREND) == \
        ("trend_slope",)
    assert [r.name for r in trep.stack_reps(TREND)] == list(TREND)
    with pytest.raises(ValueError, match="gap-kind"):
        trep.validate_stack(("sax_word", "linfit_residual"))
    with pytest.raises(ValueError, match="already registered"):
        trep.register(trep.TrendSlopeRepr())


@pytest.mark.parametrize("seed", range(5))
def test_bounds_are_sound_and_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n, N, alphabet, B, Q = 64, [4, 8, 16][seed % 3], [4, 8, 16][seed % 3], \
        48, 3
    x = znormalize_np(trending(B, n, seed))
    qs = znormalize_np(trending(Q, n, seed + 50))
    d_true = np.sqrt(((qs[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    tab = torch.as_tensor(trep.mindist_table(alphabet), dtype=torch.float32)
    for name in trep.registered_names():
        t, j = trep.get(name), jrep.get(name)
        col = t.symbolize_np(x, N, alphabet)
        np.testing.assert_array_equal(col, j.symbolize_np(x, N, alphabet))
        for qi, q in enumerate(qs):
            qval = t.query_repr_np(q, N, alphabet)
            np.testing.assert_array_equal(qval,
                                          j.query_repr_np(q, N, alphabet))
            lb = t.host_lower_bound(col, qval, n=n, N=N, alphabet=alphabet)
            np.testing.assert_array_equal(
                lb, j.host_lower_bound(col, qval, n=n, N=N,
                                       alphabet=alphabet))
            assert np.all(lb <= d_true[qi] + 1e-9), name
        # The device forms (torch, f32) obey the same inequality.
        dcol = t.symbolize_dev(torch.as_tensor(x, dtype=torch.float32), N,
                               alphabet)
        dq = t.symbolize_dev(torch.as_tensor(qs, dtype=torch.float32), N,
                             alphabet)
        if t.kind == "gap":
            lb = t.dev_gap(dcol, dq).numpy()
        else:
            lb = np.sqrt(t.dev_bound_sq(dcol, dq, n=n, N=N, tab=tab).numpy())
        assert lb.shape == (Q, B)
        assert np.all(lb <= d_true + 1e-3), name


def test_trend_window_symbols_equal_reference():
    rng = np.random.default_rng(21)
    for L in (1, 6):
        ws = jsubseq.WindowStats(
            sum_y=rng.standard_normal((2, 30, 4)),
            sxy=None if L == 1 else rng.standard_normal((2, 30, 4)) * 3,
            L=L, sxx=0.0 if L == 1 else L * (L * L - 1) / 12.0,
            sd=rng.uniform(0.5, 2.0, (2, 30)), alphabet=8)
        np.testing.assert_array_equal(
            trep.get("trend_slope").window_symbolize_np(ws),
            jrep.get("trend_slope").window_symbolize_np(ws))


def test_cost_model_equals_reference():
    for n in (64, 128, 256):
        for N in (4, 8, 16):
            for fn in ("mindist_cost", "paa_cost", "linfit_residual_cost"):
                args = (N,) if fn == "mindist_cost" else (n, N)
                assert getattr(tcm, fn)(*args) == getattr(jcm, fn)(*args)
            for kill in (0.0, 0.01, 0.05, 0.3, 1.0):
                assert tcm.c10_skip_advised(kill, n, N) == \
                    jcm.c10_skip_advised(kill, n, N)
                cost = trep.get("trend_slope").exclude_cost(n, N, 10)
                assert tcm.level_enable_advised(kill, n, cost) == \
                    jcm.level_enable_advised(kill, n, cost)
        assert tcm.euclidean_cost(n) == jcm.euclidean_cost(n)
    for m in (0, 1, 2, 7, 1000):
        assert tcm.sort_cost(m) == jcm.sort_cost(m)
        for k in (1, 5, 32):
            assert tcm.select_cost(m, k) == jcm.select_cost(m, k)
            assert tcm.heap_push_cost(k) == jcm.heap_push_cost(k)
    for a in (3, 10, 20):
        assert tcm.discretize_cost(8, a) == jcm.discretize_cost(8, a)
    assert tcm.c9_cost() == jcm.c9_cost()
    assert tcm.residual_gap_cost() == jcm.residual_gap_cost()
    w = tcm.OpWeights(div=3.0, sqrt=5.5)
    tc, jc = tcm.OpCounter(weights=w), jcm.OpCounter(
        weights=jcm.OpWeights(div=3.0, sqrt=5.5))
    for c in (tc, jc):
        c.count(cmp=5, div=2, sqrt=3, lookup=1)
    assert tc.latency() == jc.latency() and tc.as_dict() == jc.as_dict()
    tc.merge(tc)
    assert tc.total_ops() == 2 * jc.total_ops()
    assert tcm.latency_of({"div": 2, "add": 1}) == \
        jcm.latency_of({"div": 2, "add": 1})


# ---------------------------------------------------------------------------
# The level-at-a-time composition of the kernels' plain versions.
# ---------------------------------------------------------------------------

def band(x):
    return 1e-3 + 1e-5 * np.abs(x)


@pytest.mark.parametrize("eps", [1.0, 2.0])
def test_level_at_a_time_composition_matches_host_engines(eps):
    db = make_wafer_like(2000, 128, seed=0)
    cfg = tfs.FastSAXConfig(n_segments=LEVELS, alphabet=10)
    host = tfs.build_index(db, cfg)
    B, n, A = host.size, host.n, cfg.alphabet
    series = torch.as_tensor(host.series, dtype=torch.float32)
    words = [torch.as_tensor(lv.words, dtype=torch.int32)
             for lv in host.levels]
    resid = [torch.as_tensor(lv.residuals, dtype=torch.float32)
             for lv in host.levels]
    eps2 = tref.eps_sq_f32(eps)
    fine = list(cfg.levels).index(max(LEVELS))
    sax_word = trep.get("sax_word")
    outside = 0
    for q in make_queries(db, 8, seed=1):
        qr = tfs.represent_query(q, cfg)
        qt = torch.as_tensor(qr.q, dtype=torch.float32)
        alive = torch.ones(B, dtype=torch.bool)
        for li in range(len(LEVELS)):
            alive = lo.prune_level(alive, resid[li], words[li], qr.words[li],
                                   qr.residuals[li], eps, n, A)
        f_cand = torch.nonzero(alive).flatten()
        f_ans = f_cand[lo.sqdist(series[f_cand], qt) <= eps2].numpy()
        md2 = lo.mindist_sq(words[fine], qr.words[fine], n, A)
        s_cand = torch.nonzero(md2 <= eps2).flatten()
        s_ans = s_cand[lo.sqdist(series[s_cand], qt) <= eps2].numpy()
        rf = tsearch.fastsax_range_query(host, qr, eps)
        rs = tsearch.sax_range_query(host, qr, eps)
        d2 = np.sum((host.series - qr.q) ** 2, axis=-1)
        near_d2 = np.abs(d2 - eps * eps) <= band(eps * eps)
        for got, want in ((f_ans, rf.answers), (s_ans, rs.answers)):
            outside += int((~near_d2[np.setxor1d(got, want)]).sum())
        # The host cascade's candidate sets, and the rows whose f64 gap or
        # bound lies within the f32 band of its threshold.
        near = np.zeros(B, dtype=bool)
        h_alive = np.ones(B, dtype=bool)
        for li, lv in enumerate(host.levels):
            gap = np.abs(lv.residuals - qr.residuals[li])
            b2 = sax_word.host_bound_sq(lv.words, qr.words[li], n=n,
                                        N=lv.n_segments, alphabet=A)
            near |= (np.abs(gap - eps) <= band(eps)) | (
                np.abs(b2 - eps * eps) <= band(eps * eps))
            h_alive &= (gap <= eps) & (b2 <= eps * eps)
            if li == fine:
                h_sax = b2 <= eps * eps
        assert (int(h_alive.sum()), int(h_sax.sum())) == \
            (rf.candidates, rs.candidates)
        for got, want in ((f_cand.numpy(), np.nonzero(h_alive)[0]),
                          (s_cand.numpy(), np.nonzero(h_sax)[0])):
            outside += int((~near[np.setxor1d(got, want)]).sum())
        assert len(rf.answers) >= 1
    assert outside == 0


# ---------------------------------------------------------------------------
# Device paths refuse an extended stack, naming the ROADMAP item.
# ---------------------------------------------------------------------------

def test_device_paths_refuse_extended_stacks():
    _, _, tidx, queries = indexes(TREND, "coarse_first")
    match = f"item {teng.EXTENDED_STACK_ITEM}"
    assert teng.EXTENDED_STACK_ITEM == 12
    with pytest.raises(NotImplementedError, match=match):
        teng.device_index_from_host(tidx, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        teng.build_device_index(tidx.series, LEVELS, 10, stack=TREND,
                                device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        teng.represent_queries(torch.as_tensor(queries, dtype=torch.float32),
                               LEVELS, 10, stack=TREND)
    with pytest.raises(NotImplementedError, match=match):
        ServeConfig(stack=TREND)
    with pytest.raises(NotImplementedError, match=match):
        teng.quantized_device_index(tq.quantize_host_index(tidx, "int8"),
                                    device="cpu")
    streams = make_wafer_like(2, 300, seed=0, normalize=False)
    with pytest.raises(NotImplementedError, match=match):
        tsubseq.build_subseq_index(
            streams, tfs.FastSAXConfig(n_segments=LEVELS, stack=TREND), 64, 2)
    # The paper stack still builds on the device paths.
    paper = tfs.build_index(tidx.series, tfs.FastSAXConfig(n_segments=LEVELS),
                            normalize=False)
    dev = teng.device_index_from_host(paper, device="cpu")
    assert dev.stack == trep.DEFAULT_STACK
    assert math.isclose(float(dev.residuals[0][0]),
                        paper.levels[0].residuals[0], rel_tol=1e-6)
