"""Extended representation stacks on the port's device engines, against
the reference, on the CPU.

The stack is the registry's ``("linfit_residual", "sax_word",
"trend_slope")`` over trending data (``make_trending``: the regime
``trend_slope`` prunes in), B ≤ 512 series of n = 128 at levels (4, 8)
or (8, 16), alphabet 10.  The reference runs on the CPU (its XLA
engine: it demotes Pallas for an extended stack).  The port keeps its
fused kernels answering on the ``cuda`` backend (here their plain
versions, on CPU tensors) with the paper pair's cascade and an exact
verify; the torch engine applies the extras, as the reference's does.

Tolerances, stated where they apply:

  * **symbols**: a device word or trend word may differ from the other
    side's only where its f64 value lies within ``SYMBOL_BAND`` of a
    breakpoint (two f32 summation orders round the segment sum apart);
    such cases are counted, none may fall outside the band;
  * **masks and counters** are compared on one representation, carried
    across as numpy arrays, and must be equal exactly;
  * **d²** within ``1e-3 + 1e-5·d²`` (the engine tests' band); answer
    sets equal except rows whose d² lies in that band around ε² (or the
    k-th distance), which the grid must not have.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import subseq as jss
from repro.core.fastsax import FastSAXConfig as JConfig
from repro.core.fastsax import build_index as jbuild
from repro.index import quantized as jquant
from repro.index import store as jstore
from repro_torch.core import engine as teng
from repro_torch.core import representation as trep
from repro_torch.core import search as tsearch
from repro_torch.core import subseq as tss
from repro_torch.core.fastsax import FastSAXConfig, build_index, represent_query
from repro_torch.core.options import SearchOptions
from repro_torch.core.paa import paa_np
from repro_torch.core.representation import _trend_scaled_slope_np
from repro_torch.core.sax import breakpoints
from repro_torch.data.timeseries import make_queries, make_trending
from repro_torch.index.quantized import quantize_host_index
from repro_torch.kernels import fused_query as tfused
from repro_torch.obs import trace as ttrace
from repro_torch.serve import (OK, SearchService, ServeConfig,
                               SubseqSearchService, WorkloadSpec,
                               check_exactness, make_workload,
                               run_closed_loop)

EXT = ("linfit_residual", "sax_word", "trend_slope")
PAPER = trep.DEFAULT_STACK
B, N, LEVELS, ALPHA = 512, 128, (8, 16), 10
EPS_GRID = [0.5, 1.0, 2.0]
# A symbol may flip only where its f64 value lies this close to a
# breakpoint: f32 segment sums of ~L values of size ~1 round within
# ~1e-6·L of each other, far inside it.
SYMBOL_BAND = 1e-4


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def near_breakpoint(values: np.ndarray) -> np.ndarray:
    """True where an f64 value lies within SYMBOL_BAND of a breakpoint."""
    bp = breakpoints(ALPHA)
    return np.min(np.abs(values[..., None] - bp), axis=-1) <= SYMBOL_BAND


def assert_symbols(got, want, f64_values) -> int:
    """Symbols equal except near a breakpoint; returns the band count."""
    got, want = host(got), host(want)
    differ = got != want
    near = near_breakpoint(np.asarray(f64_values, np.float64))
    assert int((differ & ~near).sum()) == 0
    return int(differ.sum())


def trend_f64(x, Nseg):
    return _trend_scaled_slope_np(np.asarray(x, np.float64), Nseg)


def paa_f64(x, Nseg):
    return paa_np(np.asarray(x, np.float64), Nseg)


@pytest.fixture(scope="module")
def db():
    return make_trending(B, N, seed=5)


@pytest.fixture(scope="module")
def qs(db):
    return np.asarray(make_queries(db, 8, seed=6), np.float32)


@pytest.fixture(scope="module")
def hosts(db):
    """The port's and the reference's host builds of both stacks."""
    out = {}
    for name, stack in (("ext", EXT), ("paper", PAPER)):
        out[name] = (
            build_index(db, FastSAXConfig(n_segments=LEVELS, alphabet=ALPHA,
                                          stack=stack), normalize=False),
            jbuild(db, JConfig(n_segments=LEVELS, alphabet=ALPHA,
                               stack=stack), normalize=False))
    return out


def shared_qr(jqr) -> teng.QueryReprDev:
    """The reference's query representation carried across as arrays."""
    t = lambda a: torch.as_tensor(np.array(a))
    return teng.QueryReprDev(
        q=t(jqr.q), words=tuple(t(w) for w in jqr.words),
        residuals=tuple(t(r) for r in jqr.residuals),
        extra=tuple({k: t(v) for k, v in lv.items()} for lv in jqr.extra))


@pytest.fixture(scope="module")
def engines(hosts, qs):
    """Per stack: (port index, reference index, port queries carrying the
    reference's representation, reference queries)."""
    out = {}
    for name, stack in (("ext", EXT), ("paper", PAPER)):
        thost, jhost = hosts[name]
        jqr = jeng.represent_queries(jnp.asarray(qs), LEVELS, ALPHA,
                                     normalize=False, stack=stack)
        out[name] = (teng.device_index_from_host(thost, device="cpu"),
                     jeng.device_index_from_host(jhost), shared_qr(jqr), jqr)
    return out


# ---------------------------------------------------------------------------
# Columns and representation.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [(4, 8), (8, 16)])
def test_dev_extra_levels_match_reference(db, levels):
    x = np.asarray(db[:256], np.float32)
    got = teng._dev_extra_levels(torch.as_tensor(x), levels, ALPHA, EXT)
    want = jeng._dev_extra_levels(jnp.asarray(x), levels, ALPHA, EXT)
    assert len(got) == len(want) == len(levels)
    for li, Nseg in enumerate(levels):
        assert set(got[li]) == {"trend_slope"}
        assert got[li]["trend_slope"].dtype == torch.int32
        assert_symbols(got[li]["trend_slope"], want[li]["trend_slope"],
                       trend_f64(x, Nseg))
    assert teng._dev_extra_levels(torch.as_tensor(x), levels, ALPHA,
                                  PAPER) == ()


@pytest.mark.parametrize("levels", [(4, 8), (8, 16)])
def test_build_device_index_matches_reference(db, levels):
    got = teng.build_device_index(db, levels, ALPHA, stack=EXT,
                                  device="cpu")
    want = jeng.build_device_index(jnp.asarray(db, jnp.float32), levels,
                                   ALPHA, stack=EXT)
    assert got.stack == EXT and got.device.type == "cpu"
    np.testing.assert_allclose(host(got.series), np.asarray(want.series),
                               rtol=1e-5, atol=1e-5)
    z = host(got.series)
    for li, Nseg in enumerate(levels):
        assert_symbols(got.words[li], want.words[li], paa_f64(z, Nseg))
        assert_symbols(got.extra[li]["trend_slope"],
                       want.extra[li]["trend_slope"], trend_f64(z, Nseg))
        np.testing.assert_allclose(host(got.residuals[li]),
                                   np.asarray(want.residuals[li]),
                                   rtol=1e-4, atol=1e-4)


def test_upload_and_represent_match_reference(hosts, engines, db, qs):
    thost, jhost = hosts["ext"]
    tdev, jdev, _, jqr = engines["ext"]
    # The host builds are the same numpy code: the uploads are equal.
    for li in range(len(LEVELS)):
        np.testing.assert_array_equal(host(tdev.words[li]),
                                      np.asarray(jdev.words[li]))
        np.testing.assert_array_equal(host(tdev.extra[li]["trend_slope"]),
                                      np.asarray(
                                          jdev.extra[li]["trend_slope"]))
        np.testing.assert_array_equal(host(tdev.residuals[li]),
                                      np.asarray(jdev.residuals[li]))
    # The device build agrees with the f64 host build up to the band.
    dbuilt = teng.build_device_index(db, LEVELS, ALPHA, normalize=False,
                                     stack=EXT, device="cpu")
    for li, Nseg in enumerate(LEVELS):
        assert_symbols(dbuilt.extra[li]["trend_slope"],
                       thost.levels[li].extra["trend_slope"],
                       trend_f64(db, Nseg))
    tqr = teng.represent_queries(torch.as_tensor(qs), LEVELS, ALPHA,
                                 normalize=False, stack=EXT)
    for li, Nseg in enumerate(LEVELS):
        assert_symbols(tqr.words[li], jqr.words[li], paa_f64(qs, Nseg))
        assert_symbols(tqr.extra[li]["trend_slope"],
                       jqr.extra[li]["trend_slope"], trend_f64(qs, Nseg))
    paper = teng.represent_queries(torch.as_tensor(qs), LEVELS, ALPHA,
                                   normalize=False)
    assert paper.extra == ()


# ---------------------------------------------------------------------------
# The cascade, the answers and the backends.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", EPS_GRID)
def test_cascade_mask_matches_reference_and_prunes_more(engines, eps):
    tdev, jdev, tqr, jqr = engines["ext"]
    got = host(teng.cascade_mask(tdev, tqr, eps))
    np.testing.assert_array_equal(
        got, np.asarray(jeng.cascade_mask(jdev, jqr, np.float32(eps))))
    pdev, _, pqr, _ = engines["paper"]
    paper = host(teng.cascade_mask(pdev, pqr, eps))
    assert not (got & ~paper).any()
    if eps <= 1.0:
        assert got.sum() < paper.sum()       # trend_slope kills rows here


def assert_range(got_a, got_d, want_a, want_d, eps):
    got_a, got_d, want_a, want_d = map(host, (got_a, got_d, want_a, want_d))
    differ = got_a != want_a
    assert int(differ.sum()) == 0, "range answers differ"
    both = got_a & want_a
    assert np.all(np.abs(got_d[both] - want_d[both]) <= band(want_d[both]))


def answer_sets(idx, ans):
    idx, ans = host(idx), host(ans)
    return [sorted(idx[i][ans[i]].tolist()) for i in range(idx.shape[0])]


@pytest.mark.parametrize("eps", EPS_GRID)
def test_range_matches_reference_and_paper_stack(engines, eps):
    tdev, jdev, tqr, jqr = engines["ext"]
    pdev, _, pqr, _ = engines["paper"]
    got = teng.range_query(tdev, tqr, eps)
    assert_range(*got, *jeng.range_query(jdev, jqr, np.float32(eps)), eps)
    assert_range(*got, *teng.range_query(pdev, pqr, eps), eps)
    # On the CPU "auto" is the torch engine; "cuda" is kernel 1 (its
    # plain version here) over the paper pair's cascade: the same
    # answers, d² within the band.
    for be in ("auto", "torch"):
        out = teng.range_query_backend(tdev, tqr, eps,
                                       options=SearchOptions(backend=be))
        for a, b in zip(out, got):
            assert torch.equal(a, b)
    out = teng.range_query_backend(tdev, tqr, eps,
                                   options=SearchOptions(backend="cuda"))
    assert_range(*out, *got, eps)


@pytest.mark.parametrize("k", [1, 5])
def test_knn_matches_reference_and_paper_stack(engines, k):
    tdev, jdev, tqr, jqr = engines["ext"]
    pdev, _, pqr, _ = engines["paper"]
    gi, gd, ge = teng.knn_query_auto(tdev, tqr, k)
    wi, wd, we = jeng.knn_query_auto(jdev, jqr, k)
    np.testing.assert_array_equal(host(gi), np.asarray(wi))
    np.testing.assert_array_equal(host(ge), np.asarray(we))
    assert np.all(np.abs(host(gd) - np.asarray(wd)) <= band(np.asarray(wd)))
    pi, _, _ = teng.knn_query_auto(pdev, pqr, k)
    np.testing.assert_array_equal(host(gi), host(pi))
    fi, fd, fe = teng.knn_query_backend(tdev, tqr, k,
                                        options=SearchOptions(backend="cuda"))
    np.testing.assert_array_equal(host(fi), host(gi))
    assert bool(host(fe).all())
    assert np.all(np.abs(host(fd) - host(gd)) <= band(host(gd)))


def test_mixed_matches_reference_and_paper_stack(engines):
    tdev, jdev, tqr, jqr = engines["ext"]
    pdev, _, pqr, _ = engines["paper"]
    Q, k = tqr.q.shape[0], 3
    eps = np.linspace(0.5, 2.0, Q).astype(np.float32)
    is_knn = np.array([i % 2 == 0 for i in range(Q)])
    got = teng.mixed_query_auto(tdev, tqr, torch.as_tensor(eps),
                                torch.as_tensor(is_knn), k)
    want = jeng.mixed_query_auto(jdev, jqr, jnp.asarray(eps),
                                 jnp.asarray(is_knn), k)
    paper = teng.mixed_query_auto(pdev, pqr, torch.as_tensor(eps),
                                  torch.as_tensor(is_knn), k)
    assert answer_sets(got[0], got[1]) == answer_sets(want[0], want[1])
    for qi in np.nonzero(~is_knn)[0]:
        assert answer_sets(got[0], got[1])[qi] == \
            answer_sets(paper[0], paper[1])[qi]
    gt = teng.mixed_topk(got[0], got[2], k)[0]
    pt = teng.mixed_topk(paper[0], paper[2], k)[0]
    np.testing.assert_array_equal(host(gt)[is_knn], host(pt)[is_knn])
    out = teng.mixed_query_backend(tdev, tqr, torch.as_tensor(eps),
                                   torch.as_tensor(is_knn), k,
                                   options=SearchOptions(backend="cuda"))
    fsets, gsets = answer_sets(out[0], out[1]), answer_sets(got[0], got[1])
    for qi in np.nonzero(~is_knn)[0]:
        assert fsets[qi] == gsets[qi]
    ft = teng.mixed_topk(out[0], out[2], k)[0]
    np.testing.assert_array_equal(host(ft)[is_knn], host(gt)[is_knn])


def test_extended_stack_keeps_the_kernels_on_every_path(engines, hosts,
                                                        monkeypatch):
    """The ``cuda`` backend reaches its kernel on every path of an
    extended stack (here the wrappers' plain versions, counted), and the
    ``torch`` backend none; the traced twins count the extras either
    way."""
    tdev, _, tqr, _ = engines["ext"]
    tier = teng.TieredIndex.from_host(hosts["ext"][0], "int8", device="cpu")
    assert tier.dev.stack == EXT
    calls = {}

    def counted(name):
        real = getattr(tfused, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)
        return wrapper

    for name in ("fused_range", "fused_topk", "fused_quant_range"):
        monkeypatch.setattr(tfused, name, counted(name))
    knn = torch.as_tensor([i % 2 == 0 for i in range(8)])
    traces = {}
    for be in ("torch", "cuda"):
        calls.clear()
        opts = SearchOptions(backend=be)
        teng.range_query_backend(tdev, tqr, 1.0, options=opts)
        teng.knn_query_backend(tdev, tqr, 3, options=opts)
        teng.mixed_query_backend(tdev, tqr, 1.0, knn, 3, options=opts)
        _, _, traces[be] = teng.range_query_traced(tdev, tqr, 1.0, backend=be)
        teng.quantized_range_query(tier, tqr, 1.0, options=opts)
        if be == "torch":
            assert not calls
        else:
            assert calls["fused_range"] >= 3 and calls["fused_topk"] >= 2
            assert calls["fused_quant_range"] == 1
    assert_traces_equal(traces["cuda"], traces["torch"])
    plain = teng.cascade_trace(tdev, tqr, 1.0)     # its answers are 0
    assert_traces_equal(traces["cuda"], dataclasses.replace(
        plain, answers=traces["cuda"].answers))


@pytest.mark.parametrize("eps", EPS_GRID)
def test_kernel5_screen_applies_the_extras_to_its_kept_rows(hosts, engines,
                                                           eps):
    """The ``cuda`` tier screen (kernel 5, then the extras on its kept
    rows) keeps exactly the rows of the dense plain screen, a subset of
    kernel 5's alone; over a keep mask of every row, the extras' pass
    equals their dense mask."""
    _, _, tqr, _ = engines["ext"]
    tier = teng.TieredIndex.from_host(hosts["ext"][0], "int8", device="cpu")
    keep, d2 = teng._kernel5_screen(tier.dev, tqr, eps)
    want, wd2 = teng.quantized_screen(tier.dev, tqr, eps)
    np.testing.assert_array_equal(host(keep), host(want))
    fin = host(keep)
    np.testing.assert_array_equal(np.isfinite(host(d2)), fin)
    assert np.all(np.abs(host(d2)[fin] - host(wd2)[fin])
                  <= band(host(wd2)[fin]))
    alone, _ = tfused.fused_quant_range(
        tier.dev, tqr.q, tqr.words, tqr.residuals,
        torch.full((tqr.q.shape[0],), eps), block_q=16, block_b=128)
    assert not (host(keep) & ~host(alone)).any()
    every = torch.ones_like(keep)
    kept, _ = teng._screen_kept_extras(tier.dev, tqr, eps, every,
                                       torch.zeros(keep.shape))
    dense = teng._quant_extras_ok(tier.dev, tqr, torch.full((8, 1), eps))
    np.testing.assert_array_equal(host(kept), host(dense))
    if eps <= 1.0:
        assert not host(kept).all()           # trend_slope kills rows here


# ---------------------------------------------------------------------------
# The quantized tier.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_extra_and_mask_match_reference(hosts, engines, mode):
    thost, jhost = hosts["ext"]
    _, _, tqr, jqr = engines["ext"]
    tq = teng.quantized_device_index(quantize_host_index(thost, mode),
                                     device="cpu")
    jq = jeng.quantized_device_index(jquant.quantize_host_index(jhost, mode))
    assert tq.stack == EXT
    for li in range(len(LEVELS)):
        col = tq.extra[li]["trend_slope"]
        assert col.dtype == torch.int8
        np.testing.assert_array_equal(
            host(col), np.asarray(jq.extra[li]["trend_slope"]))
    for eps in EPS_GRID:
        got = host(teng.quantized_cascade_mask(tq, tqr, eps))
        np.testing.assert_array_equal(got, np.asarray(
            jeng.quantized_cascade_mask(jq, jqr, np.float32(eps))))
        keep, d2 = teng.quantized_screen(tq, tqr, eps)
        jkeep, jd2 = jeng.quantized_screen(jq, jqr, np.float32(eps))
        np.testing.assert_array_equal(host(keep), np.asarray(jkeep))
        fin = np.isfinite(np.asarray(jd2))
        np.testing.assert_array_equal(np.isfinite(host(d2)), fin)
        assert np.all(np.abs(host(d2)[fin] - np.asarray(jd2)[fin])
                      <= band(np.asarray(jd2)[fin]))
        # The extras only prune: the paper tier's keep is a superset.
        ptq = teng.quantized_device_index(
            quantize_host_index(hosts["paper"][0], mode), device="cpu")
        pkeep, _ = teng.quantized_screen(ptq, engines["paper"][2], eps)
        assert not (host(keep) & ~host(pkeep)).any()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_answers_equal_full_precision(hosts, engines, mode):
    tdev, _, tqr, _ = engines["ext"]
    tier = teng.TieredIndex.from_host(hosts["ext"][0], mode, device="cpu")
    for eps in EPS_GRID:
        idx, ans, _, exact = teng.quantized_range_query(tier, tqr, eps)
        full, _ = teng.range_query(tdev, tqr, eps)
        assert bool(host(exact).all())
        assert answer_sets(idx, ans) == [
            np.nonzero(r)[0].tolist() for r in host(full)]
    gi, _, ge = teng.quantized_knn_query(tier, tqr, 5)
    wi, _, _ = teng.knn_query_auto(tdev, tqr, 5)
    assert bool(host(ge).all())
    np.testing.assert_array_equal(host(gi), host(wi))


# ---------------------------------------------------------------------------
# The traced twins.
# ---------------------------------------------------------------------------

FIELDS = ("after_c9", "after_c10", "screen_survivors", "verified", "answers")


def assert_traces_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      host(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("eps", EPS_GRID)
def test_cascade_trace_matches_reference_and_host(hosts, engines, qs, eps,
                                                  monkeypatch):
    tdev, jdev, tqr, jqr = engines["ext"]
    tr = teng.cascade_trace(tdev, tqr, eps)
    assert_traces_equal(tr, jeng.cascade_trace(jdev, jqr, np.float32(eps)))
    # Chunked counting equals counting the whole index at once.
    monkeypatch.setattr(teng, "_COUNT_CHUNK_BYTES", 4096)
    assert_traces_equal(teng.cascade_trace(tdev, tqr, eps), tr)
    monkeypatch.undo()
    # trend_slope's kills land under after_c10: fewer than the paper's.
    pdev, _, pqr, _ = engines["paper"]
    ptr = teng.cascade_trace(pdev, pqr, eps)
    np.testing.assert_array_equal(host(tr.after_c9)[:, 0],
                                  host(ptr.after_c9)[:, 0])
    assert (host(tr.after_c10) <= host(ptr.after_c10)).all()
    # The op-counted host engine over the same stack counts the same.
    thost = hosts["ext"][0]
    cfg = thost.config
    for qi in range(qs.shape[0]):
        r = tsearch.fastsax_range_query(
            thost, represent_query(qs[qi], cfg, normalize=False), eps)
        assert int(ttrace.excluded_c9(tr, B).sum(-1)[qi]) == r.excluded_c9
        assert int(ttrace.excluded_c10(tr).sum(-1)[qi]) == r.excluded_c10
        assert int(tr.candidates[qi]) == r.candidates


def test_traced_twins_match_reference(engines):
    tdev, jdev, tqr, jqr = engines["ext"]
    ans, d2, tr = teng.range_query_traced(tdev, tqr, 1.0)
    jans, _, jtr = jeng.range_query_traced(jdev, jqr, np.float32(1.0))
    assert_traces_equal(tr, jtr)
    np.testing.assert_array_equal(host(ans), np.asarray(jans))
    *_, ktr = teng.knn_query_traced(tdev, tqr, 5)
    *_, jktr = jeng.knn_query_traced(jdev, jqr, 5)
    assert_traces_equal(ktr, jktr)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_trace_matches_reference(hosts, engines, mode):
    thost, jhost = hosts["ext"]
    _, _, tqr, jqr = engines["ext"]
    ttier = teng.TieredIndex.from_host(thost, mode, device="cpu")
    jtier = jeng.TieredIndex.from_host(jhost, mode)
    for eps in EPS_GRID:
        tr = teng.quantized_cascade_trace(ttier.dev, tqr, eps)
        jtr = jeng.quantized_cascade_trace(jtier.dev, jqr, np.float32(eps))
        assert_traces_equal(tr, jtr)
        *_, rtr = teng.quantized_range_query_traced(ttier, tqr, eps)
        keep, _ = teng.quantized_screen(ttier.dev, tqr, eps)
        np.testing.assert_array_equal(host(rtr.screen_survivors),
                                      host(keep.sum(-1)))


# ---------------------------------------------------------------------------
# Subsequence search.
# ---------------------------------------------------------------------------

WINDOW, STRIDE = 64, 3


@pytest.fixture(scope="module")
def streams():
    rng = np.random.default_rng(17)
    base = np.cumsum(rng.standard_normal((3, 700)), axis=-1)
    return base + 0.3 * rng.standard_normal(base.shape)


@pytest.mark.parametrize("levels", [(4, 8), (8, 16)])
def test_window_hook_matches_direct_symbolisation(streams, levels):
    cfg = FastSAXConfig(n_segments=levels, alphabet=ALPHA, stack=EXT)
    hidx = tss.build_subseq_index(streams, cfg, WINDOW, STRIDE)
    jhidx = jss.build_subseq_index(
        streams, JConfig(n_segments=levels, alphabet=ALPHA, stack=EXT),
        WINDOW, STRIDE)
    win = tss.materialize_windows_np(hidx)
    rep = trep.get("trend_slope")
    for li, lv in enumerate(hidx.levels):
        Nseg = lv.n_segments
        col = lv.extra["trend_slope"]
        assert col.shape == (hidx.n_windows, Nseg)
        np.testing.assert_array_equal(col,
                                      jhidx.levels[li].extra["trend_slope"])
        assert_symbols(col, rep.symbolize_np(win, Nseg, ALPHA),
                       trend_f64(win, Nseg))


def test_hookless_extra_is_refused(streams, monkeypatch):
    monkeypatch.setattr(trep.get("trend_slope"), "window_symbolize_np",
                        None)
    with pytest.raises(NotImplementedError, match="window_symbolize_np"):
        tss.build_subseq_index(streams, FastSAXConfig(
            n_segments=LEVELS, alphabet=ALPHA, stack=EXT), WINDOW, STRIDE)


@pytest.fixture(scope="module")
def subseq(streams):
    out = {}
    for name, stack in (("ext", EXT), ("paper", PAPER)):
        hidx = tss.build_subseq_index(streams, FastSAXConfig(
            n_segments=LEVELS, alphabet=ALPHA, stack=stack), WINDOW, STRIDE)
        out[name] = (hidx, tss.subseq_device_index(hidx, "cpu"))
    rng = np.random.default_rng(3)
    q = np.stack([streams[i, a:a + WINDOW] for i, a in
                  ((0, 30), (1, 301), (2, 555))])
    return out, q + 0.05 * rng.standard_normal(q.shape)


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_subseq_extended_matches_paper_and_reference(subseq, streams,
                                                     backend):
    out, q = subseq
    hidx, sidx = out["ext"]
    _, psidx = out["paper"]
    assert sidx.index.stack == EXT and sidx.index.extra
    opts = SearchOptions(backend=backend)
    qr = tss.represent_subseq_queries(sidx, q)
    assert set(qr.extra[0]) == {"trend_slope"}
    pqr = tss.represent_subseq_queries(psidx, q)
    jsidx = jss.subseq_device_index(jss.build_subseq_index(
        streams, JConfig(n_segments=LEVELS, alphabet=ALPHA, stack=EXT),
        WINDOW, STRIDE))
    jqr = jss.represent_subseq_queries(jsidx, q)
    for eps in (1.0, 3.0):
        ans, _ = tss.subseq_range_query(sidx, qr, eps, options=opts)
        pans, _ = tss.subseq_range_query(psidx, pqr, eps,
                                         options=SearchOptions(
                                             backend="torch"))
        jans, _ = jss.subseq_range_query(jsidx, jqr, np.float32(eps))
        np.testing.assert_array_equal(host(ans), host(pans))
        np.testing.assert_array_equal(host(ans), np.asarray(jans))
    got = tss.subseq_knn_query(sidx, qr, 3, options=opts)
    want = tss.subseq_knn_query(psidx, pqr, 3,
                                options=SearchOptions(backend="torch"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2].all()
    # Traced: the counters over the windows-as-rows index.
    _, _, tr = tss.subseq_range_query_traced(sidx, qr, 3.0, options=opts)
    _, _, jtr = jss.subseq_range_query_traced(jsidx, jqr, np.float32(3.0))
    assert_traces_equal(tr, jtr)


def test_subseq_store_round_trip_and_service(subseq, tmp_path):
    out, q = subseq
    hidx, sidx = out["ext"]
    path = tmp_path / "sub"
    tss.save_subseq_index(hidx, path)
    back = tss.load_subseq_index(path)
    assert back.config.stack == EXT
    for lv, lw in zip(back.levels, hidx.levels):
        np.testing.assert_array_equal(lv.extra["trend_slope"],
                                      lw.extra["trend_slope"])
    bsidx = tss.subseq_device_index(back, "cpu")
    qr = tss.represent_subseq_queries(bsidx, q)
    a, _ = tss.subseq_range_query(bsidx, qr, 2.0)
    b, _ = tss.subseq_range_query(sidx, tss.represent_subseq_queries(sidx, q),
                                  2.0)
    assert torch.equal(a, b)
    svc = SubseqSearchService.from_store(path, ServeConfig(levels=LEVELS),
                                         device="cpu")
    assert svc.backend.backend == "torch"
    with svc:
        ids, _ = svc.subseq_knn(q[0], 2)
    want, _ = svc.direct_subseq_knn(q[0], 2)
    np.testing.assert_array_equal(ids, want)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

def test_serve_config_validates_the_stack():
    assert ServeConfig(stack=EXT).stack == EXT
    with pytest.raises(ValueError, match="backbone"):
        ServeConfig(stack=("sax_word", "trend_slope"))
    with pytest.raises(KeyError, match="unregistered"):
        ServeConfig(stack=PAPER + ("no_such_rep",))


def serve(svc, workload):
    with svc:
        result = run_closed_loop(svc, workload, clients=4)
    assert all(r.status == OK for r in result.requests)
    return result


@pytest.mark.parametrize("backend", ["auto", "cuda"])
@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_service_from_reference_store(hosts, db, qs, tmp_path, quantization,
                                      backend):
    """On the CPU "auto" serves on the torch engine; "cuda" on the kernels'
    plain versions, as a CUDA index serves on the kernels."""
    path = tmp_path / "ext"
    jstore.save_index(hosts["ext"][1], path)
    cfg = ServeConfig(quantization=quantization, trace=True, backend=backend)
    svc = SearchService.from_store(path, cfg, device="cpu")
    assert svc.backend.backend == ("torch" if backend == "auto" else "cuda")
    dev_index = (svc.backend.index if quantization == "none"
                 else svc.backend.tindex.dev)
    assert dev_index.stack == EXT and dev_index.extra
    workload = make_workload(qs, WorkloadSpec(n_requests=24, knn_frac=0.5,
                                              k=3, epsilon=1.0))
    result = serve(svc, workload)
    assert check_exactness(svc, workload, result) == 0
    paper = SearchService.from_series(
        db, ServeConfig(quantization=quantization, trace=True),
        normalize=False, device="cpu")
    presult = serve(paper, workload)
    for (kind, *_), a, b in zip(workload, result.requests,
                                presult.requests):
        assert sorted(a.ids.tolist()) == sorted(b.ids.tolist()), kind
    # The extras' kills show in the served cascade counters.
    got, want = svc.stats.snapshot()["cascade"], \
        paper.stats.snapshot()["cascade"]
    assert got["queries"] == want["queries"] > 0
    assert got["after_c9"] <= want["after_c9"]
    assert got["after_c10"] < want["after_c10"]
    assert "repro_cascade" in svc.metrics_text()


def test_device_and_tiered_from_store(hosts, engines, tmp_path):
    path = tmp_path / "ext"
    jstore.save_index(hosts["ext"][1], path)
    tdev, _, tqr, _ = engines["ext"]
    dev = teng.DeviceIndex.from_store(path, device="cpu")
    assert dev.stack == EXT
    for li in range(len(LEVELS)):
        assert torch.equal(dev.extra[li]["trend_slope"],
                           tdev.extra[li]["trend_slope"])
    assert torch.equal(teng.range_query(dev, tqr, 1.0)[0],
                       teng.range_query(tdev, tqr, 1.0)[0])
    tier = teng.TieredIndex.from_store(path, device="cpu")
    assert tier.dev.stack == EXT and tier.dev.extra
    idx, ans, _, _ = teng.quantized_range_query(tier, tqr, 1.0)
    assert answer_sets(idx, ans) == [
        np.nonzero(r)[0].tolist()
        for r in host(teng.range_query(tdev, tqr, 1.0)[0])]
