"""The port's observability layer against the reference's, on the CPU.

The same numpy inputs (B = 256 series of n = 128, levels (8, 16),
alphabet 10, ε ∈ {0.5, 1, 2, 3}) go through ``repro``'s traced twins and
``repro_torch``'s (on ``device="cpu"``, where the fused engine runs the
kernels' plain versions):

  * **counters are exact**: every ``QueryTrace`` field equals the
    reference's, and the C9 / C10 / candidate counts equal the port's
    op-counted host engine (``core/search.py``);
  * **answers**: a traced call's answers are the untraced call's, bit for
    bit; d² agrees with the reference's within the engine tests' band
    1e-3 + 1e-5·d²;
  * **the k-th smallest**: ``engine._kth_smallest`` equals the
    reference's sort-free ``_kth_smallest_rounds`` on its adversarial
    grid;
  * **tracing off**: the counting pass is never called and the service
    keeps no observability state;
  * **exports**: span JSONL / Chrome trace and the metrics text are the
    reference's for the same inputs; a calibration record's bound is the
    H100 arithmetic;
  * **surfaces**: a traced service replays exactly and fills the cascade,
    span and calibration surfaces; the request log has the reference's
    keys; the launcher writes every file its flags ask for.
"""
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core import engine as jeng
from repro.core import subseq as jss
from repro.core.fastsax import FastSAXConfig as JConfig
from repro.core.fastsax import build_index as jbuild
from repro.data.timeseries import make_queries, make_wafer_like
from repro.obs import calibration as jcal
from repro.obs import metrics as jmetrics
from repro.obs import spans as jspans
from repro.obs import trace as jtrace
from repro_torch.core import engine as teng
from repro_torch.core import search as tsearch
from repro_torch.core import subseq as tss
from repro_torch.core.fastsax import FastSAXConfig, build_index, represent_query
from repro_torch.core.options import SearchOptions
from repro_torch.index.quantized import quantize_host_index
from repro_torch.obs import calibration as tcal
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import spans as tspans
from repro_torch.obs import trace as ttrace
from repro_torch.serve import (OK, SearchService, ServeConfig, WorkloadSpec,
                               check_exactness, make_workload, run_saturated)
from repro_torch.serve.stats import StatsTracker

B, N, LEVELS, ALPHA = 256, 128, (8, 16), 10
EPS_GRID = [0.5, 1.0, 2.0, 3.0]
FIELDS = ("after_c9", "after_c10", "screen_survivors", "verified", "answers")


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_traces_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      host(getattr(want, f)), err_msg=f)


def assert_same_outputs(got, want):
    """Traced against untraced outputs: bit for bit."""
    for a, b in zip(got, want):
        a, b = host(a), host(b)
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


@pytest.fixture(scope="module")
def db():
    return make_wafer_like(B, N, seed=3, normalize=False)


@pytest.fixture(scope="module")
def cfg():
    return FastSAXConfig(n_segments=LEVELS, alphabet=ALPHA)


@pytest.fixture(scope="module")
def thost(db, cfg):
    return build_index(db, cfg, normalize=False)


@pytest.fixture(scope="module")
def tdidx(thost):
    return teng.device_index_from_host(thost, device="cpu")


@pytest.fixture(scope="module")
def jdidx(db):
    return jeng.device_index_from_host(
        jbuild(db, JConfig(n_segments=LEVELS, alphabet=ALPHA),
               normalize=False))


@pytest.fixture(scope="module")
def queries(db):
    qs = np.asarray(make_queries(db, 8, seed=4), np.float32)
    tqr = teng.represent_queries(torch.as_tensor(qs), LEVELS, ALPHA,
                                 normalize=False)
    jqr = jeng.represent_queries(jnp.asarray(qs), LEVELS, ALPHA,
                                 normalize=False)
    return qs, tqr, jqr


def host_counts(thost, cfg, q, eps):
    """The port's op-counted host engine at radius ``eps``."""
    r = tsearch.fastsax_range_query(
        thost, represent_query(q, cfg, normalize=False), eps)
    return r.excluded_c9, r.excluded_c10, r.candidates, len(r.answers)


def trace_counts(tr, qi):
    return (int(ttrace.excluded_c9(tr, B).sum(axis=-1)[qi]),
            int(ttrace.excluded_c10(tr).sum(axis=-1)[qi]),
            int(tr.candidates[qi]))


# ---------------------------------------------------------------------------
# Counters: equal to the reference's and to the host engine's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("eps", EPS_GRID)
def test_range_trace_equals_reference_and_host(thost, cfg, tdidx, jdidx,
                                               queries, eps, backend):
    qs, tqr, jqr = queries
    ans, d2, tr = teng.range_query_traced(tdidx, tqr, eps, backend=backend)
    jans, jd2, jtr = jeng.range_query_traced(jdidx, jqr, np.float32(eps))
    assert_traces_equal(tr, jtr)
    untraced = (teng.range_query_fused(tdidx, tqr, eps) if backend == "cuda"
                else teng.range_query(tdidx, tqr, eps))
    assert_same_outputs((ans, d2), untraced)
    np.testing.assert_array_equal(host(ans), np.asarray(jans))
    fin = np.isfinite(np.asarray(jd2))
    assert np.all(np.abs(host(d2)[fin] - np.asarray(jd2)[fin])
                  <= band(np.asarray(jd2)[fin]))
    for qi in range(qs.shape[0]):
        want = host_counts(thost, cfg, qs[qi], eps)
        assert trace_counts(tr, qi) + (int(host(tr.answers)[qi]),) == want


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_knn_trace_equals_reference_and_host_at_final_radius(
        thost, cfg, tdidx, jdidx, queries, backend):
    qs, tqr, jqr = queries
    k = 5
    nn_idx, nn_d2, exact, tr = teng.knn_query_traced(tdidx, tqr, k,
                                                     backend=backend)
    j_idx, j_d2, j_exact, jtr = jeng.knn_query_traced(jdidx, jqr, k)
    assert bool(host(exact).all()) and bool(np.asarray(j_exact).all())
    assert_traces_equal(tr, jtr)
    untraced = (teng.knn_query_fused(tdidx, tqr, k) if backend == "cuda"
                else teng.knn_query_auto(tdidx, tqr, k))
    assert_same_outputs((nn_idx, nn_d2, exact), untraced)
    np.testing.assert_array_equal(host(nn_idx), np.asarray(j_idx))
    for qi in range(qs.shape[0]):
        d_k = float(np.sqrt(max(host(nn_d2)[qi, k - 1], 0.0)))
        assert trace_counts(tr, qi) == host_counts(thost, cfg, qs[qi],
                                                   d_k)[:3]
        assert int(host(tr.answers)[qi]) == k


@pytest.fixture(scope="module")
def tiers(db, thost):
    from repro.core.engine import TieredIndex as JTiered

    jhost = jbuild(db, JConfig(n_segments=LEVELS, alphabet=ALPHA),
                   normalize=False)
    return {mode: (teng.TieredIndex.from_host(thost, mode, device="cpu"),
                   JTiered.from_host(jhost, mode))
            for mode in ("int8", "bf16")}


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_trace_equals_reference_and_widened_host_oracle(
        thost, cfg, db, tiers, mode):
    ttier, jtier = tiers[mode]
    qhost = quantize_host_index(thost, mode)
    qs = np.asarray(make_queries(db, 4, seed=9), np.float32)
    tqr = teng.represent_queries(torch.as_tensor(qs), LEVELS, ALPHA,
                                 normalize=False)
    jqr = jeng.represent_queries(jnp.asarray(qs), LEVELS, ALPHA,
                                 normalize=False)
    for eps in (1.0, 2.0):
        *out, tr = teng.quantized_range_query_traced(ttier, tqr, eps)
        *jout, jtr = jeng.quantized_range_query_traced(jtier, jqr,
                                                       np.float32(eps))
        assert_traces_equal(tr, jtr)
        assert_same_outputs(out, teng.quantized_range_query(ttier, tqr, eps))
        for qi in range(qs.shape[0]):
            r = tsearch.quantized_fastsax_range_query(
                qhost, thost.series,
                represent_query(qs[qi], cfg, normalize=False), eps)
            assert trace_counts(tr, qi)[:2] == (r.excluded_c9,
                                                r.excluded_c10)
    # k-NN at the final radius through the tier.
    *out, tr = teng.quantized_knn_query_traced(ttier, tqr, 5)
    *jout, jtr = jeng.quantized_knn_query_traced(jtier, jqr, 5)
    assert_traces_equal(tr, jtr)
    np.testing.assert_array_equal(host(out[0]), np.asarray(jout[0]))
    assert_same_outputs(out, teng.quantized_knn_query(ttier, tqr, 5))
    # The screen count is kernel 5's keep count (its plain version here).
    keep, _ = teng.quantized_screen(ttier.dev, tqr, 2.0)
    tr2 = teng.quantized_cascade_trace(ttier.dev, tqr, 2.0)
    np.testing.assert_array_equal(host(tr2.screen_survivors),
                                  host(keep.sum(dim=-1)))


@pytest.fixture(scope="module")
def subseq():
    rng = np.random.default_rng(11)
    streams = rng.standard_normal((4, 512)).astype(np.float32)
    hidx = tss.build_subseq_index(streams, FastSAXConfig(n_segments=LEVELS,
                                                         alphabet=ALPHA),
                                  window=128, stride=4)
    sidx = tss.subseq_device_index(hidx, "cpu")
    jsidx = jss.subseq_device_index(jss.build_subseq_index(
        streams, JConfig(n_segments=LEVELS, alphabet=ALPHA), window=128,
        stride=4))
    # Two windows of the index (starts on the stride) and one off it.
    q = np.stack([streams[0, 36:164], streams[1, 100:228],
                  streams[2, 37:165]])
    return hidx, sidx, jsidx, q


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("eps", [1.0, 3.0])
def test_subseq_range_trace_equals_reference_and_host(subseq, eps, backend):
    hidx, sidx, jsidx, q = subseq
    opts = SearchOptions(backend=backend)
    qr = tss.represent_subseq_queries(sidx, q)
    ans, d2, tr = tss.subseq_range_query_traced(sidx, qr, eps, options=opts)
    jqr = jss.represent_subseq_queries(jsidx, q)
    jans, _, jtr = jss.subseq_range_query_traced(jsidx, jqr, eps)
    assert_traces_equal(tr, jtr)
    assert_same_outputs((ans, d2), tss.subseq_range_query(sidx, qr, eps,
                                                          options=opts))
    a9, a10 = host(tr.after_c9), host(tr.after_c10)
    assert (a10 <= a9).all() and (a9[:, 1:] <= a10[:, :-1]).all()
    assert int(host(tr.answers).sum()) == int(host(ans).sum()) > 0
    # The host engine over the materialised windows counts the same.
    win = tss.materialize_windows_np(hidx)
    from repro_torch.core.fastsax import FastSAXIndex
    whost = FastSAXIndex(config=hidx.config, series=win, levels=hidx.levels)
    for qi in range(q.shape[0]):
        r = tsearch.fastsax_range_query(
            whost, represent_query(q[qi], hidx.config), eps)
        assert (int(ttrace.excluded_c9(tr, sidx.n_windows).sum(-1)[qi]),
                int(ttrace.excluded_c10(tr).sum(-1)[qi]),
                int(tr.candidates[qi])) == (r.excluded_c9, r.excluded_c10,
                                            r.candidates)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_subseq_knn_trace_equals_reference(subseq, backend):
    _, sidx, jsidx, q = subseq
    opts = SearchOptions(backend=backend)
    qr = tss.represent_subseq_queries(sidx, q)
    sel_idx, sel_d2, exact, tr = tss.subseq_knn_query_traced(
        sidx, qr, 3, excl=16, options=opts)
    jqr = jss.represent_subseq_queries(jsidx, q)
    j_idx, _, _, jtr = jss.subseq_knn_query_traced(jsidx, jqr, 3, excl=16)
    assert_traces_equal(tr, jtr)
    np.testing.assert_array_equal(sel_idx, np.asarray(j_idx))
    untraced = tss.subseq_knn_query(sidx, qr, 3, excl=16, options=opts)
    assert_same_outputs((sel_idx, sel_d2, exact), untraced)
    assert (host(tr.answers) == 3).all()


# ---------------------------------------------------------------------------
# The serving twins: answers bit-identical to the untraced engines.
# ---------------------------------------------------------------------------

def mixed_args(queries, pat):
    qs, tqr, jqr = queries
    Q = qs.shape[0]
    eps = np.linspace(0.5, 3.0, Q).astype(np.float32)
    knn = (np.arange(Q) % 3 == 0) if pat == 0 else (np.arange(Q) % 2 == 1)
    return tqr, jqr, eps, knn


@pytest.mark.parametrize("pat", [0, 1])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_dense_twin_bit_identical_and_counters(tdidx, jdidx, queries, pat,
                                               k):
    tqr, jqr, eps, knn = mixed_args(queries, pat)
    args = (tqr, torch.as_tensor(eps), torch.as_tensor(knn), k)
    t = teng.mixed_query_dense_and_trace(tdidx, *args)
    assert_same_outputs(t[:4], teng.mixed_query_dense(tdidx, *args))
    jt = jeng.mixed_query_dense_and_trace(jdidx, jqr, jnp.asarray(eps),
                                          jnp.asarray(knn), k)
    assert_traces_equal(t[4], jt[4])
    a9 = host(t[4].after_c9)
    assert (a9[knn] == B).all()
    assert (host(t[4].answers)[knn] == min(k, B)).all()


@pytest.mark.parametrize("k", [1, 5])
def test_compact_twin_bit_identical_and_counters(tdidx, jdidx, queries, k):
    tqr, jqr, eps, knn = mixed_args(queries, 0)
    args = (tqr, torch.as_tensor(eps), torch.as_tensor(knn), k, 64)
    t = teng.mixed_query_and_trace(tdidx, *args)
    assert_same_outputs(t[:4], teng.mixed_query(tdidx, *args))
    jt = jeng.mixed_query_and_trace(jdidx, jqr, jnp.asarray(eps),
                                    jnp.asarray(knn), k, 64)
    assert_traces_equal(t[4], jt[4])


def test_fused_mixed_trace_equals_reference(tdidx, jdidx, queries):
    # The service's fused dispatch: mixed_trace over mixed_query_fused's
    # dense buffers, and the reference's mixed_trace over the same buffers.
    tqr, jqr, eps, knn = mixed_args(queries, 1)
    out = teng.mixed_query_fused(tdidx, tqr, torch.as_tensor(eps),
                                 torch.as_tensor(knn), 5)
    tr = teng.mixed_trace(tdidx, tqr, torch.as_tensor(eps),
                          torch.as_tensor(knn), 5, out[1], out[2])
    jtr = jeng.mixed_trace(jdidx, jqr, jnp.asarray(eps), jnp.asarray(knn), 5,
                           jnp.asarray(host(out[1])),
                           jnp.asarray(host(out[2])))
    assert_traces_equal(tr, jtr)
    assert (host(tr.answers)[knn] == 5).all()


def test_dense_twin_with_valid_mask(tdidx, jdidx, queries):
    tqr, jqr, eps, knn = mixed_args(queries, 1)
    vm = np.arange(B) % 5 != 0
    args = (tqr, torch.as_tensor(eps), torch.as_tensor(knn), 5,
            torch.as_tensor(vm))
    t = teng.mixed_query_dense_and_trace(tdidx, *args)
    assert_same_outputs(t[:4], teng.mixed_query_dense(tdidx, *args))
    jt = jeng.mixed_query_dense_and_trace(jdidx, jqr, jnp.asarray(eps),
                                          jnp.asarray(knn), 5,
                                          jnp.asarray(vm))
    assert_traces_equal(t[4], jt[4])
    assert (host(t[4].verified)[knn] == int(vm.sum())).all()


def test_counting_chunks_do_not_change_counts(tdidx, queries, monkeypatch):
    tqr, _, eps, _ = mixed_args(queries, 0)
    whole = teng._cascade_counting(tdidx, tqr, torch.as_tensor(eps), None)
    monkeypatch.setattr(teng, "_COUNT_CHUNK_BYTES", 8 * 16 * 4 * 7)
    assert len(teng._count_chunks(B, 8, LEVELS)) > 30
    chunked = teng._cascade_counting(tdidx, tqr, torch.as_tensor(eps), None)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(host(a), host(b))
    # Per level, the counts of cascade_mask's own alive set.
    alive = teng.cascade_mask(tdidx, tqr, torch.as_tensor(eps))
    np.testing.assert_array_equal(host(chunked[1])[:, -1],
                                  host(alive.sum(dim=-1)))


# ---------------------------------------------------------------------------
# The k-th order statistic inside the traced calls.
# ---------------------------------------------------------------------------

def test_kth_smallest_equals_reference_rounds_on_adversarial_grid():
    rng = np.random.default_rng(17)
    for width in (33, 97, 256, 320, 2048):
        for k in (1, 2, 5, 8, 31):
            a = np.where(rng.random((16, width)) < 0.7,
                         rng.random((16, width)), np.inf).astype(np.float32)
            a[0] = 0.5                       # all-tie row
            a[1] = np.inf                    # no finite entries
            a[2, : min(9, width)] = 0.25     # duplicate cluster at the front
            if width > 140:
                a[3, 5] = a[3, 77] = a[3, 139] = 1e-6   # cross-block ties
            want = np.asarray(jeng._kth_smallest_rounds(jnp.asarray(a), k))
            got = host(teng._kth_smallest(torch.as_tensor(a), k))
            np.testing.assert_array_equal(got, want, err_msg=f"{width} {k}")


# ---------------------------------------------------------------------------
# Tracing off leaves the untraced path alone.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_untraced_service_never_counts(db, monkeypatch, backend):
    def boom(*a, **kw):
        raise AssertionError("the counting pass ran with tracing off")

    monkeypatch.setattr(teng, "_cascade_counting", boom)
    monkeypatch.setattr(teng, "_quant_cascade_counting", boom)
    svc = SearchService.from_series(
        db, ServeConfig(max_batch=8, normalize_queries=False,
                        backend=backend), normalize=False, device="cpu")
    assert svc.tracer is None and svc.calibration is None
    qs = make_queries(db, 4, seed=6)
    workload = make_workload(qs, WorkloadSpec(n_requests=12, knn_frac=0.5,
                                              k=3, epsilon=2.0))
    with svc:
        res = run_saturated(svc, workload)
    assert res.served == len(workload)
    assert svc.stats.snapshot()["cascade"]["queries"] == 0
    assert svc.backend.last_trace is None
    text = svc.metrics_text()
    for fam in tmetrics.STAGE_FAMILIES:
        assert f"# TYPE {fam} counter" in text, fam


# ---------------------------------------------------------------------------
# Trace helpers, span ring, calibration log, metrics: the reference's.
# ---------------------------------------------------------------------------

def toy_trace(q=4, as_torch=False):
    a10 = np.arange(q * 2).reshape(q, 2).astype(np.int32)
    leaves = [a10 + 1, a10, a10[:, -1], a10[:, -1], np.ones(q, np.int32)]
    if as_torch:
        leaves = [torch.as_tensor(x) for x in leaves]
    return leaves


@pytest.mark.parametrize("as_torch", [False, True])
def test_merge_select_totals_equal_reference(as_torch):
    t = ttrace.QueryTrace(*toy_trace(as_torch=as_torch))
    jt = jtrace.QueryTrace(*toy_trace())
    assert_traces_equal(ttrace.merge_traces([t, t]),
                        jtrace.merge_traces([jt, jt]))
    assert_traces_equal(ttrace.select_queries(t, [0, 2]),
                        jtrace.select_queries(jt, [0, 2]))
    assert ttrace.trace_totals(t, 100) == jtrace.trace_totals(jt, 100)
    assert ttrace.tier_bytes(t, 100, 72, 128) == \
        jtrace.tier_bytes(jt, 100, 72, 128)
    assert ttrace.screen_row_bytes(LEVELS, ALPHA, 1, 1) == \
        jtrace.screen_row_bytes(LEVELS, ALPHA, 1, 1)
    np.testing.assert_array_equal(ttrace.excluded_c9(t, 100),
                                  jtrace.excluded_c9(jt, 100))
    np.testing.assert_array_equal(t.candidates, jt.candidates)
    assert_traces_equal(ttrace.to_host(t), jt)
    with pytest.raises(ValueError):
        ttrace.merge_traces([])


def test_span_ring_bounded_and_exports_equal_reference(tmp_path):
    rec, jrec = tspans.SpanRecorder(capacity=8), jspans.SpanRecorder(8)
    for r in (rec, jrec):
        for i in range(20):
            name = ("dispatch", "reply")[i % 2]
            r.record(name, float(i), float(i) + 0.5, batch=i)
    assert len(rec) == 8 and rec.recorded == 20 and rec.capacity == 8
    for export in ("to_jsonl", "to_chrome_trace"):
        got, want = tmp_path / f"t_{export}", tmp_path / f"j_{export}"
        assert getattr(rec, export)(got) == getattr(jrec, export)(want) == 8
        assert got.read_text() == want.read_text()
    lines = [json.loads(x) for x in
             (tmp_path / "t_to_jsonl").read_text().splitlines()]
    assert lines[0]["duration_ms"] == pytest.approx(500.0)
    assert rec.counts() == jrec.counts() == {"dispatch": 4, "reply": 4}
    with rec.span("verify", batch=3):
        pass
    assert rec.snapshot()[-1].name == "verify" and len(rec) == 8


@pytest.mark.parametrize("bound_by", ["bytes", "operations"])
def test_calibration_record_is_the_h100_arithmetic(tmp_path, bound_by):
    log = tcal.CalibrationLog(capacity=4)
    assert log.summary() == jcal.CalibrationLog().summary()
    est = ({"t_est_s": 1e-3, "bytes_hbm": 1e6, "flops": 1e7}
           if bound_by == "bytes" else
           {"t_est_s": 1e-3, "bytes_hbm": 1e3, "flops": 1e9})
    # By hand: bytes over 3.35 TB/s, FLOPs over 67 TFLOP/s, the larger.
    want = 1e6 / 3.35e12 if bound_by == "bytes" else 1e9 / 67e12
    for _ in range(10):
        rec = log.record(batch=16, k=8, backend="_SingleBackend",
                         measured_s=2e-3, estimate=est)
    assert rec.bound_s == pytest.approx(want, rel=1e-12)
    assert rec.roofline_frac == pytest.approx(want / 2e-3, rel=1e-12)
    assert rec.rel_err == pytest.approx(0.5)
    assert [f for f in rec.as_dict()] == \
        [f.name for f in jcal.DispatchRecord.__dataclass_fields__.values()]
    assert len(log) == 4 and log.recorded == 10
    assert log.summary()["mean_rel_err"] == pytest.approx(0.5)
    out = tmp_path / "cal.jsonl"
    assert log.to_jsonl(out) == 4
    assert json.loads(out.read_text().splitlines()[0])["bound_s"] == \
        pytest.approx(want)
    assert log.record(batch=1, k=1, backend="x", measured_s=1.0,
                      estimate=None).bound_s == 0.0


def busy_stats() -> StatsTracker:
    from repro_torch.serve.batcher import Request

    st = StatsTracker()
    for _ in range(5):
        st.on_submit()
    st.on_batch(3, 4, 2)
    served = []
    for lat in (0.01, 0.02, 0.03):
        req = Request(kind="knn", query=np.zeros(4, np.float32))
        req.t_submit, req.t_done = 1.0, 1.0 + lat
        served.append(req)
    st.on_served_batch(served)
    st.on_escalation()
    st.on_pass(certified=(3, 4))
    st.on_cascade({"queries": 3, "rows_screened": 768, "after_c9": 40,
                   "after_c10": 12, "excluded_c9": 700, "excluded_c10": 30,
                   "screen_survivors": 12, "verified": 12, "answers": 5,
                   "bytes_screen": 99, "bytes_verify": 77})
    return st


@pytest.mark.parametrize("traffic", [False, True])
def test_metrics_text_equals_reference(traffic):
    snap = (busy_stats() if traffic else StatsTracker()).snapshot()
    log, spans = tcal.CalibrationLog(), tspans.SpanRecorder()
    if traffic:
        log.record(batch=3, k=8, backend="b", measured_s=0.1,
                   estimate={"t_est_s": 0.001, "bytes_hbm": 1e6,
                             "flops": 1e6})
        spans.record("dispatch", 0.0, 1.0)
    got = tmetrics.build_registry(snap, log.summary(), spans.counts())
    want = jmetrics.build_registry(snap, log.summary(), spans.counts())
    assert got.render() == want.render()
    assert tmetrics.REQUIRED_FAMILIES == jmetrics.REQUIRED_FAMILIES
    for fam in tmetrics.REQUIRED_FAMILIES:
        assert f"# TYPE {fam}" in got.render(), fam
    assert "nan" not in got.render().lower()


# ---------------------------------------------------------------------------
# Traced serving end to end.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_traced_service_exact_and_surfaces_populated(db, backend):
    cfg = ServeConfig(max_batch=8, max_queue=64, max_wait_ms=1.0,
                      normalize_queries=False, trace=True, backend=backend)
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    qs = make_queries(db, 8, seed=6)
    workload = make_workload(qs, WorkloadSpec(n_requests=32, knn_frac=0.5,
                                              k=3, epsilon=2.0))
    with svc:
        res = run_saturated(svc, workload)
        assert res.statuses.count(OK) == len(workload)
        assert check_exactness(svc, workload, res) == 0
        snap = svc.stats.snapshot()
        server = tmetrics.start_metrics_server(svc.metrics_text, 0)
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}"
            text = urllib.request.urlopen(url + "/metrics",
                                          timeout=10).read().decode()
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(url + "/healthz", timeout=10)
        finally:
            server.shutdown()
            server.server_close()
    cascade = snap["cascade"]
    assert cascade["queries"] == len(workload)
    assert cascade["rows_screened"] == len(workload) * B
    assert cascade["verified"] > 0 and cascade["answers"] > 0
    assert cascade["bytes_screen"] > 0 and cascade["bytes_verify"] > 0
    assert svc.tracer.recorded > 0
    assert {"enqueue", "batch_form", "dispatch", "cascade_count",
            "reply"} <= set(svc.tracer.counts())
    assert svc.calibration.recorded == snap["batches"]
    for fam in tmetrics.REQUIRED_FAMILIES:
        assert f"# TYPE {fam}" in text, fam
    for fam in tmetrics.STAGE_FAMILIES:
        assert f"# TYPE {fam} counter" in text, fam
    assert 'repro_cascade_rows_total{stage="verified"} 0' not in text


def test_traced_quantized_service(db):
    cfg = ServeConfig(max_batch=8, max_queue=64, max_wait_ms=1.0,
                      normalize_queries=False, trace=True,
                      quantization="int8")
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    qs = make_queries(db, 6, seed=8)
    workload = make_workload(qs, WorkloadSpec(n_requests=16, knn_frac=0.5,
                                              k=3, epsilon=2.0))
    with svc:
        res = run_saturated(svc, workload)
        assert check_exactness(svc, workload, res) == 0
    cascade = svc.stats.snapshot()["cascade"]
    assert cascade["queries"] == len(workload)
    assert 0 < cascade["screen_survivors"] <= cascade["after_c10"]
    # The raw tier of a cold build is an f32 array: 4 bytes an element.
    assert cascade["bytes_verify"] == cascade["verified"] * N * 4


def test_serve_config_from_options_and_tracing_settings(tmp_path):
    opts = SearchOptions(trace=True, normalize_queries=False, n_iters=3,
                         capacity=96, backend="torch")
    cfg = ServeConfig.from_options(opts, max_batch=4)
    assert (cfg.trace, cfg.normalize_queries, cfg.n_iters, cfg.capacity0,
            cfg.backend, cfg.max_batch) == (True, False, 3, 96, "torch", 4)
    jcfg = jserve.ServeConfig.from_options(
        jserve.service.SearchOptions(trace=True, normalize_queries=False))
    assert (cfg.trace, cfg.normalize_queries) == (jcfg.trace,
                                                  jcfg.normalize_queries)
    with pytest.warns(DeprecationWarning):
        o, _ = __import__("repro_torch.core.options", fromlist=["x"]) \
            .resolve_options(None, {"trace": True}, "t")
    assert o.trace


def test_profiler_capture_writes_one_trace_per_capture(tmp_path):
    with tspans.profiler_capture(""):
        pass                                      # no-op
    for _ in range(2):
        with tspans.profiler_capture(tmp_path / "prof", "cpu"):
            torch.ones(8).sum()
    files = sorted((tmp_path / "prof").glob("dispatch_*.json"))
    assert len(files) == 2
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_saturated_loadgen_jsonl_has_reference_keys(db, tmp_path):
    qs = make_queries(db, 4, seed=7)
    workload = make_workload(qs, WorkloadSpec(n_requests=16, knn_frac=0.5,
                                              k=3, epsilon=2.0))
    svc = SearchService.from_series(
        db, ServeConfig(max_batch=8, max_queue=64, max_wait_ms=1.0,
                        normalize_queries=False), normalize=False,
        device="cpu")
    out = tmp_path / "requests.jsonl"
    with svc:
        res = run_saturated(svc, workload, jsonl_path=out)
    assert res.qps > 0 and res.dropped_in_deadline == 0
    jsvc = jserve.SearchService.from_series(
        db, jserve.ServeConfig(max_batch=8, max_queue=64, max_wait_ms=1.0,
                               normalize_queries=False, backend="xla"),
        normalize=False)
    jout = tmp_path / "j_requests.jsonl"
    with jsvc:
        jserve.run_saturated(jsvc, workload, jsonl_path=jout)
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    jrecs = [json.loads(x) for x in jout.read_text().splitlines()]
    assert len(recs) == len(jrecs) == len(workload)
    for rec, jrec in zip(recs, jrecs):
        assert set(rec) == set(jrec)
        assert rec["status"] == OK and rec["latency_ms"] >= 0
        assert (rec["index"], rec["kind"], rec["k"], rec["n_answers"]) == \
            (jrec["index"], jrec["kind"], jrec["k"], jrec["n_answers"])


def test_cli_info_stats_key_only_with_flag(tmp_path, capsys):
    from repro_torch.index import cli

    rows = make_wafer_like(64, 64, seed=2, normalize=False)
    np.save(tmp_path / "rows.npy", rows)
    idx = str(tmp_path / "idx")
    cli.main(["build", "--dir", idx, "--input", str(tmp_path / "rows.npy"),
              "--levels", "4,8"])
    capsys.readouterr()
    cli.main(["info", "--dir", idx])
    assert "stats" not in json.loads(capsys.readouterr().out)
    cli.main(["info", "--dir", idx, "--stats", "--stats-queries", "4"])
    stats = json.loads(capsys.readouterr().out)["stats"]
    assert stats["queries"] == 4 and stats["rows"] == 64
    assert stats["rows_screened"] == 4 * 64
    for key in ("candidates", "excluded_c9", "excluded_c10", "answers",
                "ops", "model_latency"):
        assert key in stats


@pytest.mark.parametrize("subseq_mode", [False, True])
def test_launcher_writes_every_observability_file(tmp_path, capsys,
                                                  subseq_mode):
    from repro_torch.launch import serve as launch

    files = {flag: tmp_path / name for flag, name in (
        ("--trace-jsonl", "spans.jsonl"), ("--chrome-trace", "spans.json"),
        ("--calibration-out", "calibration.jsonl"),
        ("--request-log", "requests.jsonl"))}
    argv = ["--serve", "--device", "cpu", "--bench-requests", "24",
            "--clients", "4", "--verify-exact", "--trace", "--metrics", "0",
            "--profile-dir", str(tmp_path / "prof")]
    argv += (["--subseq", "--streams", "3", "--stream-len", "700"]
             if subseq_mode else ["--db-size", "300"])
    for flag, path in files.items():
        argv += [flag, str(path)]
    summary = launch.main(argv)
    out = capsys.readouterr().out
    assert summary["exact_mismatches"] == 0 and summary["served"] == 24
    assert "/metrics" in out
    assert summary["stats"]["cascade"]["queries"] == 24
    for flag, path in files.items():
        lines = path.read_text().splitlines()
        assert lines, flag
        json.loads(lines[0])
    assert len(json.loads(files["--request-log"].read_text().splitlines()[0]
                          )) == 9
    assert sorted((tmp_path / "prof").glob("dispatch_*.json"))
