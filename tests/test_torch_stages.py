"""The serving path's stage counters, spans and ranges, on the CPU.

A ``SearchService`` over 256 series of length 64 (both engines: the torch
one, and the fused one running the kernels' plain versions, whose every
pass is dense) and a small ``SubseqSearchService``:

  * **counters**: ``stats.snapshot()["stages"]`` has every stage with
    zeros before traffic; after it, ``represent`` / ``engine`` / ``copy``
    count the device passes, ``compact`` the dense ones, ``queue`` /
    ``reply_wait`` / ``postprocess`` the served requests and
    ``reply.knn`` / ``reply.range`` them by kind; a dense pass copies its
    compacted answers, ``d2h_bytes`` = 4 Q + 8 Q C + Q bytes with C its
    largest answer count, and ``answer_slots`` counts them;
  * **no counting pass** with tracing off (the stages need none);
  * **spans** share a request id across ``enqueue``, ``reply_wait``,
    ``reply.<kind>`` and ``postprocess``, and a batch id with the
    dispatch's stages;
  * **profiler ranges**: a profile captured on the dispatcher thread
    (``profile_dir``) holds ``repro.<stage>`` ranges;
  * **latency** is each request's own, not its batch's last;
  * **calibration** measures the ``engine`` stage;
  * **metrics**: the stage families render, traced or not.
"""
import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core import engine as teng
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.serve import (KIND_KNN, KIND_RANGE, OK, SearchService,
                               ServeConfig, WorkloadSpec, make_workload,
                               run_saturated)
from repro_torch.serve import service as service_mod
from repro_torch.serve.stats import (PASS_STAGES, REQUEST_STAGES, STAGE_KEYS,
                                     StatsTracker)
from repro_torch.obs.metrics import STAGE_FAMILIES, build_stage_registry

B, N = 256, 64


@pytest.fixture(scope="module")
def db():
    return make_wafer_like(B, N, seed=5, normalize=False)


@pytest.fixture(scope="module")
def workload(db):
    qs = make_queries(db, 6, seed=7)
    return make_workload(qs, WorkloadSpec(n_requests=24, knn_frac=0.5, k=3,
                                          epsilon=2.0, seed=2))


def service(db, **kw):
    cfg = ServeConfig(**{"max_batch": 8, "max_queue": 64,
                         "max_wait_ms": 1.0, "normalize_queries": False,
                         **kw})
    return SearchService.from_series(db, cfg, normalize=False, device="cpu")


def count_compactions(monkeypatch) -> list:
    """Note the (Q,) answer counts of every compacted pass, each held to
    the dense mask it compacted."""
    counts = []
    inner = service_mod.compact_dense

    def compact(answer, d2):
        out = inner(answer, d2)
        np.testing.assert_array_equal(out[0], answer.sum(dim=-1).numpy())
        counts.append(out[0])
        return out

    monkeypatch.setattr(service_mod, "compact_dense", compact)
    return counts


def count_passes(svc) -> list:
    """Wrap the backend's dispatch (as the benchmark does) to note each
    pass's Q bucket."""
    buckets = []
    inner = svc.backend.dispatch

    def dispatch(q, *a, **kw):
        buckets.append(int(q.shape[0]))
        return inner(q, *a, **kw)

    svc.backend.dispatch = dispatch
    return buckets


def test_every_stage_present_with_zeros_before_traffic():
    snap = StatsTracker().snapshot()
    assert list(snap["stages"]) == list(STAGE_KEYS)
    assert STAGE_KEYS == PASS_STAGES + REQUEST_STAGES
    for acc in snap["stages"].values():
        assert acc == {"count": 0, "host_s": 0.0, "device_s": 0.0}
    assert snap["d2h_bytes"] == snap["d2h_requests"] == 0
    assert snap["answer_slots"] == 0
    assert PASS_STAGES == ("represent", "engine", "compact", "copy")
    text = build_stage_registry(snap).render()
    for fam in STAGE_FAMILIES:
        assert f"# TYPE {fam} counter" in text
    assert 'repro_stage_events_total{stage="reply.knn"} 0' in text
    assert 'repro_stage_events_total{stage="compact"} 0' in text
    assert "repro_d2h_bytes_total 0" in text
    assert "repro_answer_slots_total 0" in text


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_stage_counts_equal_passes_and_served_requests(db, workload,
                                                       backend, monkeypatch):
    counts = count_compactions(monkeypatch)
    svc = service(db, backend=backend)
    buckets = count_passes(svc)
    with svc:
        res = run_saturated(svc, workload)
    assert res.statuses.count(OK) == len(workload)
    snap = svc.stats.snapshot()
    st = snap["stages"]
    assert len(buckets) == snap["batches"] >= 3
    # Every fused pass is dense; the torch engine's are once it switched.
    assert len(counts) == len(buckets) or backend == "torch"
    for name in PASS_STAGES:
        assert st[name]["count"] == (len(counts) if name == "compact"
                                     else len(buckets)), name
        assert st[name]["host_s"] > 0
        # On a CPU device the device seconds are the host's.
        assert st[name]["device_s"] == st[name]["host_s"]
    n_knn = sum(kind == KIND_KNN for kind, *_ in workload)
    for name in ("queue", "reply_wait", "postprocess"):
        assert st[name]["count"] == len(workload), name
    assert st["reply.knn"]["count"] == n_knn
    assert st["reply.range"]["count"] == len(workload) - n_knn
    for name in REQUEST_STAGES:
        assert st[name]["host_s"] > 0 and st[name]["device_s"] == 0.0, name
    # The certificates ride on the pass's one record: every query.
    assert snap["events"]["certified_total"] == sum(buckets)


def test_d2h_bytes_sum_over_dense_passes(db, workload, monkeypatch):
    counts = count_compactions(monkeypatch)
    svc = service(db, backend="cuda")
    buckets = count_passes(svc)
    with svc:
        run_saturated(svc, workload)
        svc.direct_query(KIND_RANGE, workload[0][1], epsilon=2.0)
    # Every pass is dense and compacted before its copy: per query an
    # int32 count, C int32 ids and C f32 d² (C the pass's largest count)
    # and a bool; the mask stays on the device.
    assert [c.size for c in counts] == buckets
    snap = svc.stats.snapshot()
    assert snap["d2h_bytes"] == sum(
        c.size * 4 + c.size * int(c.max()) * 8 + c.size for c in counts)
    assert snap["d2h_bytes"] < sum(qb * B for qb in buckets)
    assert snap["answer_slots"] == sum(int(c.sum()) for c in counts) > 0
    assert f"repro_answer_slots_total {snap['answer_slots']}" in \
        svc.metrics_text()
    assert buckets[-1] == 1   # the direct pass counted too
    # The requests those bytes answered, padding left out, in the same
    # record as the bytes.
    assert snap["d2h_requests"] == len(workload) + 1 <= sum(buckets)


def test_failover_pass_counts_its_bytes_and_certificates(db, workload):
    svc = service(db, backend="torch", failover_shards=2)
    with svc:
        res = run_saturated(svc, workload[:8])
    assert res.statuses.count(OK) == 8
    snap = svc.stats.snapshot()
    assert snap["d2h_requests"] == 8 and snap["d2h_bytes"] > 0
    assert snap["events"]["certified_exact"] == \
        snap["events"]["certified_total"] > 0
    # Its passes time no stages.
    assert all(snap["stages"][s]["count"] == 0 for s in PASS_STAGES)
    assert f"repro_d2h_bytes_total {snap['d2h_bytes']}" in svc.metrics_text()


def test_dense_counting_pass_falls_outside_the_engine_stage(db, workload,
                                                            monkeypatch):
    counted = []
    inner = service_mod.mixed_dense_trace

    def slow(*a, **kw):
        time.sleep(0.1)
        counted.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(service_mod, "mixed_dense_trace", slow)
    # Capacity 16 then 64 overflow on a range at ε 100 (every row
    # answers), so the pass goes dense.
    svc = service(db, backend="torch", trace=True, capacity0=16,
                  dense_fallback_frac=0.0)
    with svc:
        res = run_saturated(svc, [(KIND_RANGE, db[i], 100.0, 0)
                                  for i in range(3)])
    assert res.statuses.count(OK) == 3
    st = svc.stats.snapshot()["stages"]
    assert counted and len(counted) == st["engine"]["count"]
    assert st["engine"]["host_s"] < 0.1 * len(counted)
    assert sum(r.measured_s for r in svc.calibration.snapshot()) == \
        pytest.approx(st["engine"]["device_s"], rel=1e-12)
    assert svc.stats.snapshot()["cascade"]["queries"] == 3


def test_untraced_stages_run_no_counting_pass(db, workload, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the counting pass ran with tracing off")

    monkeypatch.setattr(teng, "_cascade_counting", boom)
    monkeypatch.setattr(service_mod, "mixed_trace", boom)
    svc = service(db, backend="cuda")
    with svc:
        res = run_saturated(svc, workload)
    assert res.statuses.count(OK) == len(workload)
    assert svc.stats.snapshot()["stages"]["engine"]["count"] >= 3
    assert svc.tracer is None and svc.backend.last_trace is None


def test_spans_share_request_and_batch_ids(db, workload):
    svc = service(db, backend="cuda", trace=True)
    with svc:
        res = run_saturated(svc, workload)
    spans = svc.tracer.snapshot()
    by_rid: dict = {}
    for s in spans:
        if "rid" in s.attrs:
            by_rid.setdefault(s.attrs["rid"], []).append(s)
    assert sorted(by_rid) == sorted(r.rid for r in res.requests)
    for req in res.requests:
        got = by_rid[req.rid]
        assert sorted(s.name for s in got) == sorted(
            ["enqueue", "reply_wait", "reply." + req.kind, "postprocess"])
        assert {s.attrs["batch_id"] for s in got} == {req.batch_id}
        assert all(s.attrs["parent"] == "reply" for s in got
                   if s.name != "enqueue")
        wait = next(s for s in got if s.name == "reply_wait")
        sel = next(s for s in got if s.name == "reply." + req.kind)
        assert wait.t0 <= wait.t1 == sel.t0 <= sel.t1 <= req.t_done
    batch_ids = {r.batch_id for r in res.requests}
    for name in PASS_STAGES:
        stage = [s for s in spans if s.name == name]
        assert {s.attrs["batch_id"] for s in stage} == batch_ids
        assert all(s.attrs["parent"] == "dispatch" for s in stage)
    # Each dispatch's stages lie inside it, in order.
    for d in (s for s in spans if s.name == "dispatch"):
        st = [s for s in spans if s.attrs.get("batch_id") ==
              d.attrs["batch_id"] and s.attrs.get("parent") == "dispatch"]
        assert [s.name for s in st] == list(PASS_STAGES)
        assert d.t0 <= st[0].t0 and st[-1].t1 <= d.t1
        assert all(a.t1 <= b.t0 for a, b in zip(st, st[1:]))
    assert "verify" not in svc.tracer.counts()
    assert svc.tracer.counts()["cascade_count"] == \
        svc.stats.snapshot()["batches"]


def test_profile_on_the_dispatcher_thread_holds_stage_ranges(db, workload,
                                                             tmp_path):
    svc = service(db, backend="cuda", profile_dir=str(tmp_path / "prof"))
    with svc:
        run_saturated(svc, workload[:8])
    names = set()
    for path in sorted((tmp_path / "prof").glob("dispatch_*.json")):
        names |= {e.get("name") for e in
                  json.loads(path.read_text())["traceEvents"]}
    assert {"repro.represent", "repro.engine", "repro.compact",
            "repro.copy"} <= names
    # The replies run outside the per-dispatch capture.
    assert "repro.reply.knn" not in names


def test_reply_ranges_recorded_while_a_profiler_records(db):
    import torch

    svc = service(db, backend="cuda")
    q = db[3]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        svc.direct_query(KIND_KNN, q, k=3)
        svc.direct_query(KIND_RANGE, q, epsilon=1.0)
    names = {e.key for e in prof.key_averages()}
    assert {"repro.represent", "repro.engine", "repro.compact",
            "repro.copy", "repro.reply.knn", "repro.reply.range",
            "repro.postprocess"} <= names


def test_latency_is_each_requests_own(db):
    svc = service(db, backend="cuda", max_wait_ms=50.0)
    inner = svc._postprocess

    def slow(req, rows, dist):
        time.sleep(0.05)
        return inner(req, rows, dist)

    svc._postprocess = slow
    # Queued before the dispatcher starts, so all four form one batch.
    reqs = [svc.submit_knn(db[i], 3) for i in range(4)]
    with svc:
        for r in reqs:
            assert r.wait(30) == OK
    assert len({r.batch_id for r in reqs}) == 1
    lat = [r.t_done - r.t_submit for r in reqs]
    assert lat[0] + 0.1 < lat[-1]
    # The service's own latency record: the first request's, not the
    # batch's last.
    ring = list(svc.stats._latency)
    assert ring == pytest.approx(lat)
    snap = svc.stats.snapshot()
    assert snap["latency_ms"]["p50"] < max(lat) * 1e3 - 50
    assert snap["stages"]["postprocess"]["host_s"] >= 4 * 0.05
    st = snap["stages"]
    # Every request waited behind the replies of those before it.
    assert st["reply_wait"]["host_s"] >= (0 + 1 + 2 + 3) * 0.05


def test_calibration_measures_the_engine_stage(db, workload):
    svc = service(db, backend="cuda", trace=True)
    with svc:
        run_saturated(svc, workload)
    recs = svc.calibration.snapshot()
    engine = [s for s in svc.tracer.snapshot() if s.name == "engine"]
    assert len(recs) == len(engine) == svc.stats.snapshot()["batches"]
    for rec, span in zip(recs, engine):
        assert rec.measured_s == span.attrs["device_s"] == span.t1 - span.t0
    assert sum(r.measured_s for r in recs) == pytest.approx(
        svc.stats.snapshot()["stages"]["engine"]["device_s"], rel=1e-12)


@pytest.mark.parametrize("trace", [False, True])
def test_metrics_text_ends_with_the_stage_families(db, workload, trace):
    svc = service(db, backend="torch", trace=trace)
    with svc:
        run_saturated(svc, workload[:8])
    # Scraped after the dispatcher's join: the last batch is counted.
    text = svc.metrics_text()
    head, _, tail = text.partition("# HELP repro_stage_seconds_total")
    assert "repro_requests_total" in head and "repro_stage" not in head
    for fam in STAGE_FAMILIES:
        assert f"# TYPE {fam} counter" in text, fam
    assert 'repro_stage_events_total{stage="queue"} 8' in tail
    d2h = svc.stats.snapshot()["d2h_bytes"]
    assert f"repro_d2h_bytes_total {d2h}" in tail and d2h > 0


def test_subsequence_service_counts_postprocess_per_request():
    from repro_torch.serve import SubseqSearchService

    rng = np.random.default_rng(3)
    streams = np.cumsum(rng.standard_normal((3, 400)), axis=1)
    svc = SubseqSearchService.from_streams(
        streams, 32, cfg=ServeConfig(max_batch=4, max_wait_ms=1.0),
        device="cpu")
    q = streams[1, 100:132] + 0.01
    with svc:
        reqs = [svc.submit_subseq_knn(q, 2), svc.submit_subseq_range(q, 3.0),
                svc.submit_subseq_knn(q, 1)]
        assert all(r.wait(30) == OK for r in reqs)
    st = svc.stats.snapshot()["stages"]
    assert st["postprocess"]["count"] == 3
    assert (st["reply.knn"]["count"], st["reply.range"]["count"]) == (2, 1)
    assert st["copy"]["count"] == svc.stats.snapshot()["batches"]


def test_one_lock_a_batch_for_served_requests():
    st = StatsTracker()
    calls = []

    class CountingLock:
        def __init__(self):
            self._lock = threading.Lock()

        def __enter__(self):
            calls.append(1)
            return self._lock.__enter__()

        def __exit__(self, *exc):
            return self._lock.__exit__(*exc)

    st._lock = CountingLock()
    from repro_torch.serve.batcher import Request

    reqs = []
    for i in range(32):
        r = Request(kind=(KIND_KNN, KIND_RANGE)[i % 2],
                    query=np.zeros(4, np.float32))
        r.t_submit, r.t_formed, r.t_ready = 1.0, 2.0, 3.0
        r.t_reply, r.t_selected, r.t_post, r.t_done = 4.0, 4.5, 4.75, 5.0
        reqs.append(r)
    st.on_served_batch(reqs)
    st.on_pass([("represent", 0.1, 0.05), ("engine", 0.2, 0.2),
                ("compact", 0.01, 0.01), ("copy", 0.3, 0.3)], 100, (3, 4),
               32, 7)
    assert len(calls) == 2
    snap = st.snapshot()
    assert snap["served"] == 32 and snap["latency_ms"]["p50"] == 4000.0
    s = snap["stages"]
    assert s["queue"] == {"count": 32, "host_s": 32.0, "device_s": 0.0}
    assert s["reply_wait"]["host_s"] == 32.0
    assert s["reply.knn"] == {"count": 16, "host_s": 8.0, "device_s": 0.0}
    assert s["postprocess"]["host_s"] == 8.0
    assert s["represent"] == {"count": 1, "host_s": 0.1, "device_s": 0.05}
    assert s["compact"] == {"count": 1, "host_s": 0.01, "device_s": 0.01}
    assert snap["d2h_bytes"] == 100 and snap["d2h_requests"] == 32
    assert snap["answer_slots"] == 7
    assert snap["events"]["certified_exact"] == 3
