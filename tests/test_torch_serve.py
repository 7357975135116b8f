"""The port's query service against the reference service.

One mixed workload of 32 requests over a 512-series database goes through
``repro_torch``'s ``SearchService`` on the CPU (both engines: the torch
one, and the fused one running the kernels' plain versions) and through
``repro``'s ``SearchService(backend="xla")``.  Batches form differently
in each run, and every engine is exact, so every request's answer must
be the same: ids equal, distances within the d² band of the engine tests
(1e-3 + 1e-5·d², the matmul-form f32 noise).
"""
import json
import pathlib
import time

import numpy as np
import pytest

import repro.serve as jserve
from repro_torch.core import engine as teng
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.serve import (OK, REJECTED_DEADLINE, SearchService,
                               ServeConfig, WorkloadSpec, check_exactness,
                               make_workload, run_closed_loop)

B, N = 512, 128


@pytest.fixture(scope="module")
def db():
    return make_wafer_like(B, N, seed=0)


@pytest.fixture(scope="module")
def workload(db):
    qs = make_queries(db, 12, seed=1)
    return make_workload(qs, WorkloadSpec(n_requests=32, knn_frac=0.5, k=5,
                                          epsilon=2.0, seed=3))


def serve(service, workload):
    with service:
        result = run_closed_loop(service, workload, clients=8)
        mismatches = check_exactness(service, workload, result)
    assert result.served == len(workload)
    assert mismatches == 0
    return result


@pytest.fixture(scope="module")
def reference(db, workload):
    cfg = jserve.ServeConfig(max_batch=16, max_wait_ms=1.0,
                             normalize_queries=False, backend="xla")
    svc = jserve.SearchService.from_series(db, cfg, normalize=False)
    with svc:
        result = jserve.run_closed_loop(svc, workload, clients=8)
    return result


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_service_matches_reference(db, workload, reference, backend):
    cfg = ServeConfig(max_batch=16, max_wait_ms=1.0, normalize_queries=False,
                      backend=backend)
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    assert svc.backend.backend == backend
    result = serve(svc, workload)
    n_answers = 0
    for (kind, _q, _e, k), got, want in zip(workload, result.requests,
                                            reference.requests):
        assert want.status == OK
        np.testing.assert_array_equal(got.ids, want.ids)
        d2g, d2w = got.distances ** 2, want.distances ** 2
        assert np.all(np.abs(d2g - d2w) <= 1e-3 + 1e-5 * d2w)
        if kind == "knn":
            assert got.ids.size == k
        n_answers += got.ids.size
    assert n_answers > len(workload)
    # The fused dispatch copies the dense (Q, B) layout to the host.
    assert svc.backend.last_d2h_bytes > 0


def test_service_default_config_on_cpu(db, workload):
    # The published defaults (max_batch 32, normalised queries, auto
    # backend), which pick the torch engine for a CPU index.
    svc = SearchService.from_series(db, ServeConfig(), device="cpu")
    assert svc.backend.backend == "torch"
    svc.warmup(qs=(1, 32))
    serve(svc, workload)
    snap = svc.stats.snapshot()
    assert snap["served"] == len(workload) and snap["failed"] == 0


def test_deadline_expired_rejected_not_served(db):
    svc = SearchService.from_series(db, ServeConfig(max_wait_ms=1.0),
                                    device="cpu")
    q = make_queries(db, 1, seed=5)[0]
    with svc:
        req = svc.submit_knn(q, 3, deadline_ms=-1.0)
        assert req.wait(10) == REJECTED_DEADLINE
        ids, dist = svc.knn(q, 3)
    assert ids.size == 3 and np.all(np.diff(dist) >= 0)


def test_later_slices_raise_not_implemented(db):
    with pytest.raises(NotImplementedError, match="multi-device"):
        ServeConfig(failover_shards=2)
    with pytest.raises(NotImplementedError, match="multi-device"):
        SearchService.from_series(db, ServeConfig(), mesh=object(),
                                  device="cpu")
    # Tracing is ported: the service takes the setting.
    svc = SearchService.from_series(db, ServeConfig(trace=True),
                                    device="cpu")
    assert svc.cfg.trace and svc.tracer is not None \
        and svc.calibration is not None


# The reference's ServeConfig settings of slices the port lacks, a value
# other than the reference's default, and the ROADMAP.md item they wait on.
UNPORTED_SETTINGS = [
    ("shard_timeout_s", 5.0, 8), ("shard_retries", 0, 8),
    ("shard_backoff_s", 0.1, 8)]


@pytest.mark.parametrize("name,value,item", UNPORTED_SETTINGS)
def test_reference_settings_wait_for_their_slice(name, value, item):
    # Accepted at the reference's default, refused with the item's number
    # otherwise (not a TypeError for an unknown field).
    ref_default = jserve.ServeConfig.__dataclass_fields__[name].default
    assert getattr(ServeConfig(), name) == ref_default
    assert getattr(ServeConfig(**{name: ref_default}), name) == ref_default
    with pytest.raises(NotImplementedError, match=rf"queue 1 item {item}\)"):
        ServeConfig(**{name: value})


# The observability slice's settings, at a value other than the
# reference's default: accepted, and they take effect.
ACCEPTED_SETTINGS = [("trace_ring", 64), ("calibration_ring", 64),
                     ("profile_dir", "prof")]


@pytest.mark.parametrize("name,value", ACCEPTED_SETTINGS)
def test_observability_settings_take_effect(db, tmp_path, name, value):
    ref_default = jserve.ServeConfig.__dataclass_fields__[name].default
    assert getattr(ServeConfig(), name) == ref_default
    if name == "profile_dir":
        value = str(tmp_path / value)
    cfg = ServeConfig(max_batch=8, max_wait_ms=1.0, trace=True,
                      **{name: value})
    svc = SearchService.from_series(db, cfg, device="cpu")
    qs = make_queries(db, 16, seed=9)
    with svc:
        for q in qs:               # one batch each: 5 spans a batch
            svc.knn(q, 3)
    if name == "trace_ring":
        assert svc.tracer.capacity == value
        assert len(svc.tracer) == value < svc.tracer.recorded
    elif name == "calibration_ring":
        assert svc.calibration.capacity == value
        assert len(svc.calibration) == svc.calibration.recorded >= 1
    else:
        traces = sorted(pathlib.Path(value).glob("dispatch_*.json"))
        assert len(traces) == svc.stats.snapshot()["batches"] >= 1
        assert json.loads(traces[0].read_text())["traceEvents"]


# The live-ingest settings of the index-lifecycle slice, at a value other
# than the reference's default: accepted, and they take effect.
REFRESH_SETTINGS = [("refresh_min_interval_s", 3.0), ("async_refresh", False)]


@pytest.mark.parametrize("name,value", REFRESH_SETTINGS)
def test_refresh_settings_take_effect(db, tmp_path, name, value):
    from repro_torch.core.fastsax import FastSAXConfig
    from repro_torch.index.mutable import MutableIndex

    ref_default = jserve.ServeConfig.__dataclass_fields__[name].default
    assert getattr(ServeConfig(), name) == ref_default != value
    root = tmp_path / "idx"
    MutableIndex.create(root, db[:256], FastSAXConfig(n_segments=(8, 16)))
    cfg = ServeConfig(max_wait_ms=1.0, **{name: value})
    assert getattr(cfg, name) == value
    svc = SearchService.from_store(root, cfg, device="cpu")
    new_row = db[300]
    with svc:
        t_start = svc._last_refresh
        new_id = svc.insert(new_row[None])[0]
        got, _ = svc.knn(new_row, 1)
        swaps = svc.stats.snapshot()["events"]["refresh_swaps"]
        if name == "async_refresh":
            # Synchronous: the batch after the commit swaps first and
            # already answers with the new row; no background thread.
            assert got[0] == new_id and swaps == 1
            assert svc._refresh_thread is None
        else:
            # Inside the interval the swap waits: the old generation
            # serves and the service stays stale.
            assert time.perf_counter() - t_start < value
            assert got[0] != new_id and swaps == 0 and svc._stale
            while time.perf_counter() - t_start < value:
                time.sleep(0.02)
            deadline = time.perf_counter() + 30.0
            while got[0] != new_id:
                assert time.perf_counter() < deadline, "no swap landed"
                got, _ = svc.knn(new_row, 1)
                time.sleep(0.01)
            assert svc.stats.snapshot()["events"]["refresh_swaps"] == 1
    assert svc.generation == 1 and not svc._stale


def test_batch_and_replay_take_the_same_float_path(db):
    # The fused engine's (query, row) results do not depend on the batch:
    # a query alone and inside a batch of 16 give bit-equal rows, the
    # query normalisation included.
    svc = SearchService.from_series(db, ServeConfig(backend="cuda"),
                                    normalize=False, device="cpu")
    qs = make_queries(db, 16, seed=9).astype(np.float32)
    eps = np.full(16, 2.5, np.float32)
    is_knn = np.arange(16) % 2 == 0
    idx, ans, d2 = svc.backend.dispatch(qs, eps, is_knn, 8)
    for i in (0, 1, 15):
        i1, a1, d1 = svc.backend.dispatch(qs[i:i + 1], eps[i:i + 1],
                                          is_knn[i:i + 1], 8)
        np.testing.assert_array_equal(a1[0], ans[i])
        np.testing.assert_array_equal(d1[0], d2[i])


def test_launcher_serve_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--serve", "--device", "cpu", "--db-size", "300",
          "--bench-requests", "12", "--clients", "4", "--verify-exact"])
    out = capsys.readouterr().out
    assert "(torch backend)" in out
    summary = [ln for ln in out.splitlines()
               if ln.startswith("[serve] summary ")][-1]
    s = json.loads(summary[len("[serve] summary "):])
    assert s["served"] == 12 and s["exact_mismatches"] == 0


def test_replay_after_the_dense_switch_is_exact():
    # The torch backend switches for good to the dense layout once its
    # capacity escalation passes dense_fallback_frac·B, so a request served
    # before the switch is replayed after it in the other layout: both
    # must give the same ids and distances (both verify in the diff²
    # form).  A service whose fallback lies beyond B never switches.
    from repro_torch.data.timeseries import make_trending
    db = make_trending(512, 128, seed=5)
    compact = SearchService.from_series(
        db, ServeConfig(backend="torch", dense_fallback_frac=4.0),
        normalize=False, device="cpu")
    dense = SearchService.from_series(db, ServeConfig(backend="torch"),
                                      normalize=False, device="cpu")
    # A zero query's k-NN radius admits every row: the escalation goes
    # dense.
    dense.direct_query("knn", np.zeros(128, np.float32), k=3)
    assert dense.backend._cap == -1
    for q in make_queries(db, 6, seed=6).astype(np.float32):
        for kind in ("range", "knn"):
            i0, d0 = compact.direct_query(kind, q, epsilon=1.0, k=3)
            i1, d1 = dense.direct_query(kind, q, epsilon=1.0, k=3)
            assert compact.backend._cap != -1
            np.testing.assert_array_equal(i0, i1)
            np.testing.assert_array_equal(d0, d1)
