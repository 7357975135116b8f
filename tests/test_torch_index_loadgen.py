"""The port's load generators and benchmark data against the reference's.

``run_saturated`` (the whole workload submitted up front) and
``run_sequential`` (one direct pass per request) over the same workload
through both packages' services, warm-started from one store: every
request served, the same answers request by request (ids equal, d² in
the engine tests' band), and the saturated run's answers equal the
sequential run's.  ``load_ucr`` on a file the test writes, and
``benchmark_database`` with and without ``REPRO_UCR_PATH``.
"""
import json

import numpy as np
import pytest

import repro.serve as jserve
from repro.core.fastsax import FastSAXConfig as JConfig
from repro.core.fastsax import build_index as jbuild
from repro.data import timeseries as jts
from repro.index import store as jstore
from repro_torch.data import timeseries as tts
from repro_torch.serve import (OK, SearchService, ServeConfig, WorkloadSpec,
                               check_exactness, make_workload, run_saturated,
                               run_sequential)


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    db = tts.make_wafer_like(300, 128, seed=0, normalize=False)
    path = tmp_path_factory.mktemp("lg") / "idx"
    jstore.save_index(jbuild(db, JConfig(n_segments=(8, 16), alphabet=10)),
                      path)
    workload = make_workload(tts.make_queries(db, 8, seed=1), WorkloadSpec(
        n_requests=24, knn_frac=0.5, k=4, epsilon=2.0, seed=2))
    return path, workload


@pytest.fixture(scope="module")
def reference(setup):
    path, workload = setup
    svc = jserve.SearchService.from_store(path, jserve.ServeConfig(
        backend="xla", max_batch=8, max_wait_ms=1.0))
    with svc:
        sat = jserve.run_saturated(svc, workload)
        _, seq = jserve.run_sequential(svc, workload)
    return sat, seq


@pytest.mark.parametrize("generator", ["saturated", "sequential"])
def test_load_generators_match_reference(setup, reference, generator):
    path, workload = setup
    svc = SearchService.from_store(path, ServeConfig(max_batch=8,
                                                     max_wait_ms=1.0),
                                   device="cpu")
    with svc:
        if generator == "saturated":
            result = run_saturated(svc, workload)
            assert result.served == len(workload) and result.qps > 0
            assert result.dropped_in_deadline == 0
            assert check_exactness(svc, workload, result) == 0
            got = [(r.ids, r.distances) for r in result.requests]
            want = [(r.ids, r.distances) for r in reference[0].requests]
            assert all(r.status == OK for r in reference[0].requests)
        else:
            wall, got = run_sequential(svc, workload)
            assert wall > 0 and len(got) == len(workload)
            want = reference[1]
            # The baseline's answers are the batched run's, request by
            # request.
            sat = run_saturated(svc, workload)
            for (ids, dist), req in zip(got, sat.requests):
                assert np.array_equal(ids, req.ids)
                np.testing.assert_allclose(dist, req.distances, rtol=1e-6,
                                           atol=1e-9)
    for (g_ids, g_d), (w_ids, w_d) in zip(got, want):
        np.testing.assert_array_equal(g_ids, np.asarray(w_ids))
        w2 = np.asarray(w_d) ** 2
        assert np.all(np.abs(g_d ** 2 - w2) <= band(w2))


def test_saturated_queue_bound_and_request_log(setup, tmp_path):
    path, workload = setup
    svc = SearchService.from_store(path, ServeConfig(max_queue=8),
                                   device="cpu")
    with svc:
        result = run_saturated(svc, workload)
        # The tail past max_queue is rejected at submit, as documented.
        assert result.summary()["rejected_queue_full"] > 0
        assert result.served + result.summary()["rejected_queue_full"] \
            == len(workload)
        # The per-request log: one record per submitted request, the
        # rejected tail included with its status.
        log = tmp_path / "log.jsonl"
        logged = run_saturated(svc, workload, jsonl_path=log)
        recs = [json.loads(line) for line in log.read_text().splitlines()]
        assert [r["index"] for r in recs] == list(range(len(workload)))
        assert [r["status"] for r in recs] == logged.statuses
        assert all(r["n_answers"] == (req.ids.size if req.ids is not None
                                      else 0)
                   for r, req in zip(recs, logged.requests))


def test_load_ucr_and_benchmark_database(tmp_path, monkeypatch):
    path = tmp_path / "wafer_TRAIN.txt"
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((6, 20))
    with open(path, "w") as f:
        for i, r in enumerate(rows):
            sep = "," if i % 2 else " "
            f.write(f"{(-1) ** i}{sep}" + sep.join(repr(float(v)) for v in r)
                    + "\n\n")
    labels, series = tts.load_ucr(str(path))
    j_labels, j_series = jts.load_ucr(str(path))
    np.testing.assert_array_equal(labels, [1, -1, 1, -1, 1, -1])
    assert labels.dtype == np.int64 and series.dtype == np.float64
    np.testing.assert_array_equal(series, rows)
    np.testing.assert_array_equal(labels, j_labels)
    np.testing.assert_array_equal(series, j_series)
    # REPRO_UCR_PATH unset (or naming nothing): the synthetic stand-in.
    monkeypatch.delenv("REPRO_UCR_PATH", raising=False)
    db = tts.benchmark_database(64, seed=3)
    assert db.shape == (tts.WAFER_SIZE, 64)
    np.testing.assert_array_equal(db, tts.make_wafer_like(length=64, seed=3))
    np.testing.assert_array_equal(db, jts.benchmark_database(64, seed=3))
    monkeypatch.setenv("REPRO_UCR_PATH", str(tmp_path / "missing.txt"))
    np.testing.assert_array_equal(tts.benchmark_database(64, seed=3), db)
    monkeypatch.setenv("REPRO_UCR_PATH", str(path))
    z = tts.benchmark_database()
    np.testing.assert_array_equal(z, jts.benchmark_database())
    np.testing.assert_allclose(z.mean(axis=1), 0, atol=1e-12)
    assert tts.DEFAULT_LENGTH == jts.DEFAULT_LENGTH == 128
