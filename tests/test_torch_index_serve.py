"""Warm starts and live ingest of the port's services, against the reference.

Stores written by either package warm-start ``repro_torch``'s
``SearchService.from_store`` on the CPU (the torch engine, and the fused
engine running the kernels' plain versions): a plain store, one with an
int8 tier, and a ``MutableIndex`` root with a delta and tombstones.  The
same workload through ``repro``'s ``from_store`` (``backend="xla"``) must
give the same answers: ids equal, d² within 1e-3 + 1e-5·d² (the engine
tests' band).  Then live ingest (a port of ``tests/test_serve.py::
test_live_ingest_refresh``), the background swap under requests in flight,
the subsequence store, the index CLI and the launcher's ``--index-dir``.
"""
import json
import sys
import threading
import time

import numpy as np
import pytest

import repro.serve as jserve
from repro.core.fastsax import FastSAXConfig as JConfig
from repro.core.fastsax import build_index as jbuild
from repro.core.subseq import build_subseq_index as jbuild_subseq
from repro.core.subseq import load_subseq_index as jload_subseq
from repro.core.subseq import save_subseq_index as jsave_subseq
from repro.index import store as jstore
from repro_torch.core import subseq as tss
from repro_torch.core.fastsax import FastSAXConfig
from repro_torch.data.timeseries import (make_queries, make_subseq_queries,
                                         make_wafer_like)
from repro_torch.index import cli
from repro_torch.index.mutable import MutableIndex
from repro_torch.serve import (OK, SearchService, ServeConfig,
                               SubseqSearchService, WorkloadSpec,
                               check_exactness, make_workload,
                               run_closed_loop)

B, N = 400, 128
LEVELS = (8, 16)
KINDS = ("plain", "int8", "mutable")


@pytest.fixture(scope="module")
def db():
    return make_wafer_like(B + 64, N, seed=0, normalize=False)


@pytest.fixture(scope="module")
def stores(db, tmp_path_factory):
    """A plain and an int8 store written by the reference, and a root
    written by the port with a delta and three tombstones (one in the
    delta), so its positions are not its ids."""
    d = tmp_path_factory.mktemp("stores")
    host = jbuild(db[:B], JConfig(n_segments=LEVELS, alphabet=10))
    jstore.save_index(host, d / "plain")
    jstore.save_index(host, d / "int8", quantization="int8")
    mi = MutableIndex.create(d / "mutable", db[:B],
                             FastSAXConfig(n_segments=LEVELS, alphabet=10))
    ids = mi.insert(db[B:B + 32])
    mi.delete([3, 100, int(ids[5])])
    return {k: d / k for k in KINDS}


@pytest.fixture(scope="module")
def workload(db):
    qs = make_queries(db[:B], 12, seed=1)
    return make_workload(qs, WorkloadSpec(n_requests=32, knn_frac=0.5, k=5,
                                          epsilon=2.0, seed=3))


def cfg_of(kind, **kw):
    return dict(max_batch=16, max_wait_ms=1.0,
                quantization="int8" if kind == "int8" else "none", **kw)


@pytest.fixture(scope="module")
def reference(stores, workload):
    out = {}
    for kind in KINDS:
        svc = jserve.SearchService.from_store(
            stores[kind], jserve.ServeConfig(backend="xla", **cfg_of(kind)))
        with svc:
            out[kind] = jserve.run_closed_loop(svc, workload, clients=8)
    return out


def serve(svc, workload):
    with svc:
        result = run_closed_loop(svc, workload, clients=8)
        assert check_exactness(svc, workload, result) == 0
    assert result.served == len(workload)
    return result


def assert_same_answers(workload, got, want):
    n_answers = 0
    for (kind, _q, _e, k), g, w in zip(workload, got.requests, want.requests):
        assert w.status == OK
        np.testing.assert_array_equal(g.ids, w.ids)
        d2g, d2w = g.distances ** 2, w.distances ** 2
        assert np.all(np.abs(d2g - d2w) <= 1e-3 + 1e-5 * d2w)
        if kind == "knn":
            assert g.ids.size == k
        n_answers += g.ids.size
    assert n_answers > len(workload)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("kind", KINDS)
def test_warm_start_matches_reference(stores, workload, reference, kind,
                                      backend):
    svc = SearchService.from_store(
        stores[kind], ServeConfig(backend=backend, **cfg_of(kind)),
        device="cpu")
    assert svc.backend.backend == backend
    assert (svc.mutable is not None) == (kind == "mutable")
    result = serve(svc, workload)
    assert_same_answers(workload, result, reference[kind])
    if kind == "mutable":
        # Answers are external ids: the tombstoned ones never appear, and
        # ids past the base are the delta's.
        got = np.concatenate([r.ids for r in result.requests])
        assert not np.isin(got, [3, 100, B + 5]).any()
        assert svc.backend.size == B + 32 - 3


def test_warm_start_refusals(stores, db, tmp_path):
    # Both sharded store kinds warm-start now (with or without a mesh,
    # through failover shards too), with the plain store's answers; the
    # refusals left are the reference's own.
    from repro_torch.core import dist_search as ds
    from repro_torch.core import engine as teng

    mesh = ds.make_data_mesh(3, device="cpu")
    padded, nv = ds.pad_database(db[:B], 3)
    ds.store_sharded(ds.distributed_build(padded, LEVELS, 10, mesh,
                                          n_valid=nv),
                     tmp_path / "fastsax-index-sharded", n_valid=nv)
    ds.store_sharded_tiered(ds.distributed_tiered_index(
        teng.TieredIndex.from_host(host_index(db[:B]), "int8",
                                   device="cpu"), mesh),
        tmp_path / "fastsax-tiered-sharded")
    plain = SearchService.from_store(stores["plain"], device="cpu")
    q = make_queries(db, 1, seed=8)[0]
    want = plain.direct_query("knn", q, k=5)[0]
    for kind in ("fastsax-index-sharded", "fastsax-tiered-sharded"):
        manifest = jstore.read_manifest(tmp_path / kind)
        assert manifest["kind"] == kind
        for kw in ({}, {"mesh": mesh}):
            svc = SearchService.from_store(tmp_path / kind, device="cpu",
                                           **kw)
            np.testing.assert_array_equal(
                svc.direct_query("knn", q, k=5)[0], want)
        svc = SearchService.from_store(
            tmp_path / kind, ServeConfig(failover_shards=3), device="cpu")
        np.testing.assert_array_equal(svc.direct_query("knn", q, k=5)[0],
                                      want)
        svc.backend.engine.close()
    with pytest.raises(ValueError, match="quantized serving"):
        SearchService.from_store(tmp_path / "fastsax-index-sharded",
                                 ServeConfig(quantization="int8"),
                                 device="cpu")
    svc = SearchService.from_store(stores["plain"], mesh=mesh, device="cpu")
    with pytest.raises(RuntimeError, match="MutableIndex"):
        svc.insert(np.zeros((1, N)))


def host_index(rows):
    from repro_torch.core.fastsax import build_index

    return build_index(rows, FastSAXConfig(n_segments=LEVELS, alphabet=10))


def _mutable_service(tmp_path, db, rows=256, **kw):
    root = tmp_path / "idx"
    MutableIndex.create(root, db[:rows],
                        FastSAXConfig(n_segments=LEVELS, alphabet=10))
    return SearchService.from_store(
        root, ServeConfig(max_batch=8, max_wait_ms=1.0, **kw), device="cpu")


def test_live_ingest_refresh(tmp_path, db):
    svc = _mutable_service(tmp_path, db)
    assert svc.mutable is not None and svc.generation == 0
    with svc:
        new_rows = db[256:260]
        ids = svc.insert(new_rows)
        assert svc._stale, "the commit hook must mark the device copy stale"
        svc.refresh()
        assert svc.generation == 1 and not svc._stale
        for row, ext_id in zip(new_rows, ids):
            got_ids, got_d = svc.knn(row, 1)
            assert got_ids[0] == ext_id and got_d[0] < 0.05
        svc.delete([int(ids[0])])
        svc.refresh()
        got_ids, _ = svc.knn(new_rows[0], 1)
        assert got_ids[0] != ids[0]
        # Served answers equal the host engine's over the live rows.
        ref_ids, _ = svc.mutable.knn_query(new_rows[1], 3)
        got_ids, _ = svc.knn(new_rows[1], 3)
        assert np.array_equal(np.sort(ref_ids), np.sort(got_ids))
        snap = svc.stats.snapshot()["events"]
        assert snap["refresh_swaps"] == 2 and snap["refresh_failures"] == 0


@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_background_swap_under_requests_in_flight(tmp_path, db,
                                                  quantization):
    """Inserts and a delete land by background swaps while 16 clients
    keep requests in flight (a short switch interval shakes the threads).
    Every answer, from whichever generation served it, reports the true
    distance of the row its external id names (a batch whose positions
    were mapped through another generation's ids would not), and every
    request submitted after the last install replays exactly."""
    from repro_torch.core.paa import znormalize_np

    svc = _mutable_service(tmp_path, db, quantization=quantization)
    qs = make_queries(db[:256], 16, seed=4)
    workload = make_workload(qs, WorkloadSpec(n_requests=48, knn_frac=0.5,
                                              k=3, epsilon=2.0, seed=5))
    rows = znormalize_np(db[:416])        # row of external id i (i < 256)
    row_of = dict(enumerate(rows[:256]))

    def ingest():
        for j, lo in enumerate(range(400, 416, 4)):
            ids = svc.insert(db[lo:lo + 4])
            row_of.update(zip(ids.tolist(), rows[lo:lo + 4]))
            if j == 1:
                svc.delete([0, 7, int(ids[0])])
            time.sleep(0.01)

    served = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with svc:
            inserter = threading.Thread(target=ingest)
            inserter.start()
            deadline = time.perf_counter() + 120.0
            while (inserter.is_alive() or svc.generation < 5 or not served
                   or served[-1][0] <= svc._last_refresh):
                assert time.perf_counter() < deadline, "no swap landed"
                served.append((time.perf_counter(),
                               run_closed_loop(svc, workload, clients=16)))
            inserter.join(timeout=30)
            assert not inserter.is_alive()
            swap_t = svc._last_refresh
            after = [(w, r) for _, res in served
                     for w, r in zip(workload, res.requests)
                     if r.t_submit > swap_t]
            assert after and all(r.status == OK for _, r in after)
            for (kind, q, eps, k), req in after:
                ids, dist = svc.direct_query(kind, q, epsilon=eps, k=k)
                assert np.array_equal(ids, req.ids)
                np.testing.assert_allclose(dist, req.distances, rtol=1e-6,
                                           atol=1e-9)
            got, _ = svc.knn(db[400], 1)
            assert got[0] == 256                 # the first inserted id
    finally:
        sys.setswitchinterval(switch)
    for _, res in served:
        for (kind, q, eps, k), req in zip(workload, res.requests):
            assert req.status == OK
            qz = znormalize_np(np.asarray(q, np.float32).astype(np.float64))
            true = np.array([((row_of[i] - qz) ** 2).sum() for i in req.ids])
            d2 = req.distances ** 2
            assert np.all(np.abs(true - d2) <= 1e-3 + 1e-5 * true)
    events = svc.stats.snapshot()["events"]
    assert events["refresh_swaps"] >= 1 and events["refresh_failures"] == 0
    assert svc.generation == svc.mutable.generation == 5


def test_subseq_store_cross_loads_and_serves(tmp_path):
    streams = make_wafer_like(3, 700, seed=0, normalize=False)
    jh = jbuild_subseq(streams, JConfig(n_segments=LEVELS), 64, 4)
    th = tss.build_subseq_index(streams, FastSAXConfig(n_segments=LEVELS),
                                64, 4)
    jsave_subseq(jh, tmp_path / "ref")
    tss.save_subseq_index(th, tmp_path / "port")
    for name in sorted(p.name for p in (tmp_path / "ref").iterdir()):
        a = (tmp_path / "ref" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        if name.startswith("resid_"):
            # The port's window residuals agree with the reference's to
            # f64 rounding (test_torch_subseq.py); compared as arrays.
            np.testing.assert_allclose(np.load(tmp_path / "ref" / name),
                                       np.load(tmp_path / "port" / name),
                                       rtol=1e-12, atol=1e-12)
        elif name != "manifest.json":
            assert a == b, name
    for writer in ("ref", "port"):
        mine = tss.load_subseq_index(tmp_path / writer)
        theirs = jload_subseq(tmp_path / writer)
        assert (mine.window, mine.stride, mine.n_windows) == \
            (theirs.window, theirs.stride, theirs.n_windows)
        for f in ("streams", "mu", "sd"):
            assert np.array_equal(getattr(mine, f), getattr(theirs, f))
        for x, y in zip(mine.levels, theirs.levels):
            assert np.array_equal(x.words, y.words)
            assert np.array_equal(x.residuals, y.residuals)
    jstore.save_index(jbuild(streams[:, :64], JConfig(n_segments=LEVELS)),
                      tmp_path / "plain")
    with pytest.raises(IOError, match="not a subsequence store"):
        tss.load_subseq_index(tmp_path / "plain")
    # The warm-started service answers as the cold-built one does.
    cfg = ServeConfig(max_batch=8, max_wait_ms=1.0)
    warm = SubseqSearchService.from_store(tmp_path / "ref", cfg, excl=16,
                                          device="cpu")
    cold = SubseqSearchService.from_streams(streams, 64, 4, cfg, excl=16,
                                            device="cpu")
    queries = make_subseq_queries(streams, 4, 64, seed=1)
    with warm:
        for q in queries:
            for got, want in ((warm.subseq_range(q, 3.0),
                               cold.direct_subseq_range(q, 3.0)),
                              (warm.subseq_knn(q, 3),
                               cold.direct_subseq_knn(q, 3))):
                assert np.array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
            ids, _ = warm.subseq_knn(q, 3)
            assert np.array_equal(ids, warm.direct_subseq_knn(q, 3)[0])


def test_cli_round_trip(tmp_path, capsys):
    d = str(tmp_path / "cli_idx")

    def info(*extra):
        capsys.readouterr()
        cli.main(["info", "--dir", d, *extra])
        return json.loads(capsys.readouterr().out)

    cli.main(["build", "--dir", d, "--db-size", "128", "--length", "64",
              "--levels", "4,8", "--alphabet", "8", "--quantization",
              "int8"])
    first = info()
    assert first["live"] == 128 and first["gen"] == 0
    assert first["stack"]["quantization"] == "int8"
    cli.main(["insert", "--dir", d, "--db-size", "32", "--length", "64"])
    cli.main(["delete", "--dir", d, "--ids", "0,5,130"])
    cli.main(["compact", "--dir", d])
    cli.main(["verify", "--dir", d])
    assert "checksums OK" in capsys.readouterr().out
    final = info("--stats", "--stats-queries", "4")
    assert final["live"] == 157 and final["n_deltas"] == 0
    assert final["tombstoned"] == 0 and final["next_id"] == 160
    assert final["stats"]["queries"] == 4 and final["stats"]["rows"] == 157
    with pytest.raises(SystemExit):
        cli.main(["delete", "--dir", d, "--ids", "999"])
    # The reference opens what the port's CLI wrote, and serves it.
    from repro.index.mutable import MutableIndex as JMutable
    assert JMutable.open(d).info()["live"] == 157


def test_launcher_warm_start_on_cpu(stores, capsys):
    from repro_torch.launch.serve import main

    for kind, live in (("mutable", "on"), ("plain", "off")):
        summary = main(["--serve", "--device", "cpu", "--index-dir",
                        str(stores[kind]), "--bench-requests", "12",
                        "--clients", "4", "--verify-exact"])
        out = capsys.readouterr().out
        assert f"(live ingest: {live})" in out and "[serve] warm start:" in out
        assert summary["served"] == 12 and summary["exact_mismatches"] == 0
