"""The port's fault tolerance against the reference's, on the CPU.

``runtime/chaos.py`` must make the reference's decisions (the same
blake2b rolls, windows and first-match rule), so one ``FaultPlan`` fires
at the same invocations in both packages.  ``FailoverShards`` runs the
reference's scenarios — healthy parity, a transient fault healed by a
retry, a lost shard giving a certified-partial answer, down-marking and
probe revival, a hedged straggler, total loss — in both packages under
the same plans (the reference's engine needs no mesh, so it runs in this
process), and the ``ShardCoverage`` dicts, the chaos invocation counts
and the answer sets must be equal; the partial answers must equal an f64
brute force over the covered rows.  The serving layer (the circuit
breaker under ``serve_dispatch`` faults, degraded certificates on
requests, ``device_upload`` faults in both refresh paths, drain and
``/healthz``) and the store sites (``store_read``, ``verify_fetch``) are
held to the reference's behaviour.  Scenarios that count invocations
take a large ``slow_factor``, so no attempt is hedged on a busy machine.
"""
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core import dist_search as jds
from repro.core import engine as jeng
from repro.runtime import chaos as jchaos
from repro_torch.core import dist_search as ds
from repro_torch.core import engine as teng
from repro_torch.core.fastsax import FastSAXConfig, build_index
from repro_torch.core.options import SearchOptions
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.index import store as tstore
from repro_torch.index.mutable import MutableIndex
from repro_torch.obs.metrics import REQUIRED_FAMILIES, start_metrics_server
from repro_torch.runtime import chaos
from repro_torch.runtime.fault_tolerance import (PreemptionHandler,
                                                 StepWatchdog)
from repro_torch.serve import (FAILED, OK, REJECTED_SHED, SearchService,
                               ServeConfig)
from repro_torch.serve.batcher import BREAKER_CLOSED, BREAKER_OPEN

B, N, LEVELS, ALPHA, K = 64, 128, (4, 8), 8, 5
STEADY = dict(slow_factor=1e3)     # no watchdog hedge on a busy machine


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    chaos.uninstall()
    jchaos.uninstall()


@pytest.fixture(scope="module")
def db():
    return make_wafer_like(B, N, seed=0, normalize=False)


@pytest.fixture(scope="module")
def queries(db):
    return make_queries(db, 3, seed=1)


def engines(db, **kw):
    """The port's and the reference's failover engines, 4 shards each."""
    kw.setdefault("retries", 1)
    kw.setdefault("backoff_s", 0.001)
    return (ds.FailoverShards.from_series(db, 4, LEVELS, ALPHA,
                                          normalize=False, device="cpu",
                                          normalize_queries=False, **kw),
            jds.FailoverShards.from_series(db, 4, LEVELS, ALPHA,
                                           normalize=False,
                                           normalize_queries=False, **kw))


def query(eng, queries, eps=2.0, k=K):
    Q = queries.shape[0]
    is_knn = np.zeros(Q, dtype=bool)
    is_knn[-1] = True
    return eng.query(queries, np.full(Q, eps, np.float32), is_knn, k), is_knn


def sets(gidx, answer, d2, is_knn, k=K):
    out = []
    for i in range(gidx.shape[0]):
        if is_knn[i]:
            dd = np.asarray(d2[i])
            fin = np.isfinite(dd)
            order = np.lexsort((np.arange(dd.size), dd))
            out.append(np.asarray(gidx[i])[order[fin[order]][:k]].tolist())
        else:
            m = np.asarray(answer[i]) & np.isfinite(np.asarray(d2[i]))
            out.append(sorted(np.asarray(gidx[i])[m].tolist()))
    return out


def oracle(db, queries, rows, eps=2.0, k=K):
    d2 = ((queries[:, None, :].astype(np.float64)
           - db[None, rows, :].astype(np.float64)) ** 2).sum(-1)
    gids = np.asarray(rows)
    return [sorted(gids[d2[i] <= eps * eps].tolist()) if i < 2 else
            gids[np.argsort(d2[i], kind="stable")[:k]].tolist()
            for i in range(queries.shape[0])]


def under(mod, plan_specs, seed, fn):
    """Run ``fn()`` under a plan of ``mod`` (either package's chaos
    module); returns its result and the plan."""
    plan = mod.FaultPlan(seed=seed, specs=[mod.FaultSpec(**s)
                                           for s in plan_specs])
    with mod.injected(plan):
        return fn(), plan


def counts(plan, site):
    return {k: n for (s, k), n in plan._counts.items() if s == site}


# ---------------------------------------------------------------------------
# The harness: the reference's decisions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plan_decisions_equal_the_reference(seed):
    specs = [dict(site="s", key="a", start=2, stop=4),
             dict(site="s", mode="slow", p=0.5),
             dict(site="t", mode="truncate", p=0.3, frac=0.25)]
    got = []
    for mod in (chaos, jchaos):
        plan = mod.FaultPlan(seed=seed, specs=[mod.FaultSpec(**s)
                                               for s in specs])
        seq = []
        for i in range(48):
            site, key = ("s", "a") if i % 3 == 0 else (
                ("s", "b") if i % 3 == 1 else ("t", None))
            spec = plan.decide(site, key)
            seq.append(None if spec is None else (spec.mode, spec.key))
        seq.append((plan.invocations("s"), plan.invocations("s", "a"),
                    plan.fired_count("s"), plan.fired_count("t")))
        seq.append(plan._roll("s", "a", 5))
        got.append(seq)
    assert got[0] == got[1]


def test_harness_no_op_window_and_truncate():
    assert not chaos.active()
    a = np.arange(7)
    chaos.maybe_fire("anything", key="x")
    assert chaos.apply("anything", "x", a) is a
    plan = chaos.FaultPlan(seed=0, specs=[
        chaos.FaultSpec(site="s", mode="truncate", frac=0.5)])
    with chaos.injected(plan):
        assert chaos.active()
        assert chaos.apply("s", None, np.arange(10)).shape == (5,)
        with pytest.raises(chaos.FaultInjected, match="site='s'"):
            chaos.maybe_fire("s")
    assert not chaos.active()
    with pytest.raises(ValueError, match="unknown fault mode"):
        chaos.FaultSpec(site="s", mode="explode")
    with pytest.raises(ValueError, match="outside"):
        chaos.FaultSpec(site="s", p=2.0)


def test_watchdog_and_preemption_handler():
    events = []
    wd = StepWatchdog(slow_factor=2.0, window=8, min_samples=3,
                      on_slow=events.append)
    for step in range(4):
        wd.start(step)
        wd.stop()
    wd.start(9)
    time.sleep(0.05)
    wd.stop()
    assert [e.step for e in events] == [9] and wd.events == events
    import os
    import signal
    with PreemptionHandler() as ph:
        assert not ph.preempted
        os.kill(os.getpid(), signal.SIGTERM)
        assert ph.requested.wait(5.0) and ph.preempted
    assert signal.getsignal(signal.SIGTERM) is not None


# ---------------------------------------------------------------------------
# Failover shards, both packages under the same plans.
# ---------------------------------------------------------------------------


def test_failover_healthy_parity(db, queries):
    mine, theirs = engines(db, **STEADY)
    (got, is_knn) = query(mine, queries)
    (want, _) = query(theirs, queries)
    for e in (mine, theirs):
        e.close()
    assert got[4].as_dict() == want[4].as_dict()
    assert got[4].exact and got[4].rows_ok == B
    assert sets(*got[:3], is_knn) == sets(*want[:3], is_knn) == \
        oracle(db, queries, np.arange(B))
    # The same engine as the single index: exact d² per id.
    single = teng.build_device_index(db, LEVELS, ALPHA, normalize=False,
                                     device="cpu")
    qr = teng.represent_queries(torch.as_tensor(queries), LEVELS, ALPHA,
                                normalize=False)
    ridx, rans, rd2, _ = teng.mixed_query_auto(
        single, qr, np.full(3, 2.0, np.float32), is_knn, K, capacity=B)
    assert sets(*got[:3], is_knn) == sets(ridx.numpy(), rans.numpy(),
                                          rd2.numpy(), is_knn)


@pytest.mark.parametrize("scenario", ["transient", "lost", "total"])
def test_failover_fault_scenarios_match_reference(db, queries, scenario):
    specs = {"transient": [dict(site="shard_query", key="2", start=0,
                                stop=1)],
             "lost": [dict(site="shard_query", key="1")],
             "total": [dict(site="shard_query")]}[scenario]
    mine, theirs = engines(db, retries=2 if scenario == "transient" else 1,
                           **STEADY)

    def run(eng):
        def fn():
            try:
                (out, is_knn) = query(eng, queries)
            except (ds.FailoverError, jds.FailoverError) as e:
                return type(e).__name__
            return out[4].as_dict(), sets(*out[:3], is_knn)
        return fn

    g, gplan = under(chaos, specs, 5, run(mine))
    w, wplan = under(jchaos, specs, 5, run(theirs))
    assert counts(gplan, "shard_query") == counts(wplan, "shard_query")
    assert dict(mine.events) == dict(theirs.events)
    assert mine.shard_states() == theirs.shard_states()
    if scenario == "total":
        assert g == w == "FailoverError"
        return
    assert g == w
    cov, answers = g
    if scenario == "transient":
        assert cov["exact"] and mine.events["retries"] >= 1
        assert answers == oracle(db, queries, np.arange(B))
    else:
        per = B // 4
        assert (cov["shards_ok"], cov["rows_ok"]) == (3, B - per)
        survivors = np.r_[np.arange(0, per), np.arange(2 * per, B)]
        assert answers == oracle(db, queries, survivors)
        (again, _) = query(mine, queries)
        assert again[4].exact and again[4].rows_ok == B
    mine.close()
    theirs.close()


def test_failover_down_marking_and_probe_revival(db, queries):
    kw = dict(retries=0, down_threshold=2, probe_every=2, **STEADY)
    mine, theirs = engines(db, **kw)
    trail = []
    for eng, mod in ((mine, chaos), (theirs, jchaos)):
        plan = mod.FaultPlan(seed=5, specs=[
            mod.FaultSpec(site="shard_query", key="3")])
        states = []
        with mod.injected(plan):
            for _ in range(3):
                (out, _) = query(eng, queries)
                states.append((out[4].as_dict(), eng.shard_states()))
        for _ in range(4):
            (out, _) = query(eng, queries)
            states.append((out[4].as_dict(), eng.shard_states()))
        trail.append((states, counts(plan, "shard_query"),
                       dict(eng.events)))
        eng.close()
    assert trail[0] == trail[1]
    states = trail[0][0]
    assert states[2][1][3] == "down" and trail[0][2]["shard_down"] == 1
    assert states[-1][1] == ["up"] * 4 and states[-1][0]["exact"]


def test_failover_straggler_is_hedged(db, queries):
    mine, _ = engines(db, retries=1, timeout_s=0.15)
    query(mine, queries)
    plan = chaos.FaultPlan(seed=5, specs=[
        chaos.FaultSpec(site="shard_query", key="0", mode="slow",
                        delay_s=3.0)])
    t0 = time.perf_counter()
    with chaos.injected(plan):
        (out, _) = query(mine, queries)
    dt = time.perf_counter() - t0
    mine.close()
    assert not out[4].exact and out[4].shards_ok == 3
    assert mine.events["hedges"] >= 1
    assert dt < 2.5, "the dispatch must not wait out a 3 s straggler"


def test_failover_close_waits_for_a_hedged_straggler(db, queries):
    """``close(wait=True)`` returns only after the hedged-away attempt
    has slept out its delay and run: no shard query outlives it."""
    earlier = set(threading.enumerate())
    mine, _ = engines(db, retries=1, timeout_s=0.15)
    query(mine, queries)
    plan = chaos.FaultPlan(seed=5, specs=[
        chaos.FaultSpec(site="shard_query", key="0", mode="slow",
                        delay_s=1.0, start=0, stop=1)])
    t0 = time.perf_counter()
    with chaos.injected(plan):
        query(mine, queries)
        assert mine.events["hedges"] >= 1
        assert time.perf_counter() - t0 < 1.0
        mine.close(wait=True)
    assert time.perf_counter() - t0 >= 1.0
    assert not [t for t in set(threading.enumerate()) - earlier
                if t.name.startswith("repro-torch-failover")]


def test_failover_from_port_store_in_both_packages(tmp_path, db, queries):
    from repro.core.paa import znormalize_np

    mesh = ds.make_data_mesh(4, device="cpu")
    padded, n_valid = ds.pad_database(db, 4)
    index = ds.distributed_build(padded, LEVELS, ALPHA, mesh, n_valid=n_valid)
    ds.store_sharded(index, tmp_path / "idx", n_valid=n_valid)
    mine = ds.FailoverShards.from_store(tmp_path / "idx", device="cpu",
                                        normalize_queries=True, **STEADY)
    theirs = jds.FailoverShards.from_store(tmp_path / "idx",
                                           normalize_queries=True, **STEADY)
    got, is_knn = query(mine, queries)
    want, _ = query(theirs, queries)
    mine.close()
    theirs.close()
    assert got[4].as_dict() == want[4].as_dict()
    assert got[4].exact and got[4].rows_total == B
    assert sets(*got[:3], is_knn) == sets(*want[:3], is_knn) == oracle(
        znormalize_np(db), znormalize_np(queries), np.arange(B))


def test_shard_coverage_dict_shape():
    cov = ds.ShardCoverage(shards_ok=2, shards_total=4, rows_ok=10,
                           rows_total=20)
    assert cov.as_dict() == jds.ShardCoverage(2, 4, 10, 20).as_dict()
    assert not cov.exact


# ---------------------------------------------------------------------------
# Tiered shards: verify-fetch faults and quantized stores.
# ---------------------------------------------------------------------------


def tiered(rows, mode="int8"):
    host = build_index(rows, FastSAXConfig(n_segments=LEVELS, alphabet=ALPHA),
                       normalize=False)
    return teng.TieredIndex.from_host(host, mode, device="cpu")


def test_verify_fetch_truncation_is_loud_and_slow_is_exact(db, queries):
    # The port fetches only the screen's survivors (the reference all
    # Q·C slots), so the radius keeps some: a torn fetch of them is loud.
    tix = tiered(db)
    qr = teng.represent_queries(torch.as_tensor(queries), LEVELS, ALPHA,
                                normalize=False)
    eps = 12.0
    base = teng.quantized_range_query(tix, qr, eps)
    assert int(base[1].sum()) > 0
    for opts in (SearchOptions(), SearchOptions(verify_prefetch=True)):
        plan = chaos.FaultPlan(seed=5, specs=[
            chaos.FaultSpec(site="verify_fetch", mode="truncate",
                            frac=0.5)])
        with chaos.injected(plan):
            with pytest.raises(IOError, match="truncated raw-tier read"):
                teng.quantized_range_query(tix, qr, eps, options=opts)
    plan = chaos.FaultPlan(seed=5, specs=[
        chaos.FaultSpec(site="verify_fetch", mode="slow", delay_s=0.01)])
    with chaos.injected(plan):
        got = teng.quantized_range_query(
            tix, qr, eps, options=SearchOptions(verify_prefetch=True))
    assert all(torch.equal(x, y) for x, y in zip(base, got))
    assert counts(plan, "verify_fetch") == {"0": 1, "1": 1}


def test_verify_fetch_counts_equal_the_reference(db, queries):
    # The same tiered query in both packages fires the site under the
    # same keys, synchronously and prefetched.
    host = build_index(db, FastSAXConfig(n_segments=LEVELS, alphabet=ALPHA),
                       normalize=False)
    from repro.core.fastsax import FastSAXConfig as JConfig
    from repro.core.fastsax import build_index as jbuild
    jtix = jeng.TieredIndex.from_host(
        jbuild(db, JConfig(n_segments=LEVELS, alphabet=ALPHA),
               normalize=False), "int8")
    tix = teng.TieredIndex.from_host(host, "int8", device="cpu")
    tqr = teng.represent_queries(torch.as_tensor(queries), LEVELS, ALPHA,
                                 normalize=False)
    jqr = jeng.represent_queries(jnp.asarray(queries), LEVELS, ALPHA,
                                 normalize=False)
    from repro.core.options import SearchOptions as JOptions
    for prefetch in (False, True):
        plans = []
        for mod, fn in ((chaos, lambda: teng.quantized_knn_query(
                tix, tqr, K, options=SearchOptions(
                    verify_prefetch=prefetch))),
                        (jchaos, lambda: jeng.quantized_knn_query(
                            jtix, jqr, K, options=JOptions(
                                verify_prefetch=prefetch)))):
            plan = mod.FaultPlan(seed=0)
            with mod.injected(plan):
                fn()
            plans.append(counts(plan, "verify_fetch"))
        assert plans[0] == plans[1] and plans[0]


def test_failover_tiered_verify_fault_degrades(db, queries):
    parts = np.array_split(db, 4)
    offsets = list(np.cumsum([0] + [p.shape[0] for p in parts[:-1]]))
    eng = ds.FailoverShards([tiered(p) for p in parts], offsets=offsets,
                            n_valid=B, retries=0, backoff_s=0.001,
                            normalize_queries=False, **STEADY)
    (out, is_knn) = query(eng, queries)
    assert out[4].exact and sets(*out[:3], is_knn) == oracle(
        db, queries, np.arange(B))
    plan = chaos.FaultPlan(seed=5, specs=[
        chaos.FaultSpec(site="verify_fetch", start=0, stop=1)])
    with chaos.injected(plan):
        (out, is_knn) = query(eng, queries)
    eng.close()
    assert not out[4].exact and out[4].shards_ok == 3
    truth = oracle(db, queries, np.arange(B))
    for i in range(2):
        assert set(sets(*out[:3], is_knn)[i]) <= set(truth[i])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_failover_warm_start_from_tiered_store(tmp_path, db, queries, mode):
    mesh = ds.make_data_mesh(4, device="cpu")
    dti = ds.distributed_tiered_index(tiered(db, mode), mesh)
    ds.store_sharded_tiered(dti, tmp_path / "tier")
    eng = ds.FailoverShards.from_store(tmp_path / "tier", device="cpu",
                                       retries=1, backoff_s=0.001,
                                       normalize_queries=False, **STEADY)
    theirs = jds.FailoverShards.from_store(tmp_path / "tier", retries=1,
                                           backoff_s=0.001,
                                           normalize_queries=False,
                                           **STEADY)
    assert all(hasattr(s, "dev") for s in eng.shards)
    got, is_knn = query(eng, queries)
    want, _ = query(theirs, queries)
    eng.close()
    theirs.close()
    assert got[4].as_dict() == want[4].as_dict() and got[4].exact
    assert sets(*got[:3], is_knn) == sets(*want[:3], is_knn) == oracle(
        db, queries, np.arange(B))


# ---------------------------------------------------------------------------
# Store reads.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,reader", [("series", "load_index"),
                                        ("qnorms", "load_quantized")])
def test_store_read_faults_are_loud(tmp_path, db, key, reader):
    host = build_index(db, FastSAXConfig(n_segments=LEVELS, alphabet=ALPHA),
                       normalize=False)
    path = tstore.save_index(host, tmp_path / "store", quantization="int8")
    load = getattr(tstore, reader)
    plan = chaos.FaultPlan(seed=5, specs=[
        chaos.FaultSpec(site="store_read", key=key, mode="truncate",
                        frac=0.5)])
    with chaos.injected(plan):
        with pytest.raises(IOError, match="does not match manifest"):
            load(path)
    plan = chaos.FaultPlan(seed=5, specs=[
        chaos.FaultSpec(site="store_read", key=key)])
    with chaos.injected(plan):
        with pytest.raises(chaos.FaultInjected):
            load(path)
    assert load(path) is not None


# ---------------------------------------------------------------------------
# The serving layer.
# ---------------------------------------------------------------------------


def one_request(svc, q, k=1):
    req = svc.submit_knn(q, k)
    try:
        req.wait(30.0)
    except Exception:   # noqa: BLE001 — FAILED re-raises by contract
        pass
    return req


def small_cfg(**kw):
    return ServeConfig(max_batch=4, max_wait_ms=0.5, levels=LEVELS,
                       alphabet=ALPHA, normalize_queries=False, **kw)


def test_breaker_sheds_under_dispatch_faults_as_the_reference(db):
    q = db[3] + 0.01
    trails = []
    for make, mod in ((lambda c: SearchService.from_series(
            db, c, normalize=False, device="cpu"), chaos),
                      (lambda c: jserve.SearchService.from_series(
                          db, jserve.ServeConfig(**{
                              f: getattr(c, f) for f in (
                                  "max_batch", "max_wait_ms", "levels",
                                  "alphabet", "normalize_queries",
                                  "breaker_threshold", "breaker_cooldown")},
                              backend="xla"), normalize=False), jchaos)):
        svc = make(small_cfg(breaker_threshold=2, breaker_cooldown=3))
        svc.warmup(qs=(1,), ks=(5,))
        plan = mod.FaultPlan(seed=7, specs=[
            mod.FaultSpec(site="serve_dispatch")])
        with svc:
            with mod.injected(plan):
                statuses = [one_request(svc, q).status for _ in range(8)]
            recovered = []
            for _ in range(6):
                recovered.append(one_request(svc, q).status)
                if recovered[-1] == OK:
                    break
            snap = svc.stats.snapshot()
        trails.append((statuses, recovered, snap["breaker_state"],
                       snap["rejected_shed"],
                       plan.invocations("serve_dispatch")))
    assert trails[0] == trails[1]
    statuses = trails[0][0]
    assert statuses[:2] == [FAILED, FAILED]
    assert statuses[2:5] == [REJECTED_SHED] * 3 and statuses[5] == FAILED
    assert trails[0][1][-1] == OK and trails[0][2] == BREAKER_CLOSED


def test_service_failover_degraded_certificate(db):
    q = db[3] + 0.01
    cfg = small_cfg(failover_shards=4, shard_retries=1,
                    shard_backoff_s=0.001)
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    assert svc.backend.engine.n_shards == 4
    with svc:
        req = one_request(svc, q)
        assert req.status == OK and req.exact and \
            req.coverage["rows_ok"] == B
        plan = chaos.FaultPlan(seed=5, specs=[
            chaos.FaultSpec(site="shard_query", key="1")])
        with chaos.injected(plan):
            req = one_request(svc, q)
        assert req.status == OK and not req.exact
        assert req.coverage == {"exact": False, "shards_ok": 3,
                                "shards_total": 4, "rows_ok": B - B // 4,
                                "rows_total": B}
        assert svc.health()[1]["coverage"]["shards_ok"] == 3
        req = one_request(svc, q)
        assert req.status == OK and req.exact
    snap = svc.stats.snapshot()
    assert snap["events"]["degraded"] == 1 and snap["events"]["retries"] >= 1


@pytest.mark.parametrize("name,value", [("shard_timeout_s", 5.0),
                                        ("shard_retries", 0),
                                        ("shard_backoff_s", 0.1)])
def test_shard_settings_reach_the_engine(db, name, value):
    svc = SearchService.from_series(
        db, small_cfg(failover_shards=2, **{name: value}), normalize=False,
        device="cpu")
    eng = svc.backend.engine
    got = {"shard_timeout_s": eng.timeout_s, "shard_retries": eng.retries,
           "shard_backoff_s": eng.backoff_s}[name]
    assert got == value
    eng.close()


def test_quantized_failover_from_series_is_refused(db):
    with pytest.raises(ValueError, match="full-precision"):
        SearchService.from_series(db, ServeConfig(failover_shards=2,
                                                  quantization="int8"),
                                  device="cpu")


@pytest.mark.parametrize("async_refresh", [False, True])
def test_device_upload_fault_keeps_serving(tmp_path, db, async_refresh):
    root = tmp_path / "idx"
    MutableIndex.create(root, db[:48], FastSAXConfig(n_segments=LEVELS,
                                                     alphabet=ALPHA))
    svc = SearchService.from_store(
        root, ServeConfig(max_batch=8, max_wait_ms=1.0, levels=LEVELS,
                          alphabet=ALPHA, async_refresh=async_refresh),
        device="cpu")
    with svc:
        ids = svc.insert(db[48:50])
        plan = chaos.FaultPlan(seed=5, specs=[
            chaos.FaultSpec(site="device_upload")])
        with chaos.injected(plan):
            if async_refresh:
                deadline = time.perf_counter() + 20.0
                while (svc.stats.snapshot()["events"]["refresh_failures"]
                       == 0 and time.perf_counter() < deadline):
                    svc.knn(db[3], 1)          # each batch kicks a swap
                    time.sleep(0.02)
            else:
                with pytest.raises(chaos.FaultInjected):
                    svc.refresh()
        assert plan.invocations("device_upload") >= 1
        assert svc.stats.snapshot()["events"]["refresh_failures"] >= 1
        assert svc._stale and svc.knn(db[3], 1)[0].size == 1
        svc.refresh()
        assert svc.knn(db[48], 1)[0][0] == ids[0]
        assert svc.stats.snapshot()["events"]["refresh_swaps"] >= 1


def test_healthz_readiness_drain_and_404(db):
    svc = SearchService.from_series(db, small_cfg(), normalize=False,
                                    device="cpu")
    server = start_metrics_server(svc.metrics_text, 0, health_fn=svc.health)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/healthz")
        assert ei.value.code == 503, "not started -> not ready"
        svc.start()
        assert urllib.request.urlopen(url + "/healthz").status == 200
        body = urllib.request.urlopen(url + "/metrics").read().decode()
        for fam in REQUIRED_FAMILIES:
            assert f"# TYPE {fam} " in body
        assert one_request(svc, db[3] + 0.01).status == OK
        assert svc.drain(timeout_s=10.0) is True
        ready, detail = svc.health()
        assert not ready and detail["draining"]
        assert detail["breaker"] == BREAKER_CLOSED and "coverage" not in detail
        assert svc.submit_knn(db[3], 1).status in (REJECTED_SHED, FAILED)
    finally:
        server.shutdown()
        server.server_close()
    bare = start_metrics_server(lambda: "", 0)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{bare.server_address[1]}/healthz")
        assert ei.value.code == 404
    finally:
        bare.shutdown()
        bare.server_close()
    assert BREAKER_OPEN == "open"


def test_launcher_failover_service_and_health(capsys):
    from repro_torch.launch import serve as launch

    summary = launch.main(["--serve", "--device", "cpu", "--db-size", "300",
                           "--failover-shards", "3", "--bench-requests",
                           "16", "--clients", "4", "--verify-exact",
                           "--metrics", "0"])
    out = capsys.readouterr().out
    assert "3 failover shards" in out and "/healthz" in out
    assert summary["served"] == 16 and summary["exact_mismatches"] == 0
