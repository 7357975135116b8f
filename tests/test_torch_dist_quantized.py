"""The port's sharded quantized tier against the reference's, on the CPU.

The reference's ``dist_search.distributed_tiered_index`` and its range /
k-NN / mixed queries run once per module in a subprocess with
``--xla_force_host_platform_device_count=4``; they write their answers,
their ``verify_fetch`` chaos invocation counts and their tiered sharded
stores.  The port runs the same calls on ``make_data_mesh(P,
device="cpu")`` over the same host index (the host build and the
quantization are bit-identical in both packages): int8 at P ∈ {1, 3, 4},
bf16 at P = 4, and a mostly-padding split (300 rows over 4 shards of 128).
Each shard screens with kernel 5's plain version (``cuda``) or the torch
oracle (``torch``).

Held to the reference: range answer sets equal, k-NN ids equal, d² within
1e-5·(1 + d²), exact certificates, the same ``verify_fetch`` invocation
counts (synchronous and prefetched), stores byte-identical and
cross-loading both ways; the served answers through the distributed
tiered backend and tiered failover shards against an f64 brute force.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.index import sharded as jsharded
from repro_torch.core import dist_search as ds
from repro_torch.core import engine as teng
from repro_torch.core.fastsax import FastSAXConfig, build_index
from repro_torch.core.options import SearchOptions
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.index import quantized as tq
from repro_torch.index import sharded as tsharded
from repro_torch.runtime import chaos
from repro_torch.serve import SearchService, ServeConfig
from repro_torch.serve.service import _DistQuantizedBackend, _FailoverBackend

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, N, LEVELS, ALPHA, K, EPS = 1003, 128, (8, 16), 10, 5, 2.0
IS_KNN = np.array([True, False, True, False, False, True])
EPS_VEC = np.array([0.0, 2.0, 0.0, 2.5, 1.5, 0.0], np.float32)
# (label, mode, shards, rows)
CASES = [("int8-P1", "int8", 1, B), ("int8-P3", "int8", 3, B),
         ("int8-P4", "int8", 4, B), ("bf16-P4", "bf16", 4, B),
         ("int8-pad", "int8", 4, 300)]
BACKENDS = ("torch", "cuda")

REF_SCRIPT = r"""
import pathlib, sys
import numpy as np, jax
from repro.core import dist_search as ds
from repro.core.engine import TieredIndex
from repro.core.fastsax import FastSAXConfig, build_index
from repro.core.options import SearchOptions
from repro.runtime import chaos

assert len(jax.devices()) == 4
out = pathlib.Path(sys.argv[1])
inp = np.load(out / "inputs.npz")
db, qs, is_knn, eps_vec = inp["db"], inp["qs"], inp["is_knn"], inp["eps_vec"]
res = {}
def put(prefix, names, vals):
    for n, v in zip(names, vals):
        res[prefix + n] = np.asarray(v)
for label, mode, P, rows in (("int8-P1", "int8", 1, 1003),
                             ("int8-P3", "int8", 3, 1003),
                             ("int8-P4", "int8", 4, 1003),
                             ("bf16-P4", "bf16", 4, 1003),
                             ("int8-pad", "int8", 4, 300)):
    mesh = ds.make_data_mesh(P)
    host = build_index(db[:rows], FastSAXConfig(n_segments=(8, 16)),
                       normalize=False)
    dti = ds.distributed_tiered_index(TieredIndex.from_host(host, mode), mesh)
    p = label + "_"
    plan = chaos.FaultPlan(seed=0)
    with chaos.injected(plan):
        put(p + "r_", ("gidx", "ans", "d2", "exact"),
            ds.distributed_quantized_range_query(
                dti, qs, 2.0, mesh, options=SearchOptions(
                    normalize_queries=False)))
        put(p + "k_", ("idx", "d2", "exact"),
            ds.distributed_quantized_knn_query(
                dti, qs, 5, mesh, options=SearchOptions(
                    normalize_queries=False, verify_prefetch=True)))
        put(p + "m_", ("gidx", "ans", "d2", "ovf"),
            ds.distributed_quantized_mixed_query(
                dti, qs, eps_vec, is_knn, 5, mesh, options=SearchOptions(
                    normalize_queries=False)))
    res[p + "fetch_keys"] = np.asarray(sorted(
        f"{k}={n}" for (s, k), n in plan._counts.items()
        if s == "verify_fetch"))
    ds.store_sharded_tiered(dti, out / f"tier_{label}")
np.savez(out / "results.npz", **res)
print("OK")
"""


def band(d2):
    return 1e-5 * (1.0 + np.abs(d2))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    chaos.uninstall()


@pytest.fixture(scope="module")
def data():
    db = make_wafer_like(B, N, seed=0)
    return {"db": db, "qs": make_queries(db, len(IS_KNN), seed=3)}


@pytest.fixture(scope="module")
def ref(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dist_quant")
    np.savez(out / "inputs.npz", is_knn=IS_KNN, eps_vec=EPS_VEC, **data)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=900)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    res = dict(np.load(out / "results.npz"))
    res["dir"] = out
    return res


def port_tiered(db, mode, rows):
    """The port's tier of the same host index, raw tier the host's f64
    series as the reference's ``TieredIndex.from_host`` keeps it."""
    host = build_index(db[:rows], FastSAXConfig(n_segments=LEVELS),
                       normalize=False)
    return teng.TieredIndex(
        dev=teng.quantized_device_index(tq.quantize_host_index(host, mode),
                                        "cpu"),
        raw=np.asarray(host.series))


@pytest.fixture(scope="module")
def dtis(data):
    out = {}
    for label, mode, P, rows in CASES:
        mesh = ds.make_data_mesh(P, device="cpu")
        out[label] = (mesh, ds.distributed_tiered_index(
            port_tiered(data["db"], mode, rows), mesh))
    return out


def opts(backend, **kw):
    return SearchOptions(backend=backend, normalize_queries=False, **kw)


def answer_sets(gidx, ans):
    gidx, ans = np.asarray(gidx), np.asarray(ans)
    return [set(gidx[i][ans[i]].tolist()) for i in range(gidx.shape[0])]


def oracle(db, qs):
    return ((qs[:, None, :].astype(np.float64)
             - db[None, :, :].astype(np.float64)) ** 2).sum(-1)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("label,mode,P,rows", CASES)
def test_range_matches_reference(data, ref, dtis, label, mode, P, rows,
                                 backend):
    mesh, dti = dtis[label]
    assert dti.size % (P * tq.RESID_BLOCK) == 0 and dti.n_valid == rows
    gidx, ans, d2, exact = ds.distributed_quantized_range_query(
        dti, data["qs"], EPS, mesh, options=opts(backend))
    p = f"{label}_r_"
    assert bool(exact.all()) and bool(ref[p + "exact"].all())
    got = answer_sets(gidx, ans)
    assert got == answer_sets(ref[p + "gidx"], ref[p + "ans"])
    d = oracle(data["db"][:rows], data["qs"])
    assert got == [set(np.flatnonzero(r <= EPS * EPS).tolist()) for r in d]
    for i, ids in enumerate(got):
        for g in ids:
            j = list(gidx[i].numpy()).index(g)
            assert abs(float(d2[i, j]) - d[i, g]) <= band(d[i, g])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("label,mode,P,rows", CASES)
def test_knn_matches_reference(data, ref, dtis, label, mode, P, rows,
                               backend):
    mesh, dti = dtis[label]
    nn_idx, nn_d2, exact = ds.distributed_quantized_knn_query(
        dti, data["qs"], K, mesh, options=opts(backend,
                                               verify_prefetch=True))
    p = f"{label}_k_"
    assert bool(exact.all())
    np.testing.assert_array_equal(nn_idx.numpy(), ref[p + "idx"])
    w = ref[p + "d2"]
    assert np.all(np.abs(nn_d2.numpy() - w) <= band(w))
    d = oracle(data["db"][:rows], data["qs"])
    want = np.argsort(d, axis=-1, kind="stable")[:, :K]
    np.testing.assert_array_equal(nn_idx.numpy(), want)


@pytest.mark.parametrize("label,mode,P,rows", CASES)
def test_mixed_and_fetch_counts_match_reference(data, ref, dtis, label, mode,
                                                P, rows):
    mesh, dti = dtis[label]
    plan = chaos.FaultPlan(seed=0)
    with chaos.injected(plan):
        ds.distributed_quantized_range_query(dti, data["qs"], EPS, mesh,
                                             options=opts("cuda"))
        ds.distributed_quantized_knn_query(
            dti, data["qs"], K, mesh,
            options=opts("cuda", verify_prefetch=True))
        gidx, ans, d2, ovf = ds.distributed_quantized_mixed_query(
            dti, data["qs"], EPS_VEC, IS_KNN, K, mesh, options=opts("cuda"))
    keys = sorted(f"{k}={n}" for (s, k), n in plan._counts.items()
                  if s == "verify_fetch")
    assert keys == ref[f"{label}_fetch_keys"].tolist()
    assert not bool(ovf.any())
    p = f"{label}_m_"
    rg, ra, rd = ref[p + "gidx"], ref[p + "ans"], ref[p + "d2"]
    for i in range(len(IS_KNN)):
        if IS_KNN[i]:
            top, _ = teng.mixed_topk(gidx[i:i + 1], d2[i:i + 1], K)
            o = np.lexsort((np.arange(rd[i].size), rd[i]))[:K]
            np.testing.assert_array_equal(top[0].numpy(), rg[i][o])
        else:
            assert set(gidx[i][ans[i]].tolist()) == \
                set(rg[i][ra[i]].tolist())


@pytest.mark.parametrize("label,mode,P,rows", CASES)
def test_verify_prefetch_bit_identical(data, dtis, label, mode, P, rows):
    mesh, dti = dtis[label]
    a = ds.distributed_quantized_mixed_query(
        dti, data["qs"], EPS_VEC, IS_KNN, K, mesh, options=opts("cuda"))
    b = ds.distributed_quantized_mixed_query(
        dti, data["qs"], EPS_VEC, IS_KNN, K, mesh,
        options=opts("cuda", verify_prefetch=True))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _files(path: pathlib.Path) -> dict:
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("label,mode,P,rows", CASES)
def test_tiered_store_byte_identical_and_cross_loads(data, ref, dtis,
                                                     tmp_path, label, mode,
                                                     P, rows):
    mesh, dti = dtis[label]
    mine = ds.store_sharded_tiered(dti, tmp_path / "tier")
    theirs = ref["dir"] / f"tier_{label}"
    assert _files(mine) == _files(theirs)
    # The reference reads the port's store shard by shard ...
    jshards, jnv, _ = jsharded.load_tier_shards(mine)
    assert jnv == rows and len(jshards) == P
    for js, qd in zip(jshards, dti.shards):
        np.testing.assert_array_equal(np.asarray(js.qhost.norms_sq),
                                      qd.norms_sq.numpy())
    # ... and the port warm-starts the distributed screen from the
    # reference's, answering as the reference did.
    back = ds.load_sharded_tiered(theirs, mesh)
    assert back.n_valid == rows and len(back.shards) == P
    gidx, ans, _, _ = ds.distributed_quantized_range_query(
        back, data["qs"], EPS, mesh, options=opts("cuda"))
    assert answer_sets(gidx, ans) == answer_sets(ref[f"{label}_r_gidx"],
                                                 ref[f"{label}_r_ans"])
    # One tiered index on one device from the same store.
    tiered, nv = tsharded.load_sharded_quantized(theirs, device="cpu")
    assert nv == rows and tiered.size == dti.size
    idx, ans1, _, _ = teng.quantized_range_query(
        tiered, teng.represent_queries(
            torch.as_tensor(data["qs"]), LEVELS, ALPHA, normalize=False),
        EPS)
    assert answer_sets(idx, ans1) == answer_sets(gidx, ans)


def test_store_misalignment_fails_loudly(data, dtis, tmp_path):
    mesh, dti = dtis["int8-P3"]
    ragged = ds.DistTieredIndex(
        shards=(dti.shards[0], dataclass_rows(dti.shards[1], 100)),
        raw=dti.raw, n_valid=dti.n_valid)
    with pytest.raises(ValueError, match="RESID_BLOCK"):
        ds.store_sharded_tiered(
            ds.DistTieredIndex(shards=(dataclass_rows(dti.shards[0], 100),
                                       dti.shards[1]),
                               raw=dti.raw, n_valid=dti.n_valid),
            tmp_path / "bad")
    path = ds.store_sharded_tiered(ragged, tmp_path / "ok")
    with pytest.raises(ValueError, match="unequal shard row counts"):
        ds.load_sharded_tiered(path, ds.make_data_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="stored for 2"):
        ds.load_sharded_tiered(path, mesh)


def dataclass_rows(qdev, rows: int):
    """The first ``rows`` rows of a shard's columns (whole blocks)."""
    import dataclasses

    nb = -(-rows // tq.RESID_BLOCK)
    r = lambda t: None if t is None else t[:rows]
    b = lambda t: None if t is None else t[:nb]
    return dataclasses.replace(
        qdev, series=r(qdev.series), series_scale=r(qdev.series_scale),
        series_zero=r(qdev.series_zero), series_err=r(qdev.series_err),
        norms_sq=r(qdev.norms_sq), words=tuple(map(r, qdev.words)),
        residuals=tuple(map(r, qdev.residuals)),
        resid_scale=tuple(map(b, qdev.resid_scale)),
        resid_zero=tuple(map(b, qdev.resid_zero)),
        resid_err=tuple(map(b, qdev.resid_err)))


def test_sharded_raw_gathers_across_shards():
    parts = [np.arange(12, dtype=np.float64).reshape(4, 3),
             np.arange(12, 18, dtype=np.float64).reshape(2, 3)]
    raw = tsharded.ShardedRaw(parts, block=4)
    assert raw.shape == (6, 3) and len(raw) == 6
    np.testing.assert_array_equal(raw[[5, 0, 4]],
                                  np.concatenate(parts)[[5, 0, 4]])
    np.testing.assert_array_equal(np.asarray(raw), np.concatenate(parts))
    with pytest.raises(ValueError, match="prefix"):
        tsharded.ShardedRaw([parts[1], parts[0]], block=4)


@pytest.mark.parametrize("verify_prefetch", [False, True])
def test_service_over_the_distributed_tier(data, tmp_path, verify_prefetch):
    db, q = data["db"][:300], data["qs"][1]
    d = oracle(db, q[None])[0]
    mesh = ds.make_data_mesh(4, device="cpu")
    cfg = ServeConfig(quantization="int8", verify_prefetch=verify_prefetch,
                      normalize_queries=False, max_wait_ms=0.5)
    svc = SearchService.from_series(db, cfg, mesh=mesh, normalize=False)
    assert isinstance(svc.backend, _DistQuantizedBackend)
    assert svc.backend.backend == "torch" and svc.backend.size == 300
    with svc:
        ids, _ = svc.range_query(q, 4.0)
        assert set(ids.tolist()) == set(np.flatnonzero(d <= 16.0).tolist())
        ids, _ = svc.knn(q, 3)
        assert ids.tolist() == np.argsort(d, kind="stable")[:3].tolist()
    # The same tier stored sharded, warm-started three ways.
    path = ds.store_sharded_tiered(svc.backend.dti, tmp_path / "tier")
    for kw, kind in (({"mesh": mesh}, _DistQuantizedBackend),
                     ({}, None),
                     ({"cfg_failover": 4}, _FailoverBackend)):
        c = ServeConfig(quantization="int8", normalize_queries=False,
                        max_wait_ms=0.5,
                        failover_shards=kw.pop("cfg_failover", 0))
        s = SearchService.from_store(path, c, device="cpu", **kw)
        assert kind is None or isinstance(s.backend, kind)
        with s:
            ids, _ = s.knn(q, 3)
            assert ids.tolist() == np.argsort(d, kind="stable")[:3].tolist()
