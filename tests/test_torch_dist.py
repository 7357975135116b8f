"""The port's sharded search against the reference's, on the CPU.

The reference's distributed engines (``repro.core.dist_search``) need a
mesh of several devices, so they run once per module in a subprocess with
``--xla_force_host_platform_device_count=4`` (as ``tests/test_dist_search.py``
runs them), on inputs this file writes and with results written back as
``.npz`` files and sharded stores.  The port runs the same calls over
``make_data_mesh(P, device="cpu")`` for P ∈ {1, 3, 4} shards and B = 1003
rows (not divisible by 3 or 4, so the last shard carries pads), on both
backends: ``torch`` and ``cuda`` (the kernels' plain versions on CPU
tensors).

Held to the reference: range answer sets equal, k-NN ids equal, d² within
1e-5·(1 + d²) (the diff² form both engines verify in; kernel 1's range
d² is the matmul form ‖q‖² − 2·q·u + ‖u‖², held to the band of the other
engine tests, 1e-3 + 1e-5·d²), survivor counts and trace counters equal,
capacity overflow flags equal; sharded stores cross-load both ways and the same
index saves byte-identical in both packages.  The stream-sharded
subsequence search is held the same way over 5 streams.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.options import SearchOptions as JOptions
from repro.index import sharded as jsharded
from repro_torch.core import dist_search as ds
from repro_torch.core import engine as teng
from repro_torch.core import subseq as tss
from repro_torch.core.fastsax import FastSAXConfig
from repro_torch.core.options import SearchOptions
from repro_torch.data.timeseries import (make_queries, make_subseq_queries,
                                         make_wafer_like)
from repro_torch.index import sharded as tsharded

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, N, LEVELS, ALPHA, K, EPS = 1003, 128, (8, 16), 10, 5, 2.0
SHARDS = (1, 3, 4)
BACKENDS = ("torch", "cuda")
IS_KNN = np.array([True, False, True, False, False, True])
EPS_VEC = np.array([0.0, 2.0, 0.0, 2.5, 1.5, 0.0], np.float32)
SUB = dict(streams=5, stream_len=700, window=64, stride=2, k=3, excl=32,
           eps=6.0)

REF_SCRIPT = r"""
import pathlib, sys
import numpy as np, jax
from repro.core import dist_search as ds
from repro.core.fastsax import FastSAXConfig
from repro.core.options import SearchOptions
from repro.core.subseq import build_subseq_index

assert len(jax.devices()) == 4
out = pathlib.Path(sys.argv[1])
inp = np.load(out / "inputs.npz")
db, qs, is_knn, eps_vec = inp["db"], inp["qs"], inp["is_knn"], inp["eps_vec"]
streams, sq = inp["streams"], inp["sq"]
o = SearchOptions(backend="xla", normalize_queries=False)
res = {}
def put(prefix, names, vals):
    for n, v in zip(names, vals):
        res[prefix + n] = np.asarray(v)
for P in (1, 3, 4):
    mesh = ds.make_data_mesh(P)
    padded, nv = ds.pad_database(db, P)
    idx = ds.distributed_build(padded, (8, 16), 10, mesh, n_valid=nv)
    p = f"P{P}_"
    put(p + "ra_", ("gidx", "ans", "d2", "ovf"),
        ds.distributed_range_query_auto(idx, qs, 2.0, mesh, options=o))
    put(p + "r16_", ("gidx", "ans", "d2", "ovf"),
        ds.distributed_range_query(idx, qs, 2.0, mesh,
                                   options=SearchOptions(
                                       backend="xla", capacity=16,
                                       normalize_queries=False)))
    put(p + "knn_", ("idx", "d2", "exact"),
        ds.distributed_knn_query(idx, qs, 5, mesh, options=o, n_valid=nv))
    put(p + "mix_", ("gidx", "ans", "d2", "ovf"),
        ds.distributed_mixed_query_auto(idx, qs, eps_vec, is_knn, 5, mesh,
                                        options=o, n_valid=nv))
    res[p + "count"] = np.asarray(ds.distributed_survivor_count(
        idx, qs, 2.0, mesh, normalize_queries=False))
    *_, tr = ds.distributed_range_query_traced(idx, qs, 2.0, mesh,
                                               options=o, n_valid=nv)
    put(p + "rtr_", ("c9", "c10", "ver", "ans"),
        (tr.after_c9, tr.after_c10, tr.verified, tr.answers))
    *_, tr = ds.distributed_knn_query_traced(idx, qs, 5, mesh, options=o,
                                             n_valid=nv)
    put(p + "ktr_", ("c9", "c10", "ver", "ans"),
        (tr.after_c9, tr.after_c10, tr.verified, tr.answers))
    ds.store_sharded(idx, out / f"store_P{P}", n_valid=nv)
    hidx = build_subseq_index(streams, FastSAXConfig(n_segments=(8, 16)),
                              64, 2)
    dsx = ds.distributed_subseq_index(hidx, mesh)
    so = SearchOptions(backend="xla")      # windows: queries z-normalised
    put(p + "sr_", ("gidx", "ans", "d2", "ovf"),
        ds.distributed_subseq_range_query(dsx, sq, 6.0, mesh, options=so))
    put(p + "sk_", ("idx", "d2", "exact"),
        ds.distributed_subseq_knn_query(dsx, sq, 3, mesh, excl=32,
                                        options=so))
np.savez(out / "results.npz", **res)
print("OK")
"""


def band(d2):
    return 1e-5 * (1.0 + np.abs(d2))


def matmul_band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


@pytest.fixture(scope="module")
def data():
    db = make_wafer_like(B, N, seed=0)
    qs = make_queries(db, len(IS_KNN), seed=3)
    streams = make_wafer_like(SUB["streams"], SUB["stream_len"], seed=1,
                              normalize=False)
    sq = make_subseq_queries(streams, 4, SUB["window"], seed=2)
    return {"db": db, "qs": qs, "streams": streams, "sq": sq}


@pytest.fixture(scope="module")
def ref(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dist")
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


@pytest.fixture(scope="module")
def built(data):
    """The port's sharded index per shard count, on the CPU."""
    out = {}
    for P in SHARDS:
        mesh = ds.make_data_mesh(P, device="cpu")
        padded, nv = ds.pad_database(data["db"], P)
        out[P] = (mesh, ds.distributed_build(padded, LEVELS, ALPHA, mesh,
                                             n_valid=nv))
    return out


def opts(backend, **kw):
    return SearchOptions(backend=backend, normalize_queries=False, **kw)


def answer_sets(gidx, ans):
    gidx, ans = np.asarray(gidx), np.asarray(ans)
    return [set(gidx[i][ans[i]].tolist()) for i in range(gidx.shape[0])]


def d2_by_id(gidx, ans, d2):
    gidx, ans, d2 = map(np.asarray, (gidx, ans, d2))
    return [dict(zip(gidx[i][ans[i]].tolist(), d2[i][ans[i]].tolist()))
            for i in range(gidx.shape[0])]


def assert_range_equal(got, ref, prefix, tol=band):
    gidx, ans, d2 = (t.cpu().numpy() for t in got[:3])
    want = answer_sets(ref[prefix + "gidx"], ref[prefix + "ans"])
    assert answer_sets(gidx, ans) == want
    assert sum(map(len, want)) > 0
    gd = d2_by_id(gidx, ans, d2)
    wd = d2_by_id(ref[prefix + "gidx"], ref[prefix + "ans"],
                  ref[prefix + "d2"])
    for g, w in zip(gd, wd):
        for i in w:
            assert abs(g[i] - w[i]) <= tol(w[i])


# ---------------------------------------------------------------------------
# The mesh and the build.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", SHARDS)
def test_build_shards_rows_and_stamps_pads(data, built, P):
    mesh, idx = built[P]
    assert mesh.shape["data"] == P and len(idx.shards) == P
    assert all(s.device.type == "cpu" for s in idx.shards)
    b_loc = -(-B // P)
    assert idx.b_loc == b_loc and idx.size == b_loc * P and idx.n_valid == B
    single = teng.build_device_index(data["db"], LEVELS, ALPHA,
                                     device="cpu")
    for s, sh in enumerate(idx.shards):
        lo, hi = s * b_loc, min(B, (s + 1) * b_loc)
        torch.testing.assert_close(sh.series[:hi - lo], single.series[lo:hi])
        np.testing.assert_array_equal(sh.words[1][:hi - lo].numpy(),
                                      single.words[1][lo:hi].numpy())
        pads = sh.residuals[0][hi - lo:]
        assert bool((pads == 1e30).all())


def test_make_data_mesh_places_shards():
    mesh = ds.make_data_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.shape == {"data": 3} and mesh.size == 3
    assert ds.make_data_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ds.make_data_mesh(2)


# ---------------------------------------------------------------------------
# The engines against the reference.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P", SHARDS)
def test_range_auto_matches_reference(data, ref, built, P, backend):
    mesh, idx = built[P]
    got = ds.distributed_range_query_auto(idx, data["qs"], EPS, mesh,
                                          options=opts(backend))
    assert got[0].shape[-1] % P == 0 and got[3].shape == (len(IS_KNN), P)
    assert not bool(got[3].any())
    assert_range_equal(got, ref, f"P{P}_ra_",
                       matmul_band if backend == "cuda" else band)


@pytest.mark.parametrize("P", SHARDS)
def test_range_fixed_capacity_overflow_matches_reference(data, ref, built, P):
    # The torch engine compacts like the reference's XLA one: the same
    # lowest-index survivors per shard, the same overflow flags.
    mesh, idx = built[P]
    got = ds.distributed_range_query(idx, data["qs"], EPS, mesh,
                                     options=opts("torch", capacity=16))
    np.testing.assert_array_equal(got[3].numpy(), ref[f"P{P}_r16_ovf"])
    assert_range_equal(got, ref, f"P{P}_r16_")
    # The legacy keyword shims through with a warning.
    with pytest.warns(DeprecationWarning):
        legacy = ds.distributed_range_query(
            idx, data["qs"], EPS, mesh, capacity_per_shard=16,
            normalize_queries=False, backend="torch")
    assert torch.equal(legacy[3], got[3])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P", SHARDS)
def test_knn_matches_reference(data, ref, built, P, backend):
    mesh, idx = built[P]
    nn_idx, nn_d2, exact = ds.distributed_knn_query(
        idx, data["qs"], K, mesh, options=opts(backend), n_valid=B)
    assert bool(exact.all()) and bool(ref[f"P{P}_knn_exact"].all())
    np.testing.assert_array_equal(nn_idx[:, :K].numpy(),
                                  ref[f"P{P}_knn_idx"][:, :K])
    w = ref[f"P{P}_knn_d2"][:, :K]
    assert np.all(np.abs(nn_d2[:, :K].numpy() - w) <= band(w))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P", SHARDS)
def test_mixed_auto_matches_reference(data, ref, built, P, backend):
    mesh, idx = built[P]
    gidx, ans, d2, ovf = ds.distributed_mixed_query_auto(
        idx, data["qs"], EPS_VEC, IS_KNN, K, mesh, options=opts(backend),
        n_valid=B)
    assert not bool(ovf.any())
    gidx, ans, d2 = gidx.numpy(), ans.numpy(), d2.numpy()
    rg, ra, rd = (ref[f"P{P}_mix_{n}"] for n in ("gidx", "ans", "d2"))
    for i in range(len(IS_KNN)):
        if IS_KNN[i]:
            top = teng.mixed_topk(torch.as_tensor(gidx[i:i + 1]),
                                  torch.as_tensor(d2[i:i + 1]), K)
            o = np.lexsort((np.arange(rd[i].size), rd[i]))[:K]
            np.testing.assert_array_equal(top[0][0].numpy(), rg[i][o])
        else:
            assert set(gidx[i][ans[i]].tolist()) == \
                set(rg[i][ra[i]].tolist())


@pytest.mark.parametrize("P", SHARDS)
def test_survivor_count_and_traces_match_reference(data, ref, built, P):
    mesh, idx = built[P]
    count = ds.distributed_survivor_count(idx, data["qs"], EPS, mesh,
                                          normalize_queries=False)
    np.testing.assert_array_equal(count.numpy(), ref[f"P{P}_count"])
    *_, tr = ds.distributed_range_query_traced(idx, data["qs"], EPS, mesh,
                                               options=opts("cuda"),
                                               n_valid=B)
    for name, got in (("c9", tr.after_c9), ("c10", tr.after_c10),
                      ("ver", tr.verified), ("ans", tr.answers)):
        np.testing.assert_array_equal(got.numpy(), ref[f"P{P}_rtr_{name}"])
    *_, tr = ds.distributed_knn_query_traced(idx, data["qs"], K, mesh,
                                             options=opts("torch"),
                                             n_valid=B)
    for name, got in (("c9", tr.after_c9), ("c10", tr.after_c10),
                      ("ver", tr.verified), ("ans", tr.answers)):
        np.testing.assert_array_equal(got.numpy(), ref[f"P{P}_ktr_{name}"])


@pytest.mark.parametrize("P", (3, 4))
def test_padded_rows_never_answer(data, built, P):
    # At a radius that admits every real row, no pad id comes back.
    mesh, idx = built[P]
    gidx, ans, _, _ = ds.distributed_range_query_auto(
        idx, data["qs"], 1e6, mesh, options=opts("cuda"))
    got = answer_sets(gidx, ans)
    assert all(g == set(range(B)) for g in got)
    nn_idx, _, _ = ds.distributed_knn_query(idx, data["qs"], B + 50, mesh,
                                            options=opts("torch"))
    ids = nn_idx.numpy()
    assert set(ids[ids >= 0].ravel().tolist()) <= set(range(B))
    assert (ids >= 0).sum(axis=-1).tolist() == [B] * len(IS_KNN)


def test_mesh_mismatch_is_refused(data, built):
    mesh3, idx3 = built[3]
    with pytest.raises(ValueError, match="shard"):
        ds.distributed_range_query(idx3, data["qs"], EPS,
                                   ds.make_data_mesh(4, device="cpu"))


# ---------------------------------------------------------------------------
# Sharded stores.
# ---------------------------------------------------------------------------


def _files(path: pathlib.Path) -> dict:
    return {str(p.relative_to(path)): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("P", SHARDS)
def test_reference_store_loads_and_resaves_byte_identical(data, ref, tmp_path,
                                                          P):
    path = ref["dir"] / f"store_P{P}"
    mesh = ds.make_data_mesh(P, device="cpu")
    idx, nv = ds.load_sharded(path, mesh)
    assert nv == B and len(idx.shards) == P
    # The reference's index, saved again by the port: byte for byte.
    ds.store_sharded(idx, tmp_path / "again", n_valid=nv)
    assert _files(tmp_path / "again") == _files(path)
    # It answers as the reference did.
    got = ds.distributed_range_query_auto(idx, data["qs"], EPS, mesh,
                                          options=opts("torch"))
    assert answer_sets(*got[:2]) == answer_sets(ref[f"P{P}_ra_gidx"],
                                                ref[f"P{P}_ra_ans"])
    if P > 1:
        with pytest.raises(ValueError, match="stored for"):
            ds.load_sharded(path, ds.make_data_mesh(P - 1, device="cpu"))


@pytest.mark.parametrize("P", SHARDS)
def test_port_store_loads_in_the_reference(data, built, tmp_path, P):
    mesh, idx = built[P]
    path = ds.store_sharded(idx, tmp_path / "port", n_valid=B)
    info = tsharded.sharded_info(path)
    assert info["kind"] == "fastsax-index-sharded" and info["shards"] == P
    jshards, joffsets, jnv = jsharded.load_shard_indexes(path)
    assert jnv == B and joffsets == [s * idx.b_loc for s in range(P)]
    for js, ts in zip(jshards, idx.shards):
        np.testing.assert_array_equal(np.asarray(js.series),
                                      ts.series.numpy())
        np.testing.assert_array_equal(np.asarray(js.residuals[0]),
                                      ts.residuals[0].numpy())
        np.testing.assert_array_equal(np.asarray(js.words[0]),
                                      ts.words[0].numpy())
    # And back in the port, shard by shard for the failover engine.
    shards, offsets, nv = tsharded.load_shard_indexes(path, device="cpu")
    assert offsets == joffsets and nv == B
    assert all(torch.equal(a.series, b.series)
               for a, b in zip(shards, idx.shards))


def test_sharded_store_verify_and_stack_checks(built, tmp_path):
    mesh, idx = built[3]
    path = ds.store_sharded(idx, tmp_path / "s", n_valid=B)
    again, nv = ds.load_sharded(path, mesh, verify=True)
    assert torch.equal(again.shards[2].series, idx.shards[2].series)
    with pytest.raises(IOError, match="not a fastsax-index-sharded"):
        tsharded.load_shard_indexes(tmp_path / "s" / "shard_00000")


# ---------------------------------------------------------------------------
# Stream-sharded subsequence search.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sub_index(data):
    return tss.build_subseq_index(data["streams"],
                                  FastSAXConfig(n_segments=LEVELS),
                                  SUB["window"], SUB["stride"])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P", SHARDS)
def test_subseq_range_matches_reference(data, ref, sub_index, P, backend):
    mesh = ds.make_data_mesh(P, device="cpu")
    dsx = ds.distributed_subseq_index(sub_index, mesh)
    S_p = -(-SUB["streams"] // P) * P
    assert dsx.size == S_p * sub_index.windows_per_stream
    assert dsx.n_valid == sub_index.n_windows
    got = ds.distributed_subseq_range_query(
        dsx, data["sq"], SUB["eps"], mesh,
        options=SearchOptions(backend=backend))
    assert not bool(got[3].any())
    assert_range_equal(got, ref, f"P{P}_sr_",
                       matmul_band if backend == "cuda" else band)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("P", SHARDS)
def test_subseq_knn_matches_reference(data, ref, sub_index, P, backend):
    mesh = ds.make_data_mesh(P, device="cpu")
    dsx = ds.distributed_subseq_index(sub_index, mesh)
    sel, sel_d2, exact = ds.distributed_subseq_knn_query(
        dsx, data["sq"], SUB["k"], mesh, excl=SUB["excl"],
        options=SearchOptions(backend=backend))
    assert exact.all()
    np.testing.assert_array_equal(sel, ref[f"P{P}_sk_idx"])
    w = ref[f"P{P}_sk_d2"]
    assert np.all(np.abs(sel_d2 - w) <= band(w))
    # The single-index engine answers the same.
    sidx = tss.subseq_device_index(sub_index, "cpu")
    one, _, _ = tss.subseq_knn_query(
        sidx, tss.represent_subseq_queries(sidx, data["sq"]), SUB["k"],
        excl=SUB["excl"], options=SearchOptions(backend=backend))
    np.testing.assert_array_equal(sel, one)


def test_subseq_pad_streams_carry_the_sentinel(sub_index):
    mesh = ds.make_data_mesh(4, device="cpu")
    dsx = ds.distributed_subseq_index(sub_index, mesh)
    # 5 streams over 4 shards of 2: shard 2 holds the last real stream
    # and a pad stream, shard 3 two pad streams.
    W_s = sub_index.windows_per_stream
    assert dsx.w_loc == 2 * W_s
    res = [s.index.residuals[0] for s in dsx.shards]
    assert bool((res[2][W_s:] == 1e30).all() and (res[3] == 1e30).all())
    assert bool((res[2][:W_s] < 1e30).all() and (res[1] < 1e30).all())


def test_legacy_options_and_unknown_kwargs(data, built):
    mesh, idx = built[3]
    with pytest.raises(TypeError, match="unexpected kwargs"):
        ds.distributed_knn_query(idx, data["qs"], K, mesh, block_q=8)
    with pytest.warns(DeprecationWarning):
        a = ds.distributed_knn_query(idx, data["qs"], K, mesh,
                                     normalize_queries=False)
    b = ds.distributed_knn_query(idx, data["qs"], K, mesh,
                                 options=opts("auto"))
    assert torch.equal(a[0], b[0])
    assert JOptions().capacity is None      # the reference's default too


def test_launcher_search_stores_then_warm_starts(tmp_path, capsys):
    from repro_torch.launch import serve as launch

    store = tmp_path / "shidx"
    args = ["--search", "--device", "cpu", "--shards", "3", "--db-size",
            "600", "--queries", "4", "--index-dir", str(store)]
    cold = launch.main(args)
    out = capsys.readouterr().out
    assert "cold start" in out and "stored sharded index" in out
    assert tsharded.sharded_info(store)["shards"] == 3
    warm = launch.main(args)
    assert "warm start: 600 series" in capsys.readouterr().out
    knn = launch.main(args + ["--knn", "5"])
    assert knn["exact"] and knn["nn_idx"].shape == (4, 5)
    # Each run answers as the single index over the same rows does, for
    # the queries it drew (the warm path draws them from a small batch
    # of rows, not the database, as the reference's launcher does).
    single = teng.build_device_index(make_wafer_like(600, N, seed=0),
                                     LEVELS, ALPHA, device="cpu")
    for got, src in ((cold, make_wafer_like(600, N, seed=0)),
                     (warm, make_wafer_like(64, N, seed=0))):
        qr = teng.represent_queries(torch.as_tensor(
            make_queries(src, 4, seed=1), dtype=torch.float32), LEVELS,
            ALPHA, normalize=False)
        ans, _ = teng.range_query(single, qr, EPS)
        assert got["answers"] == [np.flatnonzero(a).tolist()
                                  for a in ans.numpy()]
        assert not got["overflow"]
    ids, _, _ = teng.knn_query_auto(single, qr, 5)
    np.testing.assert_array_equal(knn["nn_idx"], ids.numpy())
    # A store of another fleet shape is not overwritten.
    other = launch.main(["--search", "--device", "cpu", "--shards", "2",
                         "--db-size", "600", "--queries", "4",
                         "--index-dir", str(store)])
    assert "NOT overwriting" in capsys.readouterr().out
    assert other == cold
    assert tsharded.sharded_info(store)["shards"] == 3
