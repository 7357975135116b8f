"""The port's index store against the reference's: one on-disk format.

A store written by ``repro.index.store`` loads in ``repro_torch.index.store``
with equal arrays, config and dtypes, and the reverse (plain, int8 and bf16
stores); the same host index saved by both packages gives byte-identical
directories.  Then the reference's own store tests (``tests/test_index_store.py``),
run through the port: the round trip, integrity, the crash windows of the
atomic commit (``os.rename`` patched), the dtype contracts, and the device
upload from a store.  Everything runs on the CPU.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import fastsax as jfs
from repro.index import quantized as jq
from repro.index import store as jstore
from repro_torch.core import engine as teng
from repro_torch.core import fastsax as tfs
from repro_torch.core.search import fastsax_knn_query, fastsax_range_query
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.index import quantized as tq
from repro_torch.index import store
from repro_torch.index.store import (load_index, save_index, store_info,
                                     verify_store)

CFG = tfs.FastSAXConfig(n_segments=(8, 16), alphabet=10)
JCFG = jfs.FastSAXConfig(n_segments=(8, 16), alphabet=10)
MODES = ("none", "int8", "bf16")


def carry_host(j) -> tfs.FastSAXIndex:
    """A reference host index carried across as the port's, array for
    array (no copy, no rebuild)."""
    c = j.config
    cfg = tfs.FastSAXConfig(n_segments=tuple(c.n_segments),
                            alphabet=c.alphabet, level_order=c.level_order,
                            stack=tuple(c.stack))
    return tfs.FastSAXIndex(config=cfg, series=j.series, levels=[
        tfs.LevelData(n_segments=lv.n_segments, words=lv.words,
                      residuals=lv.residuals, extra=dict(lv.extra))
        for lv in j.levels])


@pytest.fixture(scope="module")
def db():
    return make_wafer_like(n_series=256, length=128, seed=0, normalize=False)


@pytest.fixture(scope="module")
def jbuilt(db):
    return jfs.build_index(db, JCFG, normalize=False)


@pytest.fixture(scope="module")
def built(db):
    return tfs.build_index(db, CFG, normalize=False)


def assert_same_index(a, b):
    """Two host indexes (of either package) with equal arrays, dtypes and
    config."""
    assert np.array_equal(np.asarray(a.series), np.asarray(b.series))
    assert np.asarray(a.series).dtype == np.asarray(b.series).dtype
    for x, y in zip(a.levels, b.levels):
        assert x.n_segments == y.n_segments
        for f in ("words", "residuals"):
            u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert np.array_equal(u, v) and u.dtype == v.dtype
    for f in ("n_segments", "alphabet", "level_order", "stack"):
        assert tuple(np.atleast_1d(getattr(a.config, f))) == \
            tuple(np.atleast_1d(getattr(b.config, f)))


def assert_same_quant(a, b):
    """Two quantized host tiers with equal columns and dtypes."""
    assert a.mode == b.mode and a.n == b.n and a.alphabet == b.alphabet
    for f in ("series", "series_scale", "series_zero", "series_err",
              "norms_sq"):
        u, v = getattr(a, f), getattr(b, f)
        assert (u is None) == (v is None), f
        if u is not None:
            assert np.array_equal(np.asarray(u), np.asarray(v)), f
            assert np.asarray(u).dtype == np.asarray(v).dtype, f
    for x, y in zip(a.levels, b.levels):
        for f in ("words", "residuals", "scale", "zero", "err"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), f
            if u is not None:
                assert np.array_equal(np.asarray(u), np.asarray(v)), f


# ---------------------------------------------------------------------------
# 1. The shared format.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stores_cross_load(jbuilt, tmp_path, writer, mode):
    path = tmp_path / "idx"
    if writer == "reference":
        jstore.save_index(jbuilt, path, quantization=mode)
        loaded = load_index(path, verify=True)
        assert isinstance(loaded, tfs.FastSAXIndex)
    else:
        save_index(carry_host(jbuilt), path, quantization=mode)
        loaded = jstore.load_index(path, verify=True)
        assert isinstance(loaded, jfs.FastSAXIndex)
    assert_same_index(loaded, jbuilt)
    assert store.read_manifest(path) == jstore.read_manifest(path)
    if mode == "none":
        return
    assert store.quantized_mode(store.read_manifest(path)) == mode
    assert_same_quant(store.load_quantized(path, verify=True, mode=mode),
                      jstore.load_quantized(path, verify=True, mode=mode))


@pytest.mark.parametrize("mode", MODES)
def test_same_host_index_saves_byte_identical(jbuilt, tmp_path, mode):
    jstore.save_index(jbuilt, tmp_path / "ref", extra_meta={"gen": 3},
                      extra_arrays={"ids": np.arange(jbuilt.size)},
                      quantization=mode)
    save_index(carry_host(jbuilt), tmp_path / "port", extra_meta={"gen": 3},
               extra_arrays={"ids": np.arange(jbuilt.size)},
               quantization=mode)
    ref = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert ref == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert store.MANIFEST in ref and len(ref) > 5
    for name in ref:
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_port_built_index_matches_reference_build(jbuilt, built, tmp_path):
    # The port's own offline build gives the reference's columns, so its
    # stores are the reference's too (words and the f64 series exactly;
    # residuals to f64 rounding of the same formula).
    assert np.array_equal(jbuilt.series, built.series)
    for a, b in zip(jbuilt.levels, built.levels):
        assert np.array_equal(a.words, b.words)
        np.testing.assert_allclose(a.residuals, b.residuals, rtol=1e-12,
                                   atol=1e-12)
    save_index(built, tmp_path / "idx")
    assert_same_index(jstore.load_index(tmp_path / "idx"), built)


# ---------------------------------------------------------------------------
# 2. The reference's store tests, through the port.
# ---------------------------------------------------------------------------

def test_round_trip_bit_exact(built, db, tmp_path):
    path = tmp_path / "idx"
    save_index(built, path)
    loaded = load_index(path)
    assert_same_index(loaded, built)
    assert loaded.config == built.config
    for q in make_queries(db, 3, seed=1):
        qr = tfs.represent_query(q, CFG, normalize=False)
        r0 = fastsax_range_query(built, qr, 2.0)
        r1 = fastsax_range_query(loaded, qr, 2.0)
        assert np.array_equal(r0.answers, r1.answers)
        k0 = fastsax_knn_query(built, qr, 5)
        k1 = fastsax_knn_query(loaded, qr, 5)
        assert np.array_equal(k0.indices, k1.indices)
        assert np.array_equal(k0.distances, k1.distances)


def test_mmap_load_is_lazy_and_info(built, tmp_path):
    path = tmp_path / "idx"
    save_index(built, path)
    loaded = load_index(path, mmap=True)
    assert isinstance(loaded.series, np.memmap)
    info = store_info(path)
    assert info == jstore.store_info(path) | {"path": str(path)}
    assert info["size"] == built.size and info["quantization"] == "none"
    assert set(info["arrays"]) == {"series", "words_N8", "resid_N8",
                                   "words_N16", "resid_N16"}
    assert verify_store(path)["kind"] == "fastsax-index"


def test_corruption_fails_loudly(built, tmp_path):
    path = tmp_path / "idx"
    save_index(built, path)
    target = path / "resid_N8.npy"
    raw = bytearray(target.read_bytes())
    raw[-8] ^= 0xFF                       # flip payload bits, keep header
    target.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="resid_N8.*checksum"):
        verify_store(path)
    with pytest.raises(IOError, match="checksum"):
        load_index(path, verify=True)
    # A tampered shape fails the manifest cross-check even without verify.
    manifest = json.loads((path / store.MANIFEST).read_text())
    manifest["arrays"]["series"]["shape"][0] += 1
    (path / store.MANIFEST).write_text(json.dumps(manifest))
    with pytest.raises(IOError, match="does not match manifest"):
        load_index(path)


def _boom(*a, **k):
    raise OSError("injected crash: writer killed")


@pytest.mark.parametrize("window", ["before_rename", "between_renames",
                                    "fresh_path"])
def test_crash_windows_keep_the_committed_generation(built, db, tmp_path,
                                                     monkeypatch, window):
    """A writer killed in the atomic commit never loses the committed
    generation: before the first rename it is untouched; between the
    renames it survives at ``<path>.old`` with its checksums; on a fresh
    path nothing is committed."""
    path = tmp_path / "idx"
    newer = tfs.build_index(db[:64], CFG, normalize=False)
    if window == "fresh_path":
        monkeypatch.setattr(store.os, "rename", _boom)
        with pytest.raises(OSError, match="injected crash"):
            save_index(built, path)
        monkeypatch.undo()
        assert not path.exists()
        with pytest.raises(FileNotFoundError):
            load_index(path)
        return
    save_index(built, path, extra_meta={"gen": 0})
    if window == "before_rename":
        monkeypatch.setattr(store.os, "rename", _boom)
    else:
        real_rename, calls = os.rename, []

        def second_call_crashes(src, dst):
            calls.append(src)
            if len(calls) == 2:
                _boom()
            return real_rename(src, dst)

        monkeypatch.setattr(store.os, "rename", second_call_crashes)
    with pytest.raises(OSError, match="injected crash"):
        save_index(newer, path, extra_meta={"gen": 1})
    monkeypatch.undo()
    survivor = path if window == "before_rename" else tmp_path / "idx.old"
    if window == "between_renames":
        assert not path.exists()
    assert verify_store(survivor)["extra"] == {"gen": 0}
    assert_same_index(load_index(survivor), built)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_store_round_trip(built, tmp_path, mode):
    path = tmp_path / "qidx"
    save_index(built, path, quantization=mode)
    loaded = store.load_quantized(path, verify=True)
    assert loaded.mode == mode and isinstance(loaded.series, np.memmap)
    assert_same_quant(loaded, tq.quantize_host_index(built, mode))
    other = "int8" if mode == "bf16" else "bf16"
    with pytest.raises(IOError, match="caller requires"):
        store.load_quantized(path, mode=other)
    plain = tmp_path / "plain"
    save_index(built, plain)
    with pytest.raises(IOError, match="no quantized tier"):
        store.load_quantized(plain)
    assert not store.has_quantized(store.read_manifest(plain))


def _rewrite_column(path, name, a):
    """Replace one column and its manifest entry (a consistent tamper)."""
    np.save(path / f"{name}.npy", a)
    manifest = json.loads((path / store.MANIFEST).read_text())
    manifest["arrays"][name] = store._array_entry(a, f"{name}.npy")
    (path / store.MANIFEST).write_text(json.dumps(manifest))


@pytest.mark.parametrize("fault", ["truncated_scale", "bit_flip",
                                   "generation_mismatch", "quant_dtype",
                                   "resid_dtype"])
def test_store_faults_fail_loudly(built, db, tmp_path, fault):
    path = tmp_path / "qidx"
    save_index(built, path, quantization="int8")
    if fault == "truncated_scale":
        scale = np.load(path / "qresid_scale_N8.npy")
        np.save(path / "qresid_scale_N8.npy", scale[:-1])
        with pytest.raises(IOError, match="qresid_scale_N8.*does not match"):
            store.load_quantized(path)
    elif fault == "bit_flip":
        target = path / "qseries.npy"
        raw = bytearray(target.read_bytes())
        raw[-8] ^= 0xFF
        target.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="qseries.*checksum"):
            store.load_quantized(path, verify=True)
        with pytest.raises(IOError, match="qseries.*checksum"):
            verify_store(path)
    elif fault == "generation_mismatch":
        # Stale scales beside a rebuilt full-precision column: refused,
        # while the full-precision view still loads.
        other = tfs.build_index(db[:built.size] * 1.5, CFG, normalize=False)
        _rewrite_column(path, "resid_N8",
                        np.ascontiguousarray(other.levels[0].residuals))
        with pytest.raises(IOError, match="generation mismatch"):
            store.load_quantized(path)
        load_index(path, verify=True)
    elif fault == "quant_dtype":
        _rewrite_column(path, "qseries_err",
                        np.load(path / "qseries_err.npy").astype(np.float64))
        with pytest.raises(store.StoreDtypeError, match="qseries_err.*float64"):
            store.load_quantized(path)
    else:
        manifest = store.read_manifest(path)
        assert manifest["dtypes"] == {"series": "float64",
                                      "resid": "float64", "words": "int32"}
        _rewrite_column(path, "resid_N8",
                        np.load(path / "resid_N8.npy").astype(np.float16))
        with pytest.raises(store.StoreDtypeError, match="resid_N8.*float16"):
            load_index(path)


def test_foreign_kinds_and_newer_formats_refused(built, tmp_path):
    path = tmp_path / "idx"
    save_index(built, path)
    manifest = store.read_manifest(path)
    (path / store.MANIFEST).write_text(json.dumps(dict(manifest, format=2)))
    with pytest.raises(IOError, match="newer than this reader"):
        load_index(path)
    (path / store.MANIFEST).write_text(json.dumps(
        dict(manifest, kind="fastsax-index-sharded")))
    with pytest.raises(IOError, match="not a fastsax-index store"):
        load_index(path)
    (path / store.MANIFEST).write_text(json.dumps(dict(
        manifest, config=dict(manifest["config"],
                               stack=["linfit_residual", "sax_word",
                                      "no_such_rep"]))))
    with pytest.raises(IOError, match="unregistered"):
        load_index(path)


# ---------------------------------------------------------------------------
# 3. From a store onto the device (the CPU here).
# ---------------------------------------------------------------------------

def test_device_index_from_store_is_the_direct_upload(built, jbuilt, db,
                                                      tmp_path):
    path = tmp_path / "idx"
    jstore.save_index(jbuilt, path)
    warm = teng.DeviceIndex.from_store(path, device="cpu")
    cold = teng.device_index_from_host(built, device="cpu")
    for a, b in zip((warm.series, warm.norms_sq, *warm.words,
                     *warm.residuals),
                    (cold.series, cold.norms_sq, *cold.words,
                     *cold.residuals)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # ...and holds the reference's warm start, leaf for leaf.
    jwarm = jeng.DeviceIndex.from_store(path)
    for a, b in zip((warm.series, *warm.words, *warm.residuals),
                    (jwarm.series, *jwarm.words, *jwarm.residuals)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(warm.norms_sq.numpy(),
                               np.asarray(jwarm.norms_sq), rtol=1e-6)
    q = make_queries(db, 4, seed=2)
    qr = teng.represent_queries(torch.as_tensor(q, dtype=torch.float32),
                                warm.levels, warm.alphabet, normalize=False)
    jqr = jeng.represent_queries(jnp.asarray(q, jnp.float32), jwarm.levels,
                                 jwarm.alphabet, normalize=False)
    i0, d0, e0 = teng.knn_query_auto(warm, qr, 5)
    i1, d1, e1 = jeng.knn_query_auto(jwarm, jqr, 5)
    assert bool(e0.all()) and bool(np.asarray(e1).all())
    assert np.array_equal(i0.numpy(), np.asarray(i1))
    np.testing.assert_allclose(d0.numpy(), np.asarray(d1), rtol=1e-5,
                               atol=1e-3)


def test_upload_host_array_casts_row_chunks(monkeypatch):
    # The chunked cast gives numpy's (and torch's) f64 -> f32 rounding,
    # whatever the chunk; read-only mmap-like inputs raise no warning.
    a = np.random.default_rng(0).standard_normal((37, 5))
    a.flags.writeable = False
    monkeypatch.setattr(teng, "_UPLOAD_CHUNK_BYTES", 64)
    with np.errstate(all="raise"):
        got = teng.upload_host_array(a, torch.float32, "cpu")
    assert torch.equal(got, torch.from_numpy(a.copy()).to(torch.float32))
    assert torch.equal(teng.upload_host_array(a[:0], torch.float32, "cpu"),
                       torch.empty((0, 5)))


def test_extended_stack_store_loads_on_host_refused_on_device(db, tmp_path):
    # A reference store with trend_slope loads on the host and warm-starts
    # the device index and the tier with its extra columns as stored.
    stack = ("linfit_residual", "sax_word", "trend_slope")
    jext = jfs.build_index(db[:64], jfs.FastSAXConfig(
        n_segments=(8, 16), alphabet=10, stack=stack), normalize=False)
    path = tmp_path / "ext"
    jstore.save_index(jext, path)
    loaded = load_index(path)
    assert loaded.config.stack == stack
    assert np.array_equal(loaded.levels[0].extra["trend_slope"],
                          jext.levels[0].extra["trend_slope"])
    dev = teng.DeviceIndex.from_store(path, device="cpu")
    jdev = jeng.device_index_from_host(jext)
    assert dev.stack == stack
    for li in range(2):
        np.testing.assert_array_equal(
            dev.extra[li]["trend_slope"].numpy(),
            np.asarray(jdev.extra[li]["trend_slope"]))
    tier = teng.TieredIndex.from_store(path, device="cpu")
    assert tier.dev.stack == stack
    np.testing.assert_array_equal(
        tier.dev.extra[1]["trend_slope"].numpy(),
        jext.levels[1].extra["trend_slope"].astype(np.int8))
    q = torch.as_tensor(db[:3], dtype=torch.float32)
    qr = teng.represent_queries(q, (8, 16), 10, normalize=False, stack=stack)
    ans, _ = teng.range_query(dev, qr, 1.0)
    idx, tans, _, exact = teng.quantized_range_query(tier, qr, 1.0)
    assert bool(exact.all()) and bool(ans[[0, 1, 2], [0, 1, 2]].all())
    for i in range(3):
        assert sorted(idx[i][tans[i]].tolist()) == \
            torch.nonzero(ans[i]).flatten().tolist()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_tiered_from_store_serves_the_stored_tier(built, jbuilt, db,
                                                  tmp_path, monkeypatch,
                                                  mode):
    path = tmp_path / "qidx"
    jstore.save_index(jbuilt, path, quantization=mode)

    def no_requantize(*a, **k):
        raise AssertionError("the stored tier was quantized again")

    monkeypatch.setattr(tq, "quantize_host_index", no_requantize)
    tiered, ids = teng.TieredIndex.from_store(path, with_ids=True,
                                              device="cpu")
    monkeypatch.undo()
    assert tiered.mode == mode and np.array_equal(ids, np.arange(256))
    assert isinstance(tiered.raw, np.memmap) and tiered.raw.dtype == np.float64
    direct = teng.TieredIndex.from_host(built, mode, device="cpu")
    for a, b in zip((tiered.dev.series, tiered.dev.series_err,
                     *tiered.dev.residuals, *tiered.dev.words),
                    (direct.dev.series, direct.dev.series_err,
                     *direct.dev.residuals, *direct.dev.words)):
        assert torch.equal(a, b)
    # Another mode than the stored one is quantized in memory.
    other = "bf16" if mode == "int8" else "int8"
    assert teng.TieredIndex.from_store(path, quantization=other,
                                       device="cpu").mode == other
    # Answers: the reference's tiered warm start, the same query set.
    q = make_queries(db, 4, seed=4)
    qr = teng.represent_queries(torch.as_tensor(q, dtype=torch.float32),
                                (8, 16), 10, normalize=False)
    jt = jeng.TieredIndex.from_store(path)
    jqr = jeng.represent_queries(jnp.asarray(q, jnp.float32), (8, 16), 10,
                                 normalize=False)
    i0, d0, e0 = teng.quantized_knn_query(tiered, qr, 5)
    i1, d1, e1 = jeng.quantized_knn_query(jt, jqr, 5)
    assert bool(e0.all()) and bool(np.asarray(e1).all())
    assert np.array_equal(i0.numpy(), np.asarray(i1))
    np.testing.assert_allclose(d0.numpy(), np.asarray(d1), rtol=1e-5,
                               atol=1e-3)


def test_from_store_without_a_device_raises_when_cuda_is_absent(
        built, tmp_path, monkeypatch):
    from repro_torch.core import subseq as tss
    from repro_torch.serve import (SearchService, ServeConfig,
                                   SubseqSearchService)

    save_index(built, tmp_path / "idx", quantization="int8")
    hidx = tss.build_subseq_index(
        make_wafer_like(2, 300, seed=0, normalize=False),
        tfs.FastSAXConfig(n_segments=(8, 16)), 64, 4)
    tss.save_subseq_index(hidx, tmp_path / "sub")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: teng.DeviceIndex.from_store(tmp_path / "idx"),
               lambda: teng.TieredIndex.from_store(tmp_path / "idx"),
               lambda: SearchService.from_store(tmp_path / "idx"),
               lambda: SearchService.from_store(
                   tmp_path / "idx", ServeConfig(quantization="int8")),
               lambda: SubseqSearchService.from_store(tmp_path / "sub")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    svc = SearchService.from_store(tmp_path / "idx", device="cpu")
    assert svc.backend.backend == "torch" and svc.backend.size == 256


def test_quantized_tier_columns_carry_across(built, jbuilt):
    # The store's column naming is shared: the port's tier flattens and
    # rebuilds through the reference's helpers and back.
    for mode in ("int8", "bf16"):
        tq_host = tq.quantize_host_index(built, mode)
        jq_host = jq.quantize_host_index(jbuilt, mode)
        t_cols, j_cols = tq.quant_arrays(tq_host), jq.quant_arrays(jq_host)
        assert list(t_cols) == list(j_cols)
        for name in t_cols:
            assert np.array_equal(t_cols[name], j_cols[name]), (mode, name)
        assert tq.quant_meta(tq_host, {"series": "x"}) == \
            jq.quant_meta(jq_host, {"series": "x"})
        back = tq.quant_from_arrays(mode, 128, 10, (8, 16), j_cols.__getitem__)
        assert_same_quant(back, tq_host)


def test_device_index_from_mutable_root_maps_ids(db, tmp_path):
    """After a delete, positions are not external ids: a load without the
    mapping refuses, and the mapping names the right rows, before and
    after compaction (the reference's test, through the port)."""
    from repro_torch.index.mutable import MutableIndex

    root = tmp_path / "mut"
    mi = MutableIndex.create(root, db[:16], CFG, normalize=False)
    mi.delete([5])
    for tiered in (False, True):
        cls = teng.TieredIndex if tiered else teng.DeviceIndex
        with pytest.raises(ValueError, match="with_ids=True"):
            cls.from_store(root, device="cpu")
    dev_u, ids_u = teng.DeviceIndex.from_store(root, with_ids=True,
                                               device="cpu")
    assert dev_u.size == 15 and 5 not in ids_u.tolist()
    qr = teng.represent_queries(torch.as_tensor(db[:1], dtype=torch.float32),
                                dev_u.levels, dev_u.alphabet, normalize=False)
    nn_all, _, _ = teng.knn_query_auto(dev_u, qr, 16)   # k > live count
    assert 5 not in ids_u[nn_all.numpy()[0]].tolist()
    tiered, t_ids = teng.TieredIndex.from_store(root, with_ids=True,
                                                device="cpu")
    assert np.array_equal(t_ids, ids_u) and tiered.mode == "int8"
    mi.compact()
    dev, ids = teng.DeviceIndex.from_store(root, with_ids=True, device="cpu")
    assert np.array_equal(ids, np.concatenate([np.arange(5),
                                               np.arange(6, 16)]))
    qr = teng.represent_queries(torch.as_tensor(db[6:7], dtype=torch.float32),
                                dev.levels, dev.alphabet, normalize=False)
    nn_idx, _, exact = teng.knn_query_auto(dev, qr, 1)
    assert bool(exact.all())
    assert int(nn_idx[0, 0]) == 5 and ids[int(nn_idx[0, 0])] == 6
