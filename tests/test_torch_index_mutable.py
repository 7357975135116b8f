"""The port's mutable index against the reference's and a fresh rebuild.

The reference's guarantee (``tests/test_index_mutable.py``), through the
port: any interleaving of inserts, deletes and compactions answers range
and k-NN queries as a fresh ``build_index`` over the live rows does
(interleavings drawn from seeds, one case each).  A root written by either
package opens in the other with equal live rows and ids, deltas and
tombstones included, and the two give the same byte layout.  Crash windows
patch ``os.rename``.  Everything runs on the CPU.
"""
import numpy as np
import pytest

from repro.core.fastsax import FastSAXConfig as JConfig
from repro.index.mutable import MutableIndex as JMutable
from repro_torch.core.fastsax import (FastSAXConfig, build_index,
                                      represent_query)
from repro_torch.core.search import fastsax_knn_query, fastsax_range_query
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.index import quantized as tq
from repro_torch.index import store
from repro_torch.index.mutable import MutableIndex

CFG = FastSAXConfig(n_segments=(4, 8), alphabet=8)
JCFG = JConfig(n_segments=(4, 8), alphabet=8)
LENGTH = 64
EPSILONS = (1.0, 2.5, 50.0)     # selective, moderate, match-everything
SEEDS = [0, 1, 7, 42, 1234, 99991, 2 ** 20 + 3, 2 ** 31 - 2]


def _pool(seed: int, n: int = 256) -> np.ndarray:
    return make_wafer_like(n_series=n, length=LENGTH, seed=seed,
                           normalize=False)


def _check_equivalence(mi, pool: np.ndarray, row_of: dict,
                       queries: np.ndarray) -> None:
    """Mutated index answers == fresh rebuild over the live rows."""
    live_ids = mi.live_ids
    fresh = build_index(pool[[row_of[i] for i in live_ids]], CFG)
    for q in queries:
        qr = represent_query(q, CFG)
        for eps in EPSILONS:
            got_ids, got_d = mi.range_query(q, eps)
            ref = fastsax_range_query(fresh, qr, eps)
            assert np.array_equal(np.sort(got_ids), live_ids[ref.answers])
            assert np.allclose(np.sort(got_d), np.sort(ref.distances))
        for k in (1, 5, mi.n_live + 3):   # k > live count must also agree
            got_ids, got_d = mi.knn_query(q, k)
            ref = fastsax_knn_query(fresh, qr, min(k, mi.n_live))
            assert np.array_equal(got_ids, live_ids[ref.indices])
            assert np.allclose(got_d, ref.distances)


def _mutate(mi, pool, rng, cursor, row_of, next_id, steps):
    """Apply ``steps`` random inserts / deletes / compactions."""
    for _ in range(steps):
        op = rng.choice(["insert", "delete", "compact"])
        if op == "insert" and cursor < pool.shape[0]:
            nb = min(int(rng.integers(1, 33)), pool.shape[0] - cursor)
            ids = mi.insert(pool[cursor:cursor + nb])
            assert np.array_equal(ids, np.arange(next_id, next_id + nb))
            row_of.update({next_id + j: cursor + j for j in range(nb)})
            next_id += nb
            cursor += nb
        elif op == "delete" and mi.n_live > 8:
            nd = int(rng.integers(1, min(8, mi.n_live - 4)))
            mi.delete(rng.choice(mi.live_ids, size=nd, replace=False))
        elif op == "compact":
            mi.compact()
    return cursor, next_id


@pytest.mark.parametrize("seed", SEEDS)
def test_interleaved_mutations_match_fresh_rebuild(tmp_path, seed):
    rng = np.random.default_rng(seed)
    pool = _pool(seed % 7)
    queries = make_queries(pool, 2, seed=seed % 11)
    cursor = 48
    mi = MutableIndex.create(tmp_path / "idx", pool[:cursor], CFG)
    row_of = dict(enumerate(range(cursor)))   # external id -> pool row
    _mutate(mi, pool, rng, cursor, row_of, cursor,
            int(rng.integers(3, 7)))
    _check_equivalence(mi, pool, row_of, queries)
    # Reopened from disk, the committed epoch answers the same.
    _check_equivalence(MutableIndex.open(tmp_path / "idx"), pool, row_of,
                       queries)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_roots_cross_load(tmp_path, writer, quantization):
    """Deltas and tombstones written by one package open in the other:
    the same live rows, ids, generation and answers; and the same
    mutations give byte-identical roots."""
    pool = _pool(3)
    roots = {}
    for who, cls, cfg in (("reference", JMutable, JCFG),
                          ("port", MutableIndex, CFG)):
        root = tmp_path / who
        mi = cls.create(root, pool[:64], cfg, quantization=quantization)
        ids = mi.insert(pool[64:96])
        mi.delete([2, 40, int(ids[3])])
        mi.insert(pool[96:100])
        roots[who] = root
    files = sorted(str(p.relative_to(roots["reference"]))
                   for p in roots["reference"].rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(roots["port"]))
                           for p in roots["port"].rglob("*") if p.is_file())
    for name in files:
        assert (roots["reference"] / name).read_bytes() == \
            (roots["port"] / name).read_bytes(), name
    root = roots[writer]
    mine = MutableIndex.open(root)
    theirs = JMutable.open(root)
    assert mine.generation == theirs.generation == 3
    assert mine.quantization == theirs.quantization == quantization
    assert np.array_equal(mine.ids, theirs.ids)
    assert np.array_equal(mine.live_ids, theirs.live_ids)
    a, a_ids = mine.live_index()
    b, b_ids = theirs.live_index()
    assert np.array_equal(a_ids, b_ids) and a.size == 97
    assert np.array_equal(a.series, b.series)
    for x, y in zip(a.levels, b.levels):
        assert np.array_equal(x.words, y.words)
        assert np.array_equal(x.residuals, y.residuals)
    assert mine.info() == theirs.info()
    for q in make_queries(pool, 2, seed=5):
        for got, want in ((mine.range_query(q, 2.5),
                           theirs.range_query(q, 2.5)),
                          (mine.knn_query(q, 5), theirs.knn_query(q, 5))):
            assert np.array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    # A compaction by the other package still opens here.
    (JMutable if writer == "port" else MutableIndex).open(root).compact()
    again = MutableIndex.open(root)
    assert again.compacted and again.n_rows == 97
    assert np.array_equal(again.live_ids, a_ids)
    assert again.verify()


def test_delete_then_compact_then_insert(tmp_path):
    pool = _pool(3)
    mi = MutableIndex.create(tmp_path / "idx", pool[:64], CFG)
    mi.delete(np.arange(0, 64, 2))            # kill every even id
    assert mi.n_live == 32
    mi.compact()
    assert mi.n_rows == 32                    # tombstones physically gone
    assert np.array_equal(mi.live_ids, np.arange(1, 64, 2))
    ids = mi.insert(pool[64:80])
    assert ids[0] == 64                       # ids never reused
    row_of = {**{i: i for i in range(64)},
              **{64 + j: 64 + j for j in range(16)}}
    _check_equivalence(mi, pool, row_of, make_queries(pool, 2, seed=9))


def test_delete_validation(tmp_path):
    mi = MutableIndex.create(tmp_path / "idx", _pool(4)[:32], CFG)
    with pytest.raises(KeyError, match="unknown"):
        mi.delete([99])
    with pytest.raises(KeyError, match="duplicate"):
        mi.delete([5, 5])
    assert mi.n_live == 32
    mi.delete([7])
    with pytest.raises(KeyError, match="already deleted"):
        mi.delete([7])
    mi.delete(np.setdiff1d(np.arange(32), [7]))   # everything is now dead
    with pytest.raises(ValueError, match="refusing to compact"):
        mi.compact()
    with pytest.raises(FileExistsError):
        MutableIndex.create(tmp_path / "idx", _pool(4)[:8], CFG)
    with pytest.raises(ValueError, match="series must be"):
        mi.insert(_pool(4)[:2, :32])


def test_mutation_crash_leaves_previous_epoch(tmp_path, monkeypatch):
    pool = _pool(5)
    root = tmp_path / "idx"
    mi = MutableIndex.create(root, pool[:48], CFG)
    mi.delete([3])
    q = make_queries(pool, 1, seed=2)[0]
    before_range = mi.range_query(q, 2.5)
    before_knn = mi.knn_query(q, 5)

    def boom(*a, **k):
        raise OSError("injected crash: writer killed")

    monkeypatch.setattr(store.os, "rename", boom)
    with pytest.raises(OSError, match="injected crash"):
        mi.insert(pool[48:80])
    with pytest.raises(OSError, match="injected crash"):
        MutableIndex.open(root).compact()
    monkeypatch.undo()

    survivor = MutableIndex.open(root)
    assert survivor.n_live == 47
    for name, _, _ in survivor._segments:
        store.verify_store(root / name)
    after_range = survivor.range_query(q, 2.5)
    after_knn = survivor.knn_query(q, 5)
    assert np.array_equal(before_range[0], after_range[0])
    assert np.array_equal(before_knn[0], after_knn[0])
    assert np.allclose(before_knn[1], after_knn[1])
    survivor.insert(pool[48:80])
    survivor.compact()
    assert survivor.n_live == 79


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_quantized_append_compact_round_trip(tmp_path, mode):
    """Every segment of a quantized epoch carries the tier; after a
    compaction it equals, bit for bit, the tier of a fresh rebuild over
    the live rows (the folded rows are quantized anew)."""
    pool = _pool(8)
    root = tmp_path / "idx"
    mi = MutableIndex.create(root, pool[:48], CFG, quantization=mode)
    assert mi.quantization == mode
    ids = mi.insert(pool[48:80])
    mi.delete([3, 7, int(ids[0])])
    mi.compact()
    reopened = MutableIndex.open(root)
    assert reopened.quantization == mode and reopened.compacted
    loaded = store.load_quantized(reopened.base_dir, verify=True, mode=mode)
    live, live_ids = reopened.live_index()
    fresh = tq.quantize_host_index(
        build_index(pool[[i for i in live_ids]], CFG), mode)
    for f in ("series", "series_err", "norms_sq"):
        assert np.array_equal(np.asarray(getattr(loaded, f)),
                              getattr(fresh, f))
    for a, b in zip(loaded.levels, fresh.levels):
        for f in ("words", "residuals", "err") + (
                ("scale", "zero") if mode == "int8" else ()):
            assert np.array_equal(np.asarray(getattr(a, f)), getattr(b, f))
    reopened.insert(pool[80:96])
    delta = [name for name, _, _ in reopened._segments][-1]
    assert store.load_quantized(root / delta, mode=mode).size == 16


def test_quantization_mode_is_the_epochs(tmp_path):
    with pytest.raises(tq.QuantizationError, match="quantization"):
        MutableIndex.create(tmp_path / "bad", _pool(0)[:8], CFG,
                            quantization="fp4")
    mi = MutableIndex.create(tmp_path / "idx", _pool(1)[:16], CFG)
    assert mi.quantization == "none"
    with pytest.raises(IOError, match="no quantized tier"):
        store.load_quantized(mi.base_dir)


def test_subscribe_unsubscribe(tmp_path):
    pool = _pool(2)
    mi = MutableIndex.create(tmp_path / "idx", pool[:64], CFG)
    seen = []
    unsub = mi.subscribe(lambda m: seen.append(m.generation))
    mi.insert(pool[64:66])
    assert seen == [1] and mi.generation == 1
    mi.compact()
    assert seen == [1, 2]
    unsub()
    mi.delete([0])
    assert seen == [1, 2], "an unsubscribed listener must not fire"


def test_search_view_carries_sentinels(tmp_path):
    pool = _pool(6)
    mi = MutableIndex.create(tmp_path / "idx", pool[:40], CFG)
    index, ids = mi.search_index()
    assert index is mi._segments[0][1]        # compacted: no copy
    mi.delete([1, 30])
    index, ids = mi.search_index()
    assert index.size == 40 and np.array_equal(ids, np.arange(40))
    for lv in index.levels:
        assert np.all(lv.residuals[[1, 30]] == 1e30)
    assert np.all(index.series[[1, 30]] == 1e6)
    live, live_ids = mi.live_index()
    assert live.size == 38 and 1 not in live_ids and 30 not in live_ids
    gen, snap, snap_ids = mi.live_snapshot()
    assert gen == mi.generation == 1 and np.array_equal(snap_ids, live_ids)
    assert np.array_equal(snap.series, live.series)
