"""The reply's select step (``serve.service._select``), on the CPU.

``_select`` takes its candidates from the answer mask's slots, which is
exact because every engine a backend serves from sets d² = +inf off its
answers ("d² finite ⇒ answer").  Held here:

  * **equivalence**: on dense (Q, B) rows and compact (Q, C) rows, k-NN
    and range, ties, short and empty answer sets, NaN and +inf inside the
    mask, the select equals the full-row select it replaced (kept below
    as the oracle) bit for bit: ids, distances, their order and dtypes;
    and so does the subsequence service's exclusion greedy on top;
  * **the invariant** on the output of every engine entry point a backend
    serves from, on the CPU (the fused pass runs the kernels' plain
    versions here; ``tests/test_torch_gpu.py`` holds the card's);
  * **the counter**: ``select_slots`` rises by the answer counts of the
    rows replied to, batched or direct, and shows in the snapshot and the
    metrics text.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import dist_search as ds
from repro_torch.core import engine as teng
from repro_torch.core.fastsax import FastSAXConfig, build_index
from repro_torch.core.options import SearchOptions
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.serve import (KIND_KNN, KIND_RANGE, OK, SearchService,
                               ServeConfig, SubseqSearchService)
from repro_torch.serve import service as service_mod
from repro_torch.serve.batcher import Request
from repro_torch.serve.stats import StatsTracker


def select_full_row(req, idx_row, answer_row, d2_row):
    """The select step before it read the answer mask: a sort of the
    whole row for k-NN, two whole-row scans for range."""
    if req.kind == KIND_KNN:
        finite = np.isfinite(d2_row)
        order = np.lexsort((np.arange(d2_row.size), d2_row))
        order = order[finite[order]][: req.k]
        return idx_row[order], np.sqrt(d2_row[order])
    mask = answer_row & np.isfinite(d2_row)
    return idx_row[mask], np.sqrt(d2_row[mask])


DENSE_B, COMPACT_C, PER_STREAM = 1 << 16, 64, 1 << 14


def make_row(layout, n_answers, seed, ties=False, odd=False):
    """One row of a pass's ``(idx, answer, d2)`` holding the invariant:
    dense, slot = row; compact, the answers packed into the low slots in
    row order, −1 and +inf behind them.  ``ties`` draws d² from a few
    values; ``odd`` puts a NaN and a +inf inside the mask."""
    rng = np.random.default_rng(seed)
    if layout == "dense":
        size = DENSE_B
        idx = np.arange(size, dtype=np.int32)
        slots = np.sort(rng.choice(size, n_answers, replace=False))
    else:
        size = COMPACT_C
        slots = np.arange(n_answers)
        idx = np.full(size, -1, np.int32)
        idx[slots] = np.sort(rng.choice(DENSE_B, n_answers, replace=False))
    answer = np.zeros(size, bool)
    answer[slots] = True
    vals = (rng.integers(0, 3, n_answers).astype(np.float32) if ties
            else rng.random(n_answers, dtype=np.float32) * 9.0)
    d2 = np.full(size, np.inf, np.float32)
    d2[slots] = vals
    if odd and n_answers >= 2:
        d2[slots[0]] = np.nan
        d2[slots[-1]] = np.inf
    return idx, answer, d2


def window_meta(ids):
    ids = np.asarray(ids)
    return ids // PER_STREAM, ids % PER_STREAM


# (layout, kind, k, answers, ties, odd)
SELECT_CASES = {
    "dense-knn-k1": ("dense", KIND_KNN, 1, 40, False, False),
    "dense-knn-k5": ("dense", KIND_KNN, 5, 40, False, False),
    "dense-knn-k128": ("dense", KIND_KNN, 128, 300, False, False),
    "dense-knn-ties": ("dense", KIND_KNN, 5, 40, True, False),
    "dense-knn-fewer-than-k": ("dense", KIND_KNN, 128, 20, False, False),
    "dense-knn-none": ("dense", KIND_KNN, 5, 0, False, False),
    "dense-knn-nan-inf": ("dense", KIND_KNN, 5, 12, False, True),
    "compact-knn-k1": ("compact", KIND_KNN, 1, 30, False, False),
    "compact-knn-k5": ("compact", KIND_KNN, 5, 30, False, False),
    "compact-knn-k128": ("compact", KIND_KNN, 128, 64, False, False),
    "compact-knn-ties": ("compact", KIND_KNN, 5, 30, True, False),
    "compact-knn-none": ("compact", KIND_KNN, 5, 0, False, False),
    "compact-knn-nan-inf": ("compact", KIND_KNN, 5, 9, False, True),
    "dense-range-0": ("dense", KIND_RANGE, 0, 0, False, False),
    "dense-range-1": ("dense", KIND_RANGE, 0, 1, False, False),
    "dense-range-3": ("dense", KIND_RANGE, 0, 3, False, False),
    "dense-range-20000": ("dense", KIND_RANGE, 0, 20000, False, False),
    "dense-range-nan-inf": ("dense", KIND_RANGE, 0, 7, False, True),
    "compact-range-0": ("compact", KIND_RANGE, 0, 0, False, False),
    "compact-range-1": ("compact", KIND_RANGE, 0, 1, False, False),
    "compact-range-3": ("compact", KIND_RANGE, 0, 3, False, False),
    "compact-range-nan-inf": ("compact", KIND_RANGE, 0, 7, False, True),
}


def assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("case", list(SELECT_CASES), ids=list(SELECT_CASES))
def test_select_equals_full_row_select(case):
    layout, kind, k, n_answers, ties, odd = SELECT_CASES[case]
    idx, answer, d2 = make_row(layout, n_answers, seed=len(case), ties=ties,
                               odd=odd)
    excl = 64
    meta = ({"subseq_k": max(1, k // 4), "excl": excl}
            if kind == KIND_KNN else None)
    req = Request(kind=kind, query=np.zeros(4, np.float32), k=k, meta=meta)
    rows, dist = service_mod._select(req, idx, answer, d2)
    want_rows, want_dist = select_full_row(req, idx, answer, d2)
    assert_bitwise(rows, want_rows)
    assert_bitwise(dist, want_dist)
    assert req.select_slots == n_answers
    if kind == KIND_KNN:
        # The exclusion greedy of the subsequence service on top.
        svc = types.SimpleNamespace(
            sidx=types.SimpleNamespace(window_meta=window_meta))
        got = SubseqSearchService._postprocess(svc, req, rows, dist)
        want = SubseqSearchService._postprocess(svc, req, want_rows,
                                                want_dist)
        assert_bitwise(got[0], want[0])
        assert_bitwise(got[1], want[1])


@pytest.mark.parametrize("size", [0, 1, 511, 512, 513, 5000, (1 << 16) + 77])
@pytest.mark.parametrize("density", [0.0, 1e-4, 0.01, 0.5, 1.0])
def test_answer_slots_equal_flatnonzero(size, density):
    rng = np.random.default_rng(size)
    row = rng.random(size) < density
    if size:
        row[-1] = density > 0      # the ragged tail
    got = service_mod._answer_slots(row)
    want = np.flatnonzero(row)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The invariant, on every engine entry point a backend serves from.
# ---------------------------------------------------------------------------

B, N, LEVELS, ALPHA, K = 403, 64, (8, 16), 10, 5
IS_KNN = np.array([True, False, True, False, True, False])
EPS = np.array([0.0, 2.0, 0.0, 3.0, 0.0, 6.0], np.float32)


@pytest.fixture(scope="module")
def data():
    db = make_wafer_like(B, N, seed=11)
    host = build_index(db, FastSAXConfig(n_segments=LEVELS, alphabet=ALPHA),
                       normalize=False)
    qs = make_queries(db, IS_KNN.size, seed=12)
    return db, host, qs


def _qr(qs):
    return teng.represent_queries(torch.as_tensor(qs, dtype=torch.float32),
                                  LEVELS, ALPHA, normalize=False)


def _valid_mask():
    vm = torch.ones(B, dtype=torch.bool)
    vm[::7] = False
    return vm


def run_entry(entry, data):
    db, host, qs = data
    eps, knn = torch.as_tensor(EPS), torch.as_tensor(IS_KNN)
    if entry.startswith("quantized_mixed_query"):
        tier = teng.TieredIndex.from_host(host, entry.split("-")[1],
                                          device="cpu")
        return teng.quantized_mixed_query(tier, _qr(qs), eps, knn, K)
    if entry.startswith("distributed_quantized"):
        mesh = ds.make_data_mesh(3, device="cpu")
        tier = teng.TieredIndex.from_host(host, "int8", device="cpu")
        dti = ds.distributed_tiered_index(tier, mesh)
        return ds.distributed_quantized_mixed_query(
            dti, qs, EPS, IS_KNN, K, mesh,
            options=SearchOptions(backend="torch", normalize_queries=False))
    if entry.startswith("distributed_mixed_query"):
        mesh = ds.make_data_mesh(3, device="cpu")
        padded, nv = ds.pad_database(db, 3)
        idx = ds.distributed_build(padded, LEVELS, ALPHA, mesh, n_valid=nv)
        return ds.distributed_mixed_query(
            idx, qs, EPS, IS_KNN, K, mesh,
            options=SearchOptions(backend=entry.split("-")[1], capacity=32,
                                  normalize_queries=False))
    index = teng.device_index_from_host(host, device="cpu")
    vm = _valid_mask() if entry.endswith("-masked") else None
    if entry.startswith("mixed_query_dense"):
        return teng.mixed_query_dense(index, _qr(qs), eps, knn, K,
                                      valid_mask=vm)
    if entry.startswith("mixed_query_fused"):
        return teng.mixed_query_fused(index, _qr(qs), eps, knn, K,
                                      valid_mask=vm)
    return teng.mixed_query(index, _qr(qs), eps, knn, K, capacity=32,
                            valid_mask=vm)


ENTRIES = ["mixed_query", "mixed_query-masked", "mixed_query_dense",
           "mixed_query_dense-masked", "mixed_query_fused",
           "mixed_query_fused-masked", "quantized_mixed_query-int8",
           "quantized_mixed_query-bf16", "distributed_mixed_query-torch",
           "distributed_mixed_query-cuda", "distributed_quantized_mixed_query"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_engine_outputs_hold_d2_finite_only_on_answers(entry, data):
    idx, answer, d2 = (t.cpu().numpy() for t in run_entry(entry, data)[:3])
    assert answer.dtype == bool and answer.any()
    assert np.all(answer | ~np.isfinite(d2))
    # So the select reads the rows exactly as the full-row select did.
    for i, knn in enumerate(IS_KNN):
        req = Request(kind=KIND_KNN if knn else KIND_RANGE,
                      query=np.zeros(N, np.float32), k=K)
        got = service_mod._select(req, idx[i], answer[i], d2[i])
        want = select_full_row(req, idx[i], answer[i], d2[i])
        assert_bitwise(got[0], want[0])
        assert_bitwise(got[1], want[1])
        if knn:
            assert got[0].size == K


# ---------------------------------------------------------------------------
# The counter.
# ---------------------------------------------------------------------------


def test_select_slots_zero_before_traffic():
    assert StatsTracker().snapshot()["select_slots"] == 0


def test_select_slots_counts_the_answers_read(data, monkeypatch):
    db, _, qs = data
    counts = []
    inner = service_mod._select

    def counted(req, idx_row, answer_row, d2_row):
        counts.append(int(np.count_nonzero(answer_row)))
        return inner(req, idx_row, answer_row, d2_row)

    monkeypatch.setattr(service_mod, "_select", counted)
    cfg = ServeConfig(max_batch=8, max_queue=64, max_wait_ms=5.0,
                      normalize_queries=False)
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    with svc:
        reqs = [svc.submit_knn(q, K) if knn else svc.submit_range(q, e)
                for q, knn, e in zip(qs, IS_KNN, EPS)]
        assert all(r.wait(60.0) == OK for r in reqs)
    snap = svc.stats.snapshot()
    assert len(counts) == len(reqs) and sum(counts) > 0
    assert snap["select_slots"] == sum(r.select_slots for r in reqs) \
        == sum(counts)
    batched = snap["select_slots"]
    # A direct replay adds its own row's answers the same way.
    svc.direct_query(KIND_KNN, qs[0], k=K)
    svc.direct_query(KIND_RANGE, qs[1], epsilon=float(EPS[1]))
    snap = svc.stats.snapshot()
    assert len(counts) == len(reqs) + 2
    assert snap["select_slots"] == batched + counts[-2] + counts[-1]
    assert f"repro_select_slots_total {snap['select_slots']}" \
        in svc.metrics_text()
