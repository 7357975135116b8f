"""The compaction of a dense answer before its copy to the host, on the CPU.

A dense pass of ``_SingleBackend`` (the fused engine's, or the torch
engine's after its dense switch) is compacted on the device by
``fused_query.compact_count`` and ``compact_write`` (``engine.compact_dense``)
and only the compact answers cross to the host.  Held here:

  * **the plain versions** (what the wrappers run on CPU tensors, and what
    ``tests/test_torch_gpu.py`` holds the card's kernels to) against a
    numpy reference built from ``np.flatnonzero``: empty rows and a batch
    whose C is 0, a row with every slot answered, answers on the tiles'
    boundaries and in the last partial tile, rows of padding, ragged and
    16-aligned widths;
  * **the service**: every request of ``SearchService`` and
    ``SubseqSearchService`` on the fused backend, batched and replayed
    alone, gets bit for bit the ids, order and distances that the select
    step gives on the dense row the pass copied before the compaction:
    range, k-NN and exclusion-zone k-NN;
  * **the counter**: ``answer_slots`` sums the counts the compaction kept;
  * **the step's least bytes** (``cost_model.compact_step_bytes``, its
    bound on the card) against a count made slot by slot.
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import cost_model
from repro_torch.core import engine as teng
from repro_torch.data.timeseries import make_queries, make_wafer_like
from repro_torch.kernels import fused_query as fq
from repro_torch.kernels import ref
from repro_torch.serve import (KIND_KNN, KIND_RANGE, OK, SearchService,
                               ServeConfig, SubseqSearchService)
from repro_torch.serve import service as service_mod
from repro_torch.serve.batcher import Request

TILE = fq.COMPACT_TILE


def numpy_compact(mask, d2):
    """The compact layout by ``np.flatnonzero``, row by row: ``(count,
    idx, d2)`` with −1 / +inf past each row's count."""
    count = mask.sum(axis=1).astype(np.int32)
    C = int(count.max(initial=0))
    idx = np.full((mask.shape[0], C), -1, np.int32)
    out = np.full((mask.shape[0], C), np.inf, np.float32)
    for i, row in enumerate(mask):
        s = np.flatnonzero(row)
        idx[i, :s.size] = s
        out[i, :s.size] = d2[i, s]
    return count, idx, out


def numpy_tile_counts(mask):
    B = mask.shape[1]
    return np.stack([mask[:, t:t + TILE].sum(axis=1)
                     for t in range(0, B, TILE)], axis=1).astype(np.int32)


def mask_case(name):
    """``(mask (Q, B) bool, d2 (Q, B) float32)``; d² is finite off the
    answers too, so a slot read outside them would show."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B = {"ragged": 37, "aligned": 48, "one_slot": 1}.get(name, 3 * TILE + 100)
    Q = 5
    mask = np.zeros((Q, B), bool)
    if name == "empty":
        pass
    elif name == "full_row":
        mask[1] = True
        mask[3, [0, B - 1]] = True
    elif name == "boundaries":
        for s in (0, 31, 32, TILE - 1, TILE, 2 * TILE - 1, 2 * TILE,
                  3 * TILE - 1, 3 * TILE, B - 2, B - 1):
            mask[0, s] = True
        mask[2, 3 * TILE:] = True          # the last partial tile, whole
        mask[4, TILE - 16:TILE + 16] = True  # across a tile boundary
    elif name == "padding_rows":
        mask[0] = rng.random(B) < 1e-3
        mask[1:] = False
        mask[1:, 12_345] = True            # ε = 0 replays: the own row
    elif name in ("ragged", "aligned"):
        mask = rng.random((Q, B)) < 0.4
        mask[0] = False
    elif name == "one_slot":
        mask[2, 0] = True
    else:   # sparse
        mask = rng.random((Q, B)) < 1e-3
    d2 = rng.random((Q, B), dtype=np.float32) * 7.0
    return mask, d2


CASES = ["empty", "full_row", "boundaries", "padding_rows", "ragged",
         "aligned", "one_slot", "sparse"]


@pytest.mark.parametrize("case", CASES)
def test_plain_count_equals_numpy(case):
    mask, _ = mask_case(case)
    tiles, count = ref.compact_count_ref(torch.as_tensor(mask), TILE)
    assert tiles.dtype == count.dtype == torch.int32
    np.testing.assert_array_equal(tiles.numpy(), numpy_tile_counts(mask))
    np.testing.assert_array_equal(count.numpy(), mask.sum(axis=1))


@pytest.mark.parametrize("case", CASES)
def test_plain_write_equals_numpy(case):
    mask, d2 = mask_case(case)
    count, want_idx, want_d2 = numpy_compact(mask, d2)
    idx, out = ref.compact_write_ref(torch.as_tensor(mask),
                                     torch.as_tensor(d2), want_idx.shape[1])
    assert idx.dtype == torch.int32 and out.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(out.numpy(), want_d2)
    # A wider C only adds padding.
    idx, out = ref.compact_write_ref(torch.as_tensor(mask),
                                     torch.as_tensor(d2), mask.shape[1])
    np.testing.assert_array_equal(idx.numpy()[:, :want_idx.shape[1]],
                                  want_idx)
    assert (idx.numpy()[:, want_idx.shape[1]:] == -1).all()
    assert np.isinf(out.numpy()[:, want_idx.shape[1]:]).all()


@pytest.mark.parametrize("case", CASES)
def test_compact_dense_equals_numpy(case):
    mask, d2 = mask_case(case)
    count, idx, out = teng.compact_dense(torch.as_tensor(mask),
                                         torch.as_tensor(d2))
    want = numpy_compact(mask, d2)
    assert isinstance(count, np.ndarray) and count.dtype == np.int32
    np.testing.assert_array_equal(count, want[0])
    np.testing.assert_array_equal(idx.numpy(), want[1])
    np.testing.assert_array_equal(out.numpy(), want[2])
    if case == "empty":
        assert idx.shape == out.shape == (mask.shape[0], 0)


@pytest.mark.parametrize("case", CASES)
def test_step_bytes_count_each_answer_tile_once(case):
    # The least bytes of the step, slot by slot: every mask byte once,
    # each mask byte of a tile that holds an answer once more, 4 bytes of
    # d² per answer, 8 per written slot, the tile counts written and read
    # (4 bytes each way), the row counts read.
    mask, _ = mask_case(case)
    Q, B = mask.shape
    tiles = numpy_tile_counts(mask)
    C = int(mask.sum(axis=1).max(initial=0))
    reread = sum(mask[i, t * TILE:(t + 1) * TILE].size
                 for i in range(Q) for t in range(tiles.shape[1])
                 if mask[i, t * TILE:(t + 1) * TILE].any())
    want = (mask.size + reread + 4 * int(mask.sum()) + 8 * Q * C
            + 8 * tiles.size + 4 * Q)
    assert cost_model.compact_step_bytes(tiles, B, TILE, C) == want


def test_wrappers_check_their_inputs():
    mask, d2 = mask_case("sparse")
    a, d = torch.as_tensor(mask), torch.as_tensor(d2)
    tiles, count = fq.compact_count(a)
    with pytest.raises(TypeError, match="bool"):
        fq.compact_count(a.to(torch.uint8))
    with pytest.raises(ValueError, match="C must be"):
        fq.compact_write(a, d, tiles, count, mask.shape[1] + 1)
    with pytest.raises(ValueError, match="tile_counts"):
        fq.compact_write(a, d, tiles[:, :1].contiguous(), count, 4)
    with pytest.raises(ValueError, match="rows"):
        fq.compact_count(torch.zeros((0, 8), dtype=torch.bool))
    # The plain versions count no launch.
    assert fq.compact_count.launches == fq.compact_write.launches == 0


# ---------------------------------------------------------------------------
# The served answers: the compact rows against the dense rows they replace.
# ---------------------------------------------------------------------------


def dense_twin(svc, monkeypatch) -> list:
    """Reply to every request twice: as served, from the compact row, and
    from the dense row of the same pass, which the copy carried before
    the compaction (``arange`` ids, the mask, the dense d²).  Returns the
    ``(request, twin)`` pairs; each batch's requests are replied to in row
    order after its pass, so the k-th reply after a compaction is row k."""
    passes = []
    inner_compact = service_mod.compact_dense

    def compact(answer, d2):
        passes.append([answer.numpy().copy(), d2.numpy().copy(), 0])
        return inner_compact(answer, d2)

    monkeypatch.setattr(service_mod, "compact_dense", compact)
    pairs = []
    inner_finish = svc._finish

    def finish(req, idx_row, answer_row, d2_row, ids_map, coverage=None):
        answer, d2, row = passes[-1]
        passes[-1][2] += 1
        # C is the pass's largest answer count.
        assert answer_row.size == idx_row.size == d2_row.size \
            == answer.sum(axis=1).max()
        twin = Request(kind=req.kind, query=req.query, epsilon=req.epsilon,
                       k=req.k, meta=req.meta)
        inner_finish(twin, np.arange(answer.shape[1], dtype=np.int32),
                     answer[row], d2[row], ids_map, coverage)
        inner_finish(req, idx_row, answer_row, d2_row, ids_map, coverage)
        pairs.append((req, twin))

    svc._finish = finish
    return pairs


def assert_pairs_equal(pairs):
    assert pairs
    for req, twin in pairs:
        assert req.status == twin.status == OK
        assert req.ids.dtype == twin.ids.dtype
        assert req.distances.dtype == twin.distances.dtype
        np.testing.assert_array_equal(req.ids, twin.ids)
        np.testing.assert_array_equal(req.distances, twin.distances)
        assert req.select_slots == twin.select_slots


K, B_DB, N_DB = 3, 700, 64


@pytest.fixture(scope="module")
def data():
    db = make_wafer_like(B_DB, N_DB, seed=21, normalize=False)
    return db, make_queries(db, 10, seed=22)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_served_answers_equal_the_dense_rows(data, backend, monkeypatch):
    db, qs = data
    # The torch engine goes dense on the first batch, whose range at
    # ε 100 answers every row and overflows capacities 16 and 64.
    cfg = ServeConfig(backend=backend, max_batch=8, max_queue=64,
                      max_wait_ms=5.0, normalize_queries=False,
                      dense_fallback_frac=0.0, capacity0=16)
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    pairs = dense_twin(svc, monkeypatch)
    # Queued before the dispatcher starts: a full batch of 8, then 3
    # padded to 4 (the padding rows replay the first at ε = 0).
    reqs = []
    for i, q in enumerate(qs[:11]):
        reqs.append(svc.submit_knn(q, K) if i % 2 else
                    svc.submit_range(q, (100.0, 2.5, 4.0)[i % 3]))
    with svc:
        assert all(r.wait(60.0) == OK for r in reqs)
    assert len(pairs) == len(reqs)
    svc.direct_query(KIND_KNN, qs[0], k=K)
    svc.direct_query(KIND_RANGE, qs[1], epsilon=2.5)
    assert len(pairs) == len(reqs) + 2
    assert_pairs_equal(pairs)
    assert sum(len(r.ids) for r in reqs if r.kind == KIND_RANGE) > 0
    assert all(len(r.ids) == K for r in reqs if r.kind == KIND_KNN)
    snap = svc.stats.snapshot()
    assert snap["stages"]["compact"]["count"] == snap["stages"]["copy"][
        "count"] > 0
    assert snap["answer_slots"] > 0


def test_subsequence_answers_equal_the_dense_rows(monkeypatch):
    rng = np.random.default_rng(23)
    streams = np.cumsum(rng.standard_normal((3, 600)), axis=1)
    svc = SubseqSearchService.from_streams(
        streams, 32, cfg=ServeConfig(max_batch=8, max_wait_ms=5.0,
                                     backend="cuda"), device="cpu")
    pairs = dense_twin(svc, monkeypatch)
    qsub = [streams[s, p:p + 32] + 0.01 * rng.standard_normal(32)
            for s, p in ((0, 40), (1, 300), (2, 555), (1, 17), (0, 400))]
    reqs = []
    for i, q in enumerate(qsub):
        reqs.append(svc.submit_subseq_knn(q, 2))
        reqs.append(svc.submit_subseq_range(q, 3.0))
        reqs.append(svc.submit_knn(q, 3))
    with svc:
        assert all(r.wait(60.0) == OK for r in reqs)
    svc.direct_subseq_knn(qsub[0], 2)
    svc.direct_subseq_range(qsub[1], 3.0)
    assert len(pairs) == len(reqs) + 2
    assert_pairs_equal(pairs)
    # The exclusion zone trims the fetched candidates to k.
    assert all(len(r.ids) == 2 for r in reqs[0::3])
    assert sum(len(r.ids) for r in reqs[1::3]) > len(qsub)


def test_replay_equals_its_batch_in_the_compact_layout(data):
    db, qs = data
    cfg = ServeConfig(backend="cuda", max_batch=8, max_queue=64,
                      max_wait_ms=5.0, normalize_queries=False)
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    reqs = [svc.submit_knn(q, K) if i % 2 else svc.submit_range(q, 2.5)
            for i, q in enumerate(qs[:8])]
    with svc:
        assert all(r.wait(60.0) == OK for r in reqs)
    for i, r in enumerate(reqs):
        ids, dist = (svc.direct_query(KIND_KNN, qs[i], k=K) if i % 2 else
                     svc.direct_query(KIND_RANGE, qs[i], epsilon=2.5))
        np.testing.assert_array_equal(ids, r.ids)
        np.testing.assert_array_equal(dist, r.distances)


def test_answer_slots_count_the_kept_slots(data, monkeypatch):
    db, qs = data
    counts = []
    inner = service_mod.compact_dense

    def compact(answer, d2):
        out = inner(answer, d2)
        counts.append(out[0])
        return out

    monkeypatch.setattr(service_mod, "compact_dense", compact)
    cfg = ServeConfig(backend="cuda", normalize_queries=False)
    svc = SearchService.from_series(db, cfg, normalize=False, device="cpu")
    svc.direct_query(KIND_RANGE, qs[0], epsilon=4.0)
    svc.direct_query(KIND_KNN, qs[1], k=K)
    snap = svc.stats.snapshot()
    assert len(counts) == 2
    assert snap["answer_slots"] == sum(int(c.sum()) for c in counts) > 0
    # Bytes: a count, C ids and C d² per query, and the overflow flag.
    assert snap["d2h_bytes"] == sum(c.size * (4 + 8 * int(c.max()) + 1)
                                    for c in counts)
    assert svc.backend.last_answer_slots == int(counts[-1].sum())
