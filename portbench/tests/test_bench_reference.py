"""The reference's brute force against a naive loop at a tiny size, and
the judge against answers broken on purpose."""
import numpy as np
import pytest

from portbench.reference import brute, compare


def _znorm(x):
    x = np.asarray(x, np.float64)
    mu = x.mean(-1, keepdims=True)
    sd = np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True))
    return (x - mu) / np.maximum(sd, 1e-8)


def _naive_d2(rows, q):
    zq = _znorm(q)
    return np.array([float(np.sum((_znorm(r) - zq) ** 2)) for r in rows])


@pytest.fixture
def rows():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((300, 32)).cumsum(-1)).astype(np.float32)


def test_scan_matches_a_naive_loop(rows):
    rng = np.random.default_rng(4)
    qs = rows[:6] + 0.3 * rng.standard_normal((6, 32)).astype(np.float32)
    db = brute.RowDatabase(rows, "cpu")
    is_knn = [True, False, True, False, True, False]
    eps = [0.0, 3.0, 0.0, 5.0, 0.0, 4.0]
    got = brute.scan(db, qs, is_knn, eps, fetch=5, tau=0.0, block=64)
    for j, q in enumerate(qs):
        d2 = _naive_d2(rows, q)
        ids, dd = got[j]
        if is_knn[j]:
            want = np.lexsort((np.arange(d2.size), d2))[:5]
            assert ids.tolist() == want.tolist()
        else:
            want = np.flatnonzero(d2 <= eps[j] ** 2)
            assert ids.tolist() == want.tolist()
        np.testing.assert_allclose(dd, d2[ids], rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(brute.distances_sq(db, q, ids), d2[ids],
                                   rtol=1e-9, atol=1e-9)


def test_windows_match_a_naive_loop():
    rng = np.random.default_rng(5)
    streams = rng.standard_normal((2, 100)).cumsum(-1).astype(np.float32)
    db = brute.WindowDatabase(streams, 16, 1, "cpu")
    assert db.n_rows == 2 * 85
    wins = np.stack([streams[s, a:a + 16] for s in range(2)
                     for a in range(85)])
    q = wins[40] + 0.01
    d2 = _naive_d2(wins, q)
    (ids, dd), = brute.scan(db, q[None], [True], [0.0], fetch=20, tau=0.0,
                            block=50)
    assert ids.tolist() == np.lexsort((np.arange(d2.size), d2))[:20].tolist()
    s, a = db.stream_start(ids)
    kid, _ = brute.exclusion_greedy(ids, dd, s, a, 2, 8)
    assert kid[0] == 40 and not (s[0] == db.stream_start(kid[1:])[0][0]
                                 and abs(int(db.stream_start(kid[1:])[1][0])
                                         - 40) < 8)


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 1.0 + 2 ** -11,
                  -1.0 - 2 ** -11], np.float32)
    import torch
    got = brute.round_tf32(torch.as_tensor(x)).numpy()
    assert got.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                            -1.0 - 2 ** -10]


def test_judge_catches_broken_answers(rows):
    rng = np.random.default_rng(6)
    qs = rows[:4] + 0.3 * rng.standard_normal((4, 32)).astype(np.float32)
    db = brute.RowDatabase(rows, "cpu")
    reqs = [{"knn": j % 2 == 0, "eps": 4.0, "k": 3, "excl": 0}
            for j in range(4)]
    ref = brute.scan(db, qs, [r["knn"] for r in reqs],
                     [r["eps"] for r in reqs], 3, 1e-6)
    exact = []
    for (ids, d2), r in zip(ref, reqs):
        keep = slice(0, 3) if r["knn"] else d2 <= 16.0
        exact.append((ids[keep], np.sqrt(d2[keep])))
    ok = compare.judge(db, qs, reqs, exact, ref, 1e-6)
    assert ok["set_faults"] == 0 and ok["d2_gap"] < 1e-9
    # A distance off, an id dropped, an id swapped for a far one.
    off = [(i, d.copy()) for i, d in exact]
    off[0][1][0] += 0.01
    assert compare.judge(db, qs, reqs, off, ref, 1e-6)["d2_gap"] > 1e-3
    drop = list(exact)
    drop[1] = (exact[1][0][1:], exact[1][1][1:])
    assert compare.judge(db, qs, reqs, drop, ref, 1e-6)["set_faults"] == 1
    far = int(np.argmax(brute.distances_sq(db, qs[2], np.arange(300))))
    swap = list(exact)
    swap[2] = (np.r_[exact[2][0][:2], far], exact[2][1])
    assert compare.judge(db, qs, reqs, swap, ref, 1e-6)["set_faults"] == 1


# --- the scan in chunks of queries, and each distinct row judged once -------

def _scan_unchunked(db, queries, is_knn, eps, fetch, tau, precision="f64",
                    block=1 << 18):
    """``brute.scan`` as it was before it took the queries in chunks: every
    query against each block at once.  Kept as the oracle."""
    import torch

    dev = db.device
    zq = brute._prepare(torch.as_tensor(queries).to(dev), precision)
    is_knn = np.asarray(is_knn, bool)
    eps = np.asarray(eps, np.float64)
    M = zq.shape[0]
    knn_rows = np.flatnonzero(is_knn)
    rng_rows = np.flatnonzero(~is_knn)
    lim2 = eps[rng_rows] ** 2 + (0.0 if precision == "tf32" else tau)
    lim2 = torch.as_tensor(lim2, device=dev)[:, None]
    hits = []
    kf = min(int(fetch), db.n_rows)
    best_d = best_i = None
    for i0 in range(0, db.n_rows, block):
        i1 = min(i0 + block, db.n_rows)
        d2 = brute._d2(zq, brute._prepare(db.block(i0, i1), precision),
                       precision)
        if rng_rows.size:
            sub = d2[torch.as_tensor(rng_rows, device=dev)]
            qi, ri = torch.nonzero(sub <= lim2.to(sub.dtype), as_tuple=True)
            hits.append((qi.cpu().numpy(), (ri + i0).cpu().numpy(),
                         sub[qi, ri].double().cpu().numpy()))
        if knn_rows.size:
            sub = d2[torch.as_tensor(knn_rows, device=dev)].double()
            kk = min(kf, i1 - i0)
            vals, idx = torch.topk(sub, kk, dim=-1, largest=False)
            idx = idx + i0
            if best_d is not None:
                vals = torch.cat([best_d, vals], dim=-1)
                idx = torch.cat([best_i, idx], dim=-1)
                order = np.lexsort((idx.cpu().numpy(), vals.cpu().numpy()))
                order = torch.as_tensor(order[:, :kf], device=dev)
                vals = torch.gather(vals, -1, order)
                idx = torch.gather(idx, -1, order)
            best_d, best_i = vals, idx
        del d2
    out = [None] * M
    if rng_rows.size:
        qi = np.concatenate([h[0] for h in hits])
        ri = np.concatenate([h[1] for h in hits])
        dd = np.concatenate([h[2] for h in hits])
        order = np.lexsort((ri, qi))
        qi, ri, dd = qi[order], ri[order], dd[order]
        cuts = np.searchsorted(qi, np.arange(rng_rows.size + 1))
        for j, q in enumerate(rng_rows):
            sl = slice(cuts[j], cuts[j + 1])
            out[q] = (ri[sl].astype(np.int64), dd[sl])
    if knn_rows.size:
        bd, bi = best_d.cpu().numpy(), best_i.cpu().numpy()
        for j, q in enumerate(knn_rows):
            order = np.lexsort((bi[j], bd[j]))
            out[q] = (bi[j][order].astype(np.int64), bd[j][order])
    return out


CHUNK = 7
K, EXCL = 3, 4


def _database(kind):
    """A tiny database of each kind, its rows as an array, and a block
    size that cuts it into several blocks."""
    rng = np.random.default_rng(7)
    if kind == "rows":
        rows = rng.standard_normal((300, 32)).cumsum(-1).astype(np.float32)
        return brute.RowDatabase(rows, "cpu"), rows, 64
    streams = rng.standard_normal((2, 100)).cumsum(-1).astype(np.float32)
    db = brute.WindowDatabase(streams, 16, 1, "cpu")
    wins = np.stack([streams[s, a:a + 16] for s in range(2)
                     for a in range(85)])
    return db, wins, 50


def _queries(rows, m, seed):
    rng = np.random.default_rng(seed)
    at = rng.integers(0, len(rows), m)
    return rows[at] + 0.3 * rng.standard_normal(
        (m, rows.shape[1])).astype(np.float32)


def _mix(mix, m, seed):
    rng = np.random.default_rng(seed)
    is_knn = {"mixed": rng.random(m) < 0.5, "range": np.zeros(m, bool),
              "knn": np.ones(m, bool)}[mix]
    return is_knn, np.where(is_knn, 0.0, rng.uniform(2.0, 4.5, m))


@pytest.mark.parametrize("kind", ["rows", "windows"])
@pytest.mark.parametrize("m", [1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 2])
@pytest.mark.parametrize("mix", ["mixed", "range", "knn"])
@pytest.mark.parametrize("fetch", [K, K * 2 * EXCL])
def test_chunked_scan_matches_the_unchunked_one(monkeypatch, kind, m, mix,
                                                fetch):
    monkeypatch.setattr(brute, "QUERY_CHUNK", CHUNK)
    seen = []
    real = brute._d2

    def d2(zq, zx, precision):
        seen.append(zq.shape[0])
        return real(zq, zx, precision)

    db, rows, block = _database(kind)
    qs = _queries(rows, m, seed=m)
    is_knn, eps = _mix(mix, m, seed=m + 1)
    want = _scan_unchunked(db, qs, is_knn, eps, fetch, 1e-3, block=block)
    monkeypatch.setattr(brute, "_d2", d2)
    got = brute.scan(db, qs, is_knn, eps, fetch, 1e-3, block=block)
    assert seen and max(seen) <= CHUNK
    assert len(got) == m
    for (gi, gd), (wi, wd) in zip(got, want):
        assert gi.tolist() == wi.tolist()
        np.testing.assert_allclose(gd, wd, rtol=1e-12, atol=1e-12)
    assert any(ids.size for ids, _ in got)


def _check_every_request(db, queries, reqs, served, fetch, limits,
                         unanswered):
    """``harness.check`` as it was before it scanned each distinct row
    once: the unchunked scan over every request.  Kept as the oracle."""
    tau = float(limits["d2_gap_limit"])
    ref = _scan_unchunked(db, queries, [r["knn"] for r in reqs],
                          [r["eps"] for r in reqs], fetch, tau)
    got = compare.judge(db, queries, reqs, served, ref, tau)
    checks = {
        "d2_gap": {"value": got["d2_gap"], "limit": tau},
        "set_faults": {"value": got["set_faults"],
                       "limit": int(limits["set_faults_limit"])},
        "unanswered": {"value": int(unanswered),
                       "limit": int(limits["unanswered_limit"])},
        "judged_at_least": {"value": got["compared"], "limit": 1},
    }
    ok = (got["compared"] >= 1 and got["d2_gap"] <= tau
          and got["set_faults"] <= checks["set_faults"]["limit"]
          and unanswered <= checks["unanswered"]["limit"])
    return ok, checks


@pytest.mark.parametrize("kind", ["rows", "windows"])
def test_check_judges_each_distinct_row_once(monkeypatch, kind):
    from portbench import harness

    db, rows, _block = _database(kind)
    excl = EXCL if kind == "windows" else 0
    fetch = K * 2 * excl if excl else K
    limits = {"d2_gap_limit": 1e-3, "set_faults_limit": 0,
              "unanswered_limit": 0}
    queries = _queries(rows, 6, seed=11)
    is_knn = np.array([True, False, True, False, True, False])
    eps = np.where(is_knn, 0.0, 4.0)
    sent = np.array([0, 1, 2, 0, 3, 1, 0, 4, 2, 0, 5, 3, 0], np.int64)
    reqs = [{"knn": bool(is_knn[i]), "eps": float(eps[i]), "k": K,
             "excl": excl} for i in sent]
    # The program's answers: the reference's, in float32 distances.
    exact = _scan_unchunked(db, queries, is_knn, eps, fetch, 0.0)
    served = []
    for i in sent:
        ids, d2 = exact[i]
        if is_knn[i] and excl:
            s, a = db.stream_start(ids)
            ids, d2 = brute.exclusion_greedy(ids, d2, s, a, K, excl)
        elif is_knn[i]:
            ids, d2 = ids[:K], d2[:K]
        else:
            keep = d2 <= eps[i] ** 2
            ids, d2 = ids[keep], d2[keep]
        served.append((ids, np.sqrt(d2).astype(np.float32)))
    # Row 0 answered wrongly in two of its five requests: its nearest id
    # swapped for the farthest row, served at its own distance.
    d2_far = brute.distances_sq(db, queries[0], np.arange(db.n_rows))
    far = int(np.argmax(d2_far))
    for j in (3, 9):
        ids, d = served[j]
        served[j] = (np.r_[ids[1:], far],
                     np.r_[d[1:], np.sqrt(d2_far[far])].astype(np.float32))

    calls = []
    real = brute.scan

    def scan(db_, qs, knn, e, *a, **kw):
        calls.append((np.array(qs), list(knn), list(e)))
        return real(db_, qs, knn, e, *a, **kw)

    monkeypatch.setattr(brute, "scan", scan)
    ok, checks = harness.check(db, queries, sent, reqs, served, fetch,
                               limits, 0)
    want_ok, want = _check_every_request(db, queries[sent], reqs, served,
                                         fetch, limits, 0)
    distinct = np.unique(sent)
    assert len(calls) == 1
    assert np.array_equal(calls[0][0], queries[distinct])
    assert calls[0][1] == is_knn[distinct].tolist()
    assert calls[0][2] == eps[distinct].tolist()
    assert ok is want_ok is False
    assert checks["set_faults"] == want["set_faults"]
    assert checks["set_faults"]["value"] == 2
    assert checks["unanswered"] == want["unanswered"]
    assert checks["judged_at_least"] == want["judged_at_least"]
    assert checks["judged_at_least"]["value"] == sent.size
    assert checks["d2_gap"]["limit"] == want["d2_gap"]["limit"]
    assert abs(checks["d2_gap"]["value"] - want["d2_gap"]["value"]) <= 1e-12
    assert 0 < checks["d2_gap"]["value"] < limits["d2_gap_limit"]
