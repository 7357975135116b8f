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
