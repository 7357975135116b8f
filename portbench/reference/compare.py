"""Judging served answers against the reference.

The program computes squared distances in float32 and serves their
roots, so answers are judged on d² (the served distance squared), with
one tolerance ``tau`` on d² (the limit of ``d2_gap``):

  * range: every served id with d² ≤ ε² + τ, every row with
    d² ≤ ε² − τ served, no id twice;
  * k-NN: min(k, rows) distinct ids, each with d² ≤ r + τ (r the
    reference's k-th d²), every row with d² < r − τ served;
  * k-NN under an exclusion zone: as many windows as the reference's
    greedy keeps, no two on one stream closer than the zone, the i-th
    served d² within τ of the greedy's i-th;
  * every served d² within τ of the reference's d² of its id
    (``d2_gap`` is the widest such gap).

A request whose ids break a rule counts once in ``set_faults``.
"""
from __future__ import annotations

import numpy as np

from . import brute


def _lookup(rid: np.ndarray, rd: np.ndarray, sid: np.ndarray) -> tuple:
    """``(known, d2)``: which served ids the reference's list holds, and
    their reference d² (nan elsewhere)."""
    d_ref = np.full(sid.size, np.nan)
    known = np.zeros(sid.size, bool)
    if rid.size:
        order = np.argsort(rid, kind="stable")
        at = np.minimum(np.searchsorted(rid[order], sid), rid.size - 1)
        known = rid[order][at] == sid
        d_ref[known] = rd[order][at[known]]
    return known, d_ref


def judge(db, queries: np.ndarray, reqs: list, served: list, ref: list,
          tau: float) -> dict:
    """``reqs``: per request ``{"knn": bool, "eps": float, "k": int,
    "excl": int}``; ``served``: per request ``(ids, distances)``;
    ``ref``: per request ``(ids, d2)`` from :func:`brute.scan` at this
    ``tau``; ``queries``: the raw query of each request."""
    gap = 0.0
    faults = 0
    for j, (rq, (sid, sd), (rid, rd)) in enumerate(zip(reqs, served, ref)):
        sid = np.asarray(sid, np.int64)
        s2 = np.asarray(sd, np.float64) ** 2
        bad = sid.size != np.unique(sid).size
        known, d_ref = _lookup(rid, rd, sid)
        if not rq["knn"]:
            # The reference keeps every row with d² ≤ ε² + τ: an id it
            # does not hold lies outside.
            bad |= not known.all()
            bad |= not np.isin(rid[rd <= rq["eps"] ** 2 - tau], sid).all()
        else:
            if (~known).any():
                d_ref[~known] = brute.distances_sq(db, queries[j],
                                                   sid[~known])
                known[:] = True
            excl = int(rq.get("excl", 0))
            if excl > 0:
                s, a = db.stream_start(rid)
                _gid, gd = brute.exclusion_greedy(rid, rd, s, a, rq["k"],
                                                  excl)
                ss, sa = db.stream_start(sid)
                close = any(ss[x] == ss[y] and abs(sa[x] - sa[y]) < excl
                            for x in range(sid.size) for y in range(x))
                bad |= sid.size != gd.size or close
                if sid.size == gd.size:
                    bad |= bool(np.any(np.abs(np.sort(s2) - gd) > tau))
            else:
                m = min(int(rq["k"]), db.n_rows)
                r = rd[m - 1]
                bad |= sid.size != m
                bad |= bool(np.any(d_ref > r + tau))
                bad |= not np.isin(rid[:m][rd[:m] < r - tau], sid).all()
        g = np.abs(s2[known] - d_ref[known])
        if g.size:
            gap = max(gap, float(g.max()))
        faults += int(bool(bad))
    return {"d2_gap": gap, "set_faults": faults, "compared": len(reqs)}


def control_answers(db, queries: np.ndarray, reqs: list, fetch: int,
                    block: int = 1 << 18) -> list:
    """The control's answers in the served form ``(ids, distances)``:
    the scan in TF32, range rows with d² ≤ ε², the k nearest (greedy
    under an exclusion zone)."""
    is_knn = [r["knn"] for r in reqs]
    eps = [r["eps"] for r in reqs]
    got = brute.scan(db, queries, is_knn, eps, fetch, 0.0, precision="tf32",
                     block=block)
    out = []
    for rq, (ids, d2) in zip(reqs, got):
        if rq["knn"]:
            excl = int(rq.get("excl", 0))
            if excl > 0:
                s, a = db.stream_start(ids)
                ids, d2 = brute.exclusion_greedy(ids, d2, s, a, rq["k"],
                                                 excl)
            else:
                ids, d2 = ids[:rq["k"]], d2[:rq["k"]]
        out.append((ids, np.sqrt(d2)))
    return out
