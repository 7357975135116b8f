"""Load generators for the query service.

Counterpart of ``repro/serve/loadgen.py`` (``WorkloadSpec``,
``make_workload``, ``run_closed_loop``, ``run_saturated``,
``run_sequential``, ``check_exactness``).  ``run_closed_loop``'s
``clients`` worker threads each keep one request in flight (submit →
wait → next), so the queue depth equals the number of concurrent
callers; ``run_saturated`` submits the whole workload at once, so the
batcher always coalesces full batches (the service's peak capacity);
``run_sequential`` sends one request at a time through
``SearchService.direct_query``, the per-request baseline.  Exactness is
part of the contract: ``check_exactness`` replays every served request
through the direct path — batching must never change an answer.  Both
batched runs can write a per-request JSONL log (``jsonl_path``) after
the run, on the service's clock.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Optional

import numpy as np

from .batcher import FAILED, KIND_KNN, KIND_RANGE, OK, REJECTED_SHED


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """A reproducible mixed request stream."""

    n_requests: int = 256
    knn_frac: float = 0.5          # fraction of requests that are k-NN
    k: int = 5
    epsilon: float = 2.0
    deadline_ms: Optional[float] = None
    seed: int = 0


def make_workload(queries: np.ndarray, spec: WorkloadSpec) -> list:
    """``[(kind, query_row, epsilon, k), ...]`` — query rows are drawn
    round-robin from ``queries``."""
    rng = np.random.default_rng(spec.seed)
    kinds = rng.random(spec.n_requests) < spec.knn_frac
    out = []
    for i in range(spec.n_requests):
        q = queries[i % queries.shape[0]]
        if kinds[i]:
            out.append((KIND_KNN, q, 0.0, spec.k))
        else:
            out.append((KIND_RANGE, q, spec.epsilon, 0))
    return out


@dataclasses.dataclass
class LoadResult:
    wall_s: float
    qps: float
    statuses: list                 # per-request terminal status strings
    requests: list                 # the Request objects, workload order
    dropped_in_deadline: int       # lost despite a live deadline (must be 0)

    @property
    def served(self) -> int:
        return sum(1 for s in self.statuses if s == OK)

    def summary(self, stats: Optional[dict] = None) -> dict:
        out = {
            "requests": len(self.statuses),
            "served": self.served,
            "rejected_deadline": sum(
                1 for s in self.statuses if s == "rejected_deadline"),
            "rejected_queue_full": sum(
                1 for s in self.statuses if s == "rejected_queue_full"),
            "rejected_shed": sum(
                1 for s in self.statuses if s == REJECTED_SHED),
            "failed": sum(1 for s in self.statuses if s == FAILED),
            "dropped_in_deadline": self.dropped_in_deadline,
            "wall_s": round(self.wall_s, 3),
            "qps": round(self.qps, 1),
        }
        if stats:
            out["stats"] = stats
        return out


def run_closed_loop(service, workload: list, clients: int = 8,
                    timeout_s: float = 120.0,
                    deadline_ms: Optional[float] = None,
                    jsonl_path=None) -> LoadResult:
    """Fire the workload through the batched service from ``clients``
    concurrent closed-loop threads.

    ``jsonl_path`` (optional) writes one JSON record per request after
    the run: workload index, kind, ε / k, submit and completion times on
    the service's ``time.perf_counter`` clock (they join the span ring's
    ``to_jsonl`` export with no clock translation), latency in ms,
    terminal status and answer-set size.  Nothing is written while
    requests are in flight."""
    cursor = {"i": 0}
    lock = threading.Lock()
    requests: list = [None] * len(workload)
    t_done: list = [0.0] * len(workload)

    def worker():
        while True:
            with lock:
                i = cursor["i"]
                if i >= len(workload):
                    return
                cursor["i"] = i + 1
            kind, q, eps, k = workload[i]
            if kind == KIND_KNN:
                req = service.submit_knn(q, k, deadline_ms=deadline_ms)
            else:
                req = service.submit_range(q, eps, deadline_ms=deadline_ms)
            requests[i] = req
            try:
                req.wait(timeout_s)
            except Exception:   # noqa: BLE001 — FAILED re-raise / timeout:
                pass            # the terminal status is the record, and
            #                     the rest of the workload still runs.
            t_done[i] = time.perf_counter()

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(max(1, int(clients)))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s)
    wall = time.perf_counter() - t0
    return _load_result(workload, requests, t_done, wall, jsonl_path)


def run_saturated(service, workload: list, timeout_s: float = 120.0,
                  deadline_ms: Optional[float] = None,
                  jsonl_path=None) -> LoadResult:
    """Open-loop saturation run: submit the whole workload up front from
    one thread, then wait for every reply.  The service needs
    ``max_queue >= len(workload)``, or the tail is rejected at submit.
    With the queue full the batcher always coalesces ``max_batch``
    requests, so the qps is the service's peak serving capacity rather
    than the client threads' round trips.  ``jsonl_path`` as in
    :func:`run_closed_loop`."""
    requests: list = [None] * len(workload)
    t_done: list = [0.0] * len(workload)
    t0 = time.perf_counter()
    for i, (kind, q, eps, k) in enumerate(workload):
        if kind == KIND_KNN:
            requests[i] = service.submit_knn(q, k, deadline_ms=deadline_ms)
        else:
            requests[i] = service.submit_range(q, eps,
                                               deadline_ms=deadline_ms)
    for i, req in enumerate(requests):
        try:
            req.wait(timeout_s)
        except Exception:       # noqa: BLE001 — see run_closed_loop
            pass
        t_done[i] = time.perf_counter()
    wall = time.perf_counter() - t0
    return _load_result(workload, requests, t_done, wall, jsonl_path)


def _load_result(workload: list, requests: list, t_done: list, wall: float,
                 jsonl_path) -> LoadResult:
    statuses = [r.status if r is not None else "unsubmitted"
                for r in requests]
    # An accepted request must be served or rejected before its deadline;
    # anything else is a drop the operator must see.
    dropped = sum(1 for s in statuses if s not in
                  (OK, "rejected_deadline", "rejected_queue_full",
                   REJECTED_SHED, FAILED))
    served = sum(1 for s in statuses if s == OK)
    if jsonl_path is not None:
        _write_request_log(jsonl_path, workload, requests, t_done)
    return LoadResult(wall_s=wall, qps=served / wall if wall > 0 else 0.0,
                      statuses=statuses, requests=requests,
                      dropped_in_deadline=dropped)


def _write_request_log(path, workload: list, requests: list,
                       t_done: list) -> int:
    """One JSON object per submitted request (see
    :func:`run_closed_loop`); returns the count written."""
    n = 0
    with open(path, "w") as f:
        for i, (kind, _q, eps, k) in enumerate(workload):
            req = requests[i]
            if req is None:
                continue
            done = t_done[i]
            rec = {
                "index": i,
                "kind": kind,
                "epsilon": float(eps),
                "k": int(k),
                "t_submit": req.t_submit,
                "t_complete": done,
                "latency_ms": (done - req.t_submit) * 1e3 if done else None,
                "status": req.status,
                "n_answers": int(req.ids.size) if req.ids is not None else 0,
            }
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    return n


def run_sequential(service, workload: list) -> tuple:
    """The per-request baseline: the same workload, one direct device
    pass per request, no queueing or coalescing.  Returns ``(wall_s,
    [(ids, distances), ...])``."""
    results = []
    t0 = time.perf_counter()
    for kind, q, eps, k in workload:
        results.append(service.direct_query(kind, q, epsilon=eps, k=k))
    wall = time.perf_counter() - t0
    return wall, results


def check_exactness(service, workload: list, result: LoadResult) -> int:
    """Replay every served request through the direct path; count
    mismatches.  The ids must be identical and the distances agree to
    float precision.  0 is the only acceptable return."""
    bad = 0
    for (kind, q, eps, k), req in zip(workload, result.requests):
        if req is None or req.status != OK:
            continue
        ids, dist = service.direct_query(kind, q, epsilon=eps, k=k)
        if not (np.array_equal(ids, req.ids)
                and np.allclose(dist, req.distances, rtol=1e-6, atol=1e-9)):
            bad += 1
    return bad
