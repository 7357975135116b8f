"""The system under test, one adapter per kind of configuration.

The only module of the benchmark that imports the program
(``repro_torch``, from ``src/``).  An adapter builds the service through
its public constructor from the host arrays the benchmark made (with the
configuration's optional ``serve`` options passed on to ``ServeConfig``),
warms the buckets the cell's traffic uses, submits requests through the
public submit calls and hands back the service's stats snapshot.  The
service is never built traced: a traced service runs a counting pass in
every dispatch that the timed path does not, so the traced run times
the device pass and the reply itself (:meth:`System.timed`) and counts
the cascade after the window (:meth:`System.cascade_totals`).

  * ``whole_series``: ``SearchService.from_series`` over (B, n) rows;
    ``submit_range`` / ``submit_knn``.
  * ``subsequence``: ``SubseqSearchService.from_streams`` over (S, L)
    streams, window ``window`` at stride ``stride``;
    ``submit_subseq_range`` / ``submit_subseq_knn`` (ids are window ids).
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def q_buckets(clients: int, max_batch: int) -> list:
    """The Q buckets a closed loop of ``clients`` can form: powers of two
    up to the bucket of min(clients, max_batch)."""
    top = _pow2_at_least(min(int(clients), int(max_batch)))
    out, b = [], 1
    while b <= top:
        out.append(b)
        b *= 2
    return out


class System:
    """One service built for one run."""

    def __init__(self, config: dict, traffic: dict, data: np.ndarray,
                 device):
        from repro_torch.serve.service import (SearchService, ServeConfig,
                                               SubseqSearchService)

        self.kind = config["kind"]
        cfg = ServeConfig(**{"levels": tuple(config["levels"]),
                             "alphabet": int(config["alphabet"]),
                             "max_batch": int(traffic.get("max_batch", 32)),
                             **config.get("serve", {}), "trace": False})
        self.cfg = cfg
        if self.kind == "whole_series":
            self.service = SearchService.from_series(data, cfg, device=device)
        elif self.kind == "subsequence":
            self.service = SubseqSearchService.from_streams(
                data, int(config["window"]), int(config.get("stride", 1)),
                cfg, excl=traffic.get("excl"), device=device)
        else:
            raise ValueError(f"unknown configuration kind {self.kind!r}")
        self.k = int(traffic["k"])
        self.excl = (self.service.excl if self.kind == "subsequence"
                     else 0)

    def k_fetch(self) -> int:
        """The k the service batches a k-NN request at."""
        if self.kind != "subsequence":
            return self.k
        from repro_torch.core.subseq import knn_fetch_count
        sidx = self.service.sidx
        return knn_fetch_count(self.k, self.excl, sidx.stride,
                               sidx.n_windows)

    def k_bucket(self) -> int:
        """The k bucket a batch with k-NN requests takes: the fetch,
        never below the service's own k floor, to a power of two."""
        floor = min(self.cfg.warmup_ks) if self.cfg.warmup_ks else 1
        return _pow2_at_least(max(self.k_fetch(), floor))

    def warm(self, in_flight: int) -> None:
        """``warmup`` over the Q buckets that ``in_flight`` requests can
        form and the k bucket of the k-NN requests, then start the
        dispatcher."""
        self.service.warmup(qs=q_buckets(in_flight, self.cfg.max_batch),
                            ks=[self.k_bucket()])
        self.service.start()

    def submit(self, query: np.ndarray, is_knn: bool, eps: float):
        s = self.service
        if self.kind == "subsequence":
            if is_knn:
                return s.submit_subseq_knn(query, self.k)
            return s.submit_subseq_range(query, eps)
        if is_knn:
            return s.submit_knn(query, self.k)
        return s.submit_range(query, eps)

    def snapshot(self) -> dict:
        return self.service.stats.snapshot()

    @contextlib.contextmanager
    def timed(self, out: dict):
        """Time every device pass (the backend's ``dispatch``:
        representation, kernels, the copy of the answers to the host) into
        ``out["dispatch"]`` as ``(t0, t1, Q bucket)`` and every reply (the
        service's ``_finish`` of one request) into ``out["reply"]`` as
        ``(t0, t1)``, on ``time.perf_counter``; the originals are back on
        exit."""
        backend, service = self.service.backend, self.service
        dispatch, finish = backend.dispatch, service._finish
        out.setdefault("dispatch", [])
        out.setdefault("reply", [])

        def timed_dispatch(q, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return dispatch(q, *args, **kwargs)
            finally:
                out["dispatch"].append((t0, time.perf_counter(),
                                        int(q.shape[0])))

        def timed_finish(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return finish(*args, **kwargs)
            finally:
                out["reply"].append((t0, time.perf_counter()))

        backend.dispatch, service._finish = timed_dispatch, timed_finish
        try:
            yield out
        finally:
            del backend.dispatch, service._finish

    def cascade_totals(self, queries: np.ndarray, is_knn, eps) -> dict:
        """The program's own cascade counters (``obs.trace``) over
        ``queries``: the backend's traced device pass, in batches of at
        most ``max_batch`` padded to a power of two as the service pads
        them (the first query again, as a range query at ε 0), at the k
        bucket the window used, k-NN rows at ε 0; the padding is left out
        of the counts.  Run only with no request in flight."""
        from repro_torch.obs.trace import select_queries, trace_totals

        backend, kb = self.service.backend, self.k_bucket()
        tot: dict = {}
        step = self.cfg.max_batch
        for i in range(0, len(queries), step):
            live = min(step, len(queries) - i)
            qb = _pow2_at_least(live)
            q = np.repeat(np.asarray(queries[i:i + 1], np.float32), qb, 0)
            q[:live] = queries[i:i + live]
            knn = np.zeros(qb, dtype=bool)
            knn[:live] = is_knn[i:i + live]
            e = np.zeros(qb, dtype=np.float32)
            e[:live] = np.where(knn[:live], 0.0, eps[i:i + live])
            backend.dispatch(q, e, knn, kb, want_trace=True)
            got = trace_totals(select_queries(backend.last_trace,
                                              np.arange(live)),
                               backend.size)
            for key, val in got.items():
                tot[key] = tot.get(key, 0) + val
        return tot

    def close(self) -> None:
        """Stop the dispatcher and drop every reference to the index."""
        self.service.stop()
        self.service = None
        gc.collect()
