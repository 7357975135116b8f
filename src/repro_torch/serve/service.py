"""The online FAST_SAX query service on one device.

Counterpart of the single-device part of ``repro/serve/service.py``
(``ServeConfig``, ``_SingleBackend``, ``SearchService``).  Request flow:

    submit → bounded queue (admission control, deadlines)
           → micro-batch  (MicroBatcher drains and coalesces)
           → bucket       (Q padded to a power of two, k to a power of two)
           → dispatch     (one mixed range/k-NN device pass: the fused
                           CUDA kernels on a CUDA index, else the torch
                           engine with capacity escalation)
           → respond      (per-request ids and distances, latency)

Settings that need a later slice of the port raise NotImplementedError:
quantization, failover shards, a mesh, tracing and warm starts from a
store.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.engine import (DeviceIndex, build_device_index,
                           mixed_query, mixed_query_dense, mixed_query_fused,
                           represent_queries, resolve_backend,
                           resolve_device, resolve_knn_backend)
from ..core.representation import DEFAULT_STACK
from .batcher import (FAILED, KIND_KNN, KIND_RANGE, OK,
                      REJECTED_SHED, CircuitBreaker, MicroBatcher, Request)
from .stats import StatsTracker

_LATER = {
    "quantization": "the quantized-tier slice",
    "failover_shards": "the multi-device slice",
    "mesh": "the multi-device slice",
    "trace": "the observability slice",
    "from_store": "the index-lifecycle slice",
}


def _not_ported(setting: str):
    return NotImplementedError(
        f"{setting} needs {_LATER[setting]} of the port (ROADMAP.md queue 1)")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs; the defaults are the reference service's."""

    levels: Sequence[int] = (8, 16)
    alphabet: int = 10
    stack: Sequence[str] = DEFAULT_STACK
    normalize_queries: bool = True
    backend: str = "auto"          # auto|torch|cuda (engine.resolve_backend)
    quantization: str = "none"     # only "none" in this slice
    max_batch: int = 32            # micro-batch ceiling (and top Q bucket)
    max_queue: int = 256           # admission-control bound
    max_wait_ms: float = 2.0       # coalescing window after first request
    default_deadline_ms: Optional[float] = None   # None = no deadline
    n_iters: int = 2               # k-NN tightening passes
    capacity0: Optional[int] = None  # first candidate capacity (None: auto)
    dense_fallback_frac: float = 0.125   # capacity > frac·B → dense dispatch
    warmup_ks: Sequence[int] = (8,)       # k buckets to warm up
    failover_shards: int = 0       # only 0 in this slice
    breaker_threshold: int = 5     # consecutive dispatch failures → open
    breaker_cooldown: int = 8      # shed batches before half-open probe
    trace: bool = False            # only False in this slice

    def __post_init__(self):
        if self.quantization != "none":
            raise _not_ported("quantization")
        if self.failover_shards:
            raise _not_ported("failover_shards")
        if self.trace:
            raise _not_ported("trace")


def _pow2_at_least(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


_DENSE = -1   # capacity-hint sentinel: dispatch densely from now on


class _SingleBackend:
    """One DeviceIndex on one device.

    On the ``cuda`` backend every micro-batch is one fused mixed pass
    (``mixed_query_fused``: a top-k tightening pass and a dense range pass)
    in the dense (Q, B) layout.  On ``torch`` the compacting
    ``mixed_query`` runs with sticky capacity escalation, switching for
    good to ``mixed_query_dense`` once the learned capacity passes
    ``dense_fallback_frac``·B, so a direct replay takes the same path as
    the batch that served it.
    """

    def __init__(self, index: DeviceIndex, cfg: ServeConfig):
        self.index = index
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, index.device)
        self._cap: Optional[int] = None   # learned capacity or _DENSE
        self.stats: Optional[StatsTracker] = None   # set by SearchService
        # Bytes the last dispatch copied from the device to the host.
        self.last_d2h_bytes = 0

    @property
    def n(self) -> int:
        return self.index.n

    @property
    def size(self) -> int:
        return self.index.size

    def _note_certificates(self, overflow: np.ndarray):
        if self.stats is not None:
            bad = int(overflow.sum())
            self.stats.on_certificates(overflow.size - bad, overflow.size)

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int):
        B, dev = self.size, self.index.device
        qr = represent_queries(torch.as_tensor(q, dtype=torch.float32,
                                               device=dev),
                               self.index.levels, self.index.alphabet,
                               normalize=self.cfg.normalize_queries)
        eps_t = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        knn_t = torch.as_tensor(is_knn, dtype=torch.bool, device=dev)
        # Large k buckets demote the fused path to torch; the decision is
        # a function of (backend, k bucket) only, so every batch and every
        # direct replay of a bucket takes the same float path.
        fused = resolve_knn_backend(self.backend, k, dev) == "cuda"
        if self.stats is not None and self.backend == "cuda" and not fused:
            self.stats.on_demotion()
        if fused:
            idx, answer, d2, overflow = mixed_query_fused(
                self.index, qr, eps_t, knn_t, k, n_iters=self.cfg.n_iters)
        else:
            cap_limit = max(64, int(self.cfg.dense_fallback_frac * B))
            cap = self._cap
            if cap is None:
                cap = self.cfg.capacity0 or max(4 * k, 64)
            while cap != _DENSE:
                cap = max(min(int(cap), B), min(k, B))
                idx, answer, d2, overflow = mixed_query(
                    self.index, qr, eps_t, knn_t, k, capacity=cap,
                    n_iters=self.cfg.n_iters)
                if cap >= B or not bool(overflow.any()):
                    self._cap = max(cap, self._cap or 0)
                    break
                if self.stats is not None:
                    self.stats.on_escalation()
                cap = cap * 4 if cap * 4 <= cap_limit else _DENSE
            else:
                self._cap = _DENSE
                idx, answer, d2, overflow = mixed_query_dense(
                    self.index, qr, eps_t, knn_t, k)
        out = tuple(t.cpu().numpy() for t in (idx, answer, d2, overflow))
        self.last_d2h_bytes = sum(a.nbytes for a in out)
        self._note_certificates(out[3])
        return out[:3]


class SearchService:
    """Online range / k-NN service with dynamic micro-batching."""

    def __init__(self, backend: _SingleBackend,
                 cfg: ServeConfig = ServeConfig()):
        self.cfg = cfg
        self.backend = backend
        self.stats = StatsTracker()
        backend.stats = self.stats
        self._batcher = MicroBatcher(
            self._dispatch, max_batch=cfg.max_batch, max_queue=cfg.max_queue,
            max_wait_ms=cfg.max_wait_ms, stats=self.stats)
        self.breaker = CircuitBreaker(threshold=cfg.breaker_threshold,
                                      cooldown=cfg.breaker_cooldown)
        # Serialises device passes of the dispatcher thread and of direct
        # queries from callers' threads.
        self._device_lock = threading.Lock()
        # Range-only batches still bucket k at the warmed floor.
        self._k_floor = _pow2_at_least(
            min(cfg.warmup_ks) if cfg.warmup_ks else 1, self.backend.size)

    # --- construction -------------------------------------------------------

    @classmethod
    def from_series(cls, series: np.ndarray, cfg: ServeConfig = ServeConfig(),
                    mesh=None, normalize: bool = True,
                    device=None) -> "SearchService":
        """Cold start: build the device index from raw (B, n) series on
        ``device`` (default: CUDA; raises without one)."""
        if mesh is not None:
            raise _not_ported("mesh")
        index = build_device_index(np.asarray(series), tuple(cfg.levels),
                                   cfg.alphabet, normalize=normalize,
                                   stack=tuple(cfg.stack),
                                   device=resolve_device(device))
        return cls(_SingleBackend(index, cfg), cfg)

    @classmethod
    def from_store(cls, path, cfg: ServeConfig = ServeConfig(), mesh=None):
        raise _not_ported("from_store")

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> "SearchService":
        self._batcher.start()
        return self

    def stop(self):
        self._batcher.stop()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: refuse new work, let queued and in-flight
        batches finish, then stop.  False if they did not finish in time."""
        return self._batcher.drain(timeout_s=timeout_s)

    def __enter__(self) -> "SearchService":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, qs: Optional[Sequence[int]] = None,
               ks: Optional[Sequence[int]] = None):
        """Run one batch of every (Q bucket ≤ max_batch) × (k bucket), so
        the first requests pay no one-time costs (kernel build, caches)."""
        q_buckets = list(qs) if qs is not None else []
        if not q_buckets:
            b = 1
            while b <= self.cfg.max_batch:
                q_buckets.append(b)
                b *= 2
        k_buckets = [_pow2_at_least(int(k), self.backend.size)
                     for k in (ks if ks is not None else self.cfg.warmup_ks)]
        probe = np.zeros((1, self.backend.n), dtype=np.float32)
        for qb in q_buckets:
            q = np.repeat(probe, qb, axis=0)
            eps = np.full(qb, 1.0, np.float32)
            for kb in sorted(set(k_buckets)):
                is_knn = np.zeros(qb, dtype=bool)
                is_knn[: max(1, qb // 2)] = True
                with self._device_lock:
                    self.backend.dispatch(q, eps, is_knn, kb)
        return self

    # --- submission ---------------------------------------------------------

    def _deadline(self, deadline_ms) -> Optional[float]:
        ms = self.cfg.default_deadline_ms if deadline_ms is None else deadline_ms
        return None if ms is None else time.perf_counter() + float(ms) / 1e3

    def submit_range(self, query: np.ndarray, epsilon: float,
                     deadline_ms: Optional[float] = None) -> Request:
        return self._batcher.submit(Request(
            kind=KIND_RANGE, query=np.asarray(query, dtype=np.float32),
            epsilon=float(epsilon), deadline=self._deadline(deadline_ms)))

    def submit_knn(self, query: np.ndarray, k: int,
                   deadline_ms: Optional[float] = None) -> Request:
        return self._batcher.submit(Request(
            kind=KIND_KNN, query=np.asarray(query, dtype=np.float32),
            k=int(k), deadline=self._deadline(deadline_ms)))

    def range_query(self, query, epsilon, deadline_ms=None, timeout=60.0):
        """Synchronous range query; raises on rejection."""
        req = self.submit_range(query, epsilon, deadline_ms)
        if req.wait(timeout) != OK:
            raise RuntimeError(f"range request {req.status}")
        return req.ids, req.distances

    def knn(self, query, k, deadline_ms=None, timeout=60.0):
        """Synchronous exact k-NN; raises on rejection."""
        req = self.submit_knn(query, k, deadline_ms)
        if req.wait(timeout) != OK:
            raise RuntimeError(f"knn request {req.status}")
        return req.ids, req.distances

    # --- dispatch -----------------------------------------------------------

    def _dispatch(self, batch: list):
        """MicroBatcher callback: one padded, bucketed device pass."""
        if not self.breaker.allow():
            # Breaker open: shed the batch with a rejected status.
            n_shed = 0
            for req in batch:
                if not req._done.is_set():
                    req._resolve(REJECTED_SHED)
                    n_shed += 1
            self.stats.on_shed(n_shed)
            self.stats.set_breaker(self.breaker.state,
                                   self.breaker.state_code)
            return
        Q = len(batch)
        qb = _pow2_at_least(Q, self.cfg.max_batch)
        n = self.backend.n
        q = np.empty((qb, n), dtype=np.float32)
        eps = np.zeros(qb, dtype=np.float32)
        is_knn = np.zeros(qb, dtype=bool)
        max_k = 1
        for i, req in enumerate(batch):
            if req.query.shape != (n,):
                req._resolve(FAILED, error=ValueError(
                    f"query must be ({n},), got {req.query.shape}"))
                self.stats.on_failed()
                continue
            q[i] = req.query
            if req.kind == KIND_KNN:
                is_knn[i] = True
                max_k = max(max_k, req.k)
            else:
                eps[i] = req.epsilon
        live = [(i, r) for i, r in enumerate(batch) if not r._done.is_set()]
        if not live:
            return
        # Padding rows replay the first live query as a range query at
        # ε = 0 — same shapes, no effect on answers.
        for j in range(Q, qb):
            q[j] = q[live[0][0]]
        k_bucket = _pow2_at_least(max(max_k, self._k_floor),
                                  self.backend.size)
        self.stats.on_batch(len(live), qb, self._batcher.depth)
        try:
            with self._device_lock:
                idx, answer, d2 = self.backend.dispatch(q, eps, is_knn,
                                                        k_bucket)
        except BaseException:
            # The batcher resolves the batch FAILED; feed the breaker.
            self.breaker.on_failure()
            self.stats.set_breaker(self.breaker.state,
                                   self.breaker.state_code)
            raise
        self.breaker.on_success()
        self.stats.set_breaker(self.breaker.state, self.breaker.state_code)
        for i, req in live:
            self._finish(req, idx[i], answer[i], d2[i])

    def _finish(self, req: Request, idx_row, answer_row, d2_row):
        if req.kind == KIND_KNN:
            finite = np.isfinite(d2_row)
            # Ascending (d², slot); slots are in row order, so ties go to
            # the lowest database row.
            order = np.lexsort((np.arange(d2_row.size), d2_row))
            order = order[finite[order]][: req.k]
            rows = idx_row[order]
            dist = np.sqrt(d2_row[order])
        else:
            mask = answer_row & np.isfinite(d2_row)
            rows = idx_row[mask]
            dist = np.sqrt(d2_row[mask])
        req._resolve(OK, ids=np.asarray(rows, dtype=np.int64),
                     distances=dist.astype(np.float64))

    # --- unbatched reference path -------------------------------------------

    def direct_query(self, kind: str, query, epsilon: float = 0.0,
                     k: int = 0):
        """One request, one device pass, no queue — the reference the
        exactness check replays against.  k is bucketed as in
        :meth:`_dispatch`, so the replay takes the same engine path."""
        n = self.backend.n
        q = np.asarray(query, dtype=np.float32).reshape(1, n)
        is_knn = np.asarray([kind == KIND_KNN])
        eps = np.asarray([0.0 if is_knn[0] else epsilon], np.float32)
        kk = _pow2_at_least(max(int(k), 1, self._k_floor), self.backend.size)
        with self._device_lock:
            idx, answer, d2 = self.backend.dispatch(q, eps, is_knn, kk)
        req = Request(kind=kind, query=q[0], epsilon=epsilon,
                      k=max(int(k), 1))
        self._finish(req, idx[0], answer[0], d2[0])
        return req.ids, req.distances
