"""The online FAST_SAX query service on one device.

Counterpart of the single-device part of ``repro/serve/service.py``
(``ServeConfig``, ``_SingleBackend``, ``SearchService``,
``SubseqSearchService``).  Request flow:

    submit → bounded queue (admission control, deadlines)
           → micro-batch  (MicroBatcher drains and coalesces)
           → bucket       (Q padded to a power of two, k to a power of two)
           → dispatch     (one mixed range/k-NN device pass: the fused
                           CUDA kernels on a CUDA index, else the torch
                           engine with capacity escalation; or, with
                           ``quantization``, the tiered engine over the
                           quantized resident tier)
           → respond      (per-request ids and distances, latency)

Settings that need a later slice of the port raise NotImplementedError:
failover shards, a mesh, tracing and warm starts from a store.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.engine import (DeviceIndex, TieredIndex, build_device_index,
                           check_device_stack, mixed_query,
                           mixed_query_dense, mixed_query_fused,
                           quantized_mixed_query, represent_queries,
                           resolve_backend, resolve_device,
                           resolve_knn_backend)
from ..core.fastsax import FastSAXConfig, build_index
from ..core.options import SearchOptions
from ..core.representation import DEFAULT_STACK
from ..index.quantized import check_mode
from .batcher import (FAILED, KIND_KNN, KIND_RANGE, OK,
                      REJECTED_SHED, CircuitBreaker, MicroBatcher, Request)
from .stats import StatsTracker

_LATER = {
    "failover_shards": ("the multi-device slice", 8),
    "mesh": ("the multi-device slice", 8),
    "shard_timeout_s": ("the multi-device slice", 8),
    "shard_retries": ("the multi-device slice", 8),
    "shard_backoff_s": ("the multi-device slice", 8),
    "trace": ("the observability slice", 7),
    "trace_ring": ("the observability slice", 7),
    "calibration_ring": ("the observability slice", 7),
    "profile_dir": ("the observability slice", 7),
    "from_store": ("the index-lifecycle slice", 1),
    "refresh_min_interval_s": ("the index-lifecycle slice", 1),
    "async_refresh": ("the index-lifecycle slice", 1),
}


def _not_ported(setting: str):
    slice_name, item = _LATER[setting]
    return NotImplementedError(
        f"{setting} needs {slice_name} of the port (ROADMAP.md queue 1 "
        f"item {item})")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs; the defaults are the reference service's."""

    levels: Sequence[int] = (8, 16)
    alphabet: int = 10
    stack: Sequence[str] = DEFAULT_STACK
    normalize_queries: bool = True
    backend: str = "auto"          # auto|torch|cuda (engine.resolve_backend)
    quantization: str = "none"     # none|bf16|int8: tiered resident index
    verify_prefetch: bool = False  # overlap the raw-tier verify fetch with
    #                                the device's work (same answers)
    max_batch: int = 32            # micro-batch ceiling (and top Q bucket)
    max_queue: int = 256           # admission-control bound
    max_wait_ms: float = 2.0       # coalescing window after first request
    default_deadline_ms: Optional[float] = None   # None = no deadline
    n_iters: int = 2               # k-NN tightening passes
    capacity0: Optional[int] = None  # first candidate capacity (None: auto)
    dense_fallback_frac: float = 0.125   # capacity > frac·B → dense dispatch
    refresh_min_interval_s: float = 0.0  # only the default in this slice
    warmup_ks: Sequence[int] = (8,)       # k buckets to warm up
    failover_shards: int = 0       # only 0 in this slice
    shard_timeout_s: float = 30.0  # only the default in this slice
    shard_retries: int = 2         # only the default in this slice
    shard_backoff_s: float = 0.02  # only the default in this slice
    breaker_threshold: int = 5     # consecutive dispatch failures → open
    breaker_cooldown: int = 8      # shed batches before half-open probe
    async_refresh: bool = True     # only the default in this slice
    trace: bool = False            # only False in this slice
    trace_ring: int = 4096         # only the default in this slice
    calibration_ring: int = 2048   # only the default in this slice
    profile_dir: str = ""          # only the default in this slice

    def __post_init__(self):
        check_mode(self.quantization)
        check_device_stack(self.stack, "ServeConfig")
        # The reference's settings of slices not ported yet: accepted at
        # their defaults, refused with the slice's item otherwise.
        for f in dataclasses.fields(self):
            if f.name in _LATER and getattr(self, f.name) != f.default:
                raise _not_ported(f.name)


def _pow2_at_least(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


_DENSE = -1   # capacity-hint sentinel: dispatch densely from now on


def _to_host(backend, out: tuple) -> tuple:
    """Copy a dispatch's ``(idx, answer, d2, overflow)`` to the host,
    note the bytes and the certificates, return ``(idx, answer, d2)``."""
    out = tuple(t.cpu().numpy() for t in out)
    backend.last_d2h_bytes = sum(a.nbytes for a in out)
    if backend.stats is not None:
        bad = int(out[3].sum())
        backend.stats.on_certificates(out[3].size - bad, out[3].size)
    return out[:3]


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
    def device(self) -> torch.device:
        return self.index.device

    @property
    def size(self) -> int:
        return self.index.size

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
        return _to_host(self, (idx, answer, d2, overflow))


class _QuantizedBackend:
    """Tiered serving: the quantized screen stays on the device, the
    full-precision rows stay in host memory and are fetched only for the
    screen's survivors (``engine.quantized_mixed_query``, which escalates
    its own capacity).  Answers are set-identical to the full-precision
    backend: the widened screen keeps a superset and the verify is exact.
    On the ``cuda`` backend the screen is the ``fused_quant_range``
    kernel.  The answers come back compact, (Q, C) rather than (Q, B).
    """

    def __init__(self, tindex: TieredIndex, cfg: ServeConfig):
        self.tindex = tindex
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, tindex.dev.device)
        self.stats: Optional[StatsTracker] = None   # set by SearchService
        # Bytes the last dispatch copied from the device to the host, and
        # the compaction capacity it reached.
        self.last_d2h_bytes = 0
        self.last_capacity = 0

    @property
    def n(self) -> int:
        return self.tindex.dev.n

    @property
    def device(self) -> torch.device:
        return self.tindex.dev.device

    @property
    def size(self) -> int:
        return self.tindex.size

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int):
        qdev = self.tindex.dev
        dev = qdev.device
        qr = represent_queries(torch.as_tensor(q, dtype=torch.float32,
                                               device=dev),
                               qdev.levels, qdev.alphabet,
                               normalize=self.cfg.normalize_queries)
        cap = self.cfg.capacity0 or max(4 * k, 64)
        idx, answer, d2, overflow = quantized_mixed_query(
            self.tindex, qr, torch.as_tensor(eps, dtype=torch.float32,
                                             device=dev),
            torch.as_tensor(is_knn, dtype=torch.bool, device=dev), k,
            options=SearchOptions(backend=self.cfg.backend, capacity=cap,
                                  verify_prefetch=self.cfg.verify_prefetch))
        self.last_capacity = int(idx.shape[-1])
        return _to_host(self, (idx, answer, d2, overflow))


class SearchService:
    """Online range / k-NN service with dynamic micro-batching."""

    def __init__(self, backend, cfg: ServeConfig = ServeConfig()):
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
        ``device`` (default: CUDA; raises without one).  With
        ``cfg.quantization`` the index is built on the host, quantized
        into the resident tier on the device and served tiered."""
        if mesh is not None:
            raise _not_ported("mesh")
        if cfg.quantization != "none":
            host = build_index(
                np.asarray(series),
                FastSAXConfig(n_segments=tuple(cfg.levels),
                              alphabet=cfg.alphabet, stack=tuple(cfg.stack)),
                normalize=normalize)
            tiered = TieredIndex.from_host(host, cfg.quantization,
                                           device=resolve_device(device))
            return cls(_QuantizedBackend(tiered, cfg), cfg)
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
        rows, dist = self._postprocess(req, rows, dist)
        req._resolve(OK, ids=np.asarray(rows, dtype=np.int64),
                     distances=dist.astype(np.float64))

    def _postprocess(self, req: Request, rows, dist):
        """Answer-shaping hook between the device pass and the response:
        the base service returns the candidates as they are; the
        subsequence service's exclusion zone overrides it.  It runs the
        same on the batched and the direct path, so a replay still
        matches its batch."""
        return rows, dist

    # --- unbatched reference path -------------------------------------------

    def direct_query(self, kind: str, query, epsilon: float = 0.0,
                     k: int = 0, meta: Optional[dict] = None):
        """One request, one device pass, no queue — the reference the
        exactness check replays against.  k is bucketed as in
        :meth:`_dispatch`, so the replay takes the same engine path;
        ``meta`` carries the answer-shaping hints a batched submit would
        attach, so the replay runs the same :meth:`_postprocess`."""
        n = self.backend.n
        q = np.asarray(query, dtype=np.float32).reshape(1, n)
        is_knn = np.asarray([kind == KIND_KNN])
        eps = np.asarray([0.0 if is_knn[0] else epsilon], np.float32)
        kk = _pow2_at_least(max(int(k), 1, self._k_floor), self.backend.size)
        with self._device_lock:
            idx, answer, d2 = self.backend.dispatch(q, eps, is_knn, kk)
        req = Request(kind=kind, query=q[0], epsilon=epsilon,
                      k=max(int(k), 1), meta=meta)
        self._finish(req, idx[0], answer[0], d2[0])
        return req.ids, req.distances


class SubseqSearchService(SearchService):
    """Online subsequence search: every window of the indexed streams is
    a database row, served through the queue → bucket → mixed-dispatch
    machinery above.

    Two request families:

      * ``submit_subseq_range(query, ε)`` — every window within ε; the ids
        are window ids (map them with :meth:`window_meta`);
      * ``submit_subseq_knn(query, k, excl)`` — the k nearest windows
        under the exclusion zone: batched as an ordinary k-NN at the
        fetch count ``core.subseq.knn_fetch_count``, with the greedy in
        :meth:`_postprocess`, the same on the batched and direct paths.

    As in the reference, the device pass is the windows-as-rows mixed
    engine (``_SingleBackend`` over ``sidx.index``: on a CUDA index the
    whole-series kernels ``fused_topk`` and ``fused_range``); the
    streaming kernels serve the engine entry points of
    ``core/subseq.py``."""

    def __init__(self, sidx, cfg: ServeConfig = ServeConfig(),
                 excl: Optional[int] = None):
        if cfg.quantization != "none":
            raise ValueError("the subsequence service serves full-precision "
                             "windows; quantization must be 'none'")
        self.sidx = sidx
        self.excl = (sidx.window // 2) if excl is None else int(excl)
        super().__init__(_SingleBackend(sidx.index, cfg), cfg)

    # --- construction -------------------------------------------------------

    @classmethod
    def from_streams(cls, streams, window: int, stride: int = 1,
                     cfg: ServeConfig = ServeConfig(),
                     excl: Optional[int] = None,
                     device=None) -> "SubseqSearchService":
        """Cold start: the amortised window-feature build over the raw
        (S, n_stream) streams on the host, uploaded to ``device``
        (default: CUDA; raises without one)."""
        from ..core.subseq import build_subseq_index, subseq_device_index

        hidx = build_subseq_index(
            np.asarray(streams),
            FastSAXConfig(n_segments=tuple(cfg.levels),
                          alphabet=cfg.alphabet, stack=tuple(cfg.stack)),
            window, stride)
        return cls(subseq_device_index(hidx, resolve_device(device)), cfg,
                   excl=excl)

    @classmethod
    def from_store(cls, path, cfg: ServeConfig = ServeConfig(),
                   excl: Optional[int] = None):
        raise _not_ported("from_store")

    # --- submission ---------------------------------------------------------

    def _fetch_k(self, k: int, excl: int) -> int:
        from ..core.subseq import knn_fetch_count
        return knn_fetch_count(int(k), excl, self.sidx.stride,
                               self.sidx.n_windows)

    def submit_subseq_range(self, query, epsilon: float,
                            deadline_ms: Optional[float] = None) -> Request:
        """A plain range submit whose ids are window ids (range answers
        carry no exclusion zone)."""
        return self.submit_range(query, epsilon, deadline_ms)

    def submit_subseq_knn(self, query, k: int, excl: Optional[int] = None,
                          deadline_ms: Optional[float] = None) -> Request:
        excl = self.excl if excl is None else int(excl)
        return self._batcher.submit(Request(
            kind=KIND_KNN, query=np.asarray(query, dtype=np.float32),
            k=self._fetch_k(k, excl), deadline=self._deadline(deadline_ms),
            meta={"subseq_k": int(k), "excl": excl}))

    def subseq_range(self, query, epsilon, deadline_ms=None, timeout=60.0):
        return self.range_query(query, epsilon, deadline_ms, timeout)

    def subseq_knn(self, query, k, excl=None, deadline_ms=None,
                   timeout=60.0):
        """Synchronous exclusion-zone k-NN; raises on rejection."""
        req = self.submit_subseq_knn(query, k, excl, deadline_ms)
        if req.wait(timeout) != OK:
            raise RuntimeError(f"subseq knn request {req.status}")
        return req.ids, req.distances

    # --- direct replay (the exactness reference) ----------------------------

    def direct_subseq_range(self, query, epsilon: float):
        return self.direct_query(KIND_RANGE, query, epsilon=epsilon)

    def direct_subseq_knn(self, query, k: int, excl: Optional[int] = None):
        excl = self.excl if excl is None else int(excl)
        return self.direct_query(
            KIND_KNN, query, k=self._fetch_k(k, excl),
            meta={"subseq_k": int(k), "excl": excl})

    # --- answer shaping -----------------------------------------------------

    def _postprocess(self, req: Request, rows, dist):
        """The exclusion zone, by ``core.subseq.suppress_trivial_matches``
        (the greedy the engine entry point runs).  The candidates are
        already ascending by (d², id), so their positions stand in for
        both the ids and the distances, and the kept positions pick
        ``rows`` and ``dist``."""
        from ..core.subseq import suppress_trivial_matches

        meta = req.meta or {}
        if req.kind != KIND_KNN or "subseq_k" not in meta:
            return rows, dist
        k, excl = int(meta["subseq_k"]), int(meta["excl"])
        rows = np.asarray(rows)
        stream_of, start_of = self.sidx.window_meta(rows)
        pos = np.arange(rows.size)
        sel, _ = suppress_trivial_matches(
            pos[None, :], pos[None, :].astype(np.float64), stream_of,
            start_of, k, excl)
        pos = sel[0][sel[0] >= 0]
        return rows[pos], dist[pos]

    def window_meta(self, ids):
        """Window ids -> (stream index, start position) host arrays."""
        return self.sidx.window_meta(ids)
