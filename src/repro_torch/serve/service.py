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
           → respond      (per-request ids and distances, mapped to
                           external ids, latency)

Warm start: ``SearchService.from_store`` takes a committed store of
either package — a ``MutableIndex`` root (which also turns on live
ingest), a plain store, or a plain store with a quantized tier — and
uploads it once.

Live ingest: ``insert`` / ``delete`` go through the ``MutableIndex``
(durable, crash-safe); its commit hook marks the device copy stale, and
at the next batch boundary the dispatcher swaps in a freshly uploaded
live view, in the background by default (``async_refresh``), at most
once per ``refresh_min_interval_s``.  One lock covers the swap, every
device pass and the ids snapshot that maps its row positions, so no
batch maps one generation's positions through another's ids.

Tracing (``ServeConfig(trace=True)``): the cascade counters of every
batch (``obs.trace.QueryTrace``, counted on the device and copied as
(Q, L) and (Q,) counters only) into ``stats``, a bounded span ring
(``tracer``: enqueue, batch form, dispatch, verify, reply), the
cost-model calibration of every dispatch (``calibration``) and the
Prometheus text (:meth:`SearchService.metrics_text`); ``profile_dir``
wraps every batch's dispatch in a ``torch.profiler`` capture.  All off by
default: the untraced service keeps none of that state.

Settings that need a later slice of the port raise NotImplementedError:
failover shards, a mesh and sharded stores.
"""
from __future__ import annotations

import dataclasses
import pathlib
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.cost_model import fused_pass_estimate
from ..core.engine import (DeviceIndex, TieredIndex, build_device_index,
                           device_index_from_host,
                           device_trace_bytes, mixed_query,
                           mixed_query_dense, mixed_query_dense_and_trace,
                           mixed_query_fused, mixed_trace,
                           quantized_mixed_query, quantized_mixed_trace,
                           represent_queries, resolve_backend,
                           resolve_device, resolve_knn_backend,
                           tiered_trace_bytes)
from ..core.fastsax import FastSAXConfig, build_index
from ..core.options import SearchOptions
from ..core.representation import DEFAULT_STACK, validate_stack
from ..index.quantized import check_mode
from ..obs.calibration import CalibrationLog
from ..obs.spans import SpanRecorder, prepare_profiler, profiler_capture
from ..obs.trace import select_queries, to_host, trace_totals
from .batcher import (FAILED, KIND_KNN, KIND_RANGE, OK,
                      REJECTED_SHED, CircuitBreaker, MicroBatcher, Request)
from .stats import StatsTracker

_LATER = {
    "failover_shards": ("the multi-device slice", 8),
    "mesh": ("the multi-device slice", 8),
    "shard_timeout_s": ("the multi-device slice", 8),
    "shard_retries": ("the multi-device slice", 8),
    "shard_backoff_s": ("the multi-device slice", 8),
    "sharded_store": ("the multi-device slice", 8),
}

#: Store kinds of the reference's sharded layouts (``index/sharded.py``),
#: recognised and refused.
_SHARDED_KINDS = ("fastsax-index-sharded", "fastsax-tiered-sharded")


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
    refresh_min_interval_s: float = 0.0  # live-ingest refresh throttle
    warmup_ks: Sequence[int] = (8,)       # k buckets to warm up
    failover_shards: int = 0       # only 0 in this slice
    shard_timeout_s: float = 30.0  # only the default in this slice
    shard_retries: int = 2         # only the default in this slice
    shard_backoff_s: float = 0.02  # only the default in this slice
    breaker_threshold: int = 5     # consecutive dispatch failures → open
    breaker_cooldown: int = 8      # shed batches before half-open probe
    async_refresh: bool = True     # background device upload on commit
    # Observability, all off by default: the untraced service is the
    # untraced call path.
    trace: bool = False            # cascade counters, spans, calibration
    trace_ring: int = 4096         # span ring capacity (bounded memory)
    calibration_ring: int = 2048   # dispatch-record ring capacity
    profile_dir: str = ""          # torch.profiler capture dir ("" = off)

    @classmethod
    def from_options(cls, options: SearchOptions, **overrides):
        """A ServeConfig from the query-options surface: the
        :class:`SearchOptions` fields with a serving counterpart map
        across, the rest keep their defaults (or ``overrides``)."""
        mapped = dict(backend=options.backend,
                      quantization=options.quantization,
                      verify_prefetch=options.verify_prefetch,
                      trace=options.trace,
                      n_iters=options.n_iters,
                      capacity0=options.capacity,
                      normalize_queries=options.normalize_queries)
        mapped.update(overrides)
        return cls(**mapped)

    def __post_init__(self):
        check_mode(self.quantization)
        validate_stack(self.stack)
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


def _prepare_on_side_stream(device, build):
    """Run ``build()`` (a device upload) and return what it returns once
    every copy it queued has landed.  On CUDA it runs on a side stream,
    so a background upload never queues behind, or ahead of, the
    dispatcher's kernels on the current stream, and the stream is
    synchronised before the result is handed over: the first dispatch on
    a new generation never reads a half-copied tensor."""
    if device.type != "cuda":
        return build()
    side = torch.cuda.Stream(device=device)
    with torch.cuda.stream(side):
        out = build()
    side.synchronize()
    return out


def _trace_to_host(backend, trace) -> None:
    """Keep a dispatch's trace as host counters (None when untraced)."""
    backend.last_trace = None if trace is None else to_host(trace)


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
    the batch that served it.  An index with a stack beyond the paper
    pair serves the same way: the kernels answer with the paper pair's
    cascade, the torch engine applies the extras too.
    """

    def __init__(self, index: DeviceIndex, cfg: ServeConfig):
        self.index = index
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, index.device)
        self._cap: Optional[int] = None   # learned capacity or _DENSE
        self.stats: Optional[StatsTracker] = None   # set by SearchService
        # Bytes the last dispatch copied from the device to the host, and
        # its trace (host counters) when it was asked for one.
        self.last_d2h_bytes = 0
        self.last_trace = None

    @property
    def n(self) -> int:
        return self.index.n

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def size(self) -> int:
        return self.index.size

    def prepare_from_host(self, host):
        """Heavy half of a generation swap: upload ``host`` to this
        backend's device and wait for the copies.  Touches no serving
        state, so it may run off the dispatch thread."""
        return _prepare_on_side_stream(
            self.device, lambda: device_index_from_host(host, self.device))

    def install(self, prepared):
        """Cheap half: replace the index as a whole (the caller holds the
        service's device lock, so no pass runs on the old one).  The
        learned capacity stays: B changed, the policy did not."""
        self.index = prepared
        self.backend = resolve_backend(self.cfg.backend, prepared.device)

    def trace_bytes(self, trace) -> dict:
        return device_trace_bytes(self.index, trace)

    def cost_estimate(self, Q: int, k: int) -> dict:
        return fused_pass_estimate(Q, self.size, self.n, self.index.levels,
                                   self.index.alphabet, k=int(k))

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int, want_trace: bool = False):
        """One device pass: ``(idx, answer, d2)`` on the host.  With
        ``want_trace`` the batch's trace is counted on the device before
        the copy and kept in ``last_trace`` as host counters."""
        B, dev = self.size, self.index.device
        qr = represent_queries(torch.as_tensor(q, dtype=torch.float32,
                                               device=dev),
                               self.index.levels, self.index.alphabet,
                               normalize=self.cfg.normalize_queries,
                               stack=self.index.stack)
        eps_t = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        knn_t = torch.as_tensor(is_knn, dtype=torch.bool, device=dev)
        # Large k buckets demote the fused path to torch; the decision is
        # a function of (backend, k bucket) only, so every batch and every
        # direct replay of a bucket takes the same float path.
        fused = resolve_knn_backend(self.backend, k, dev) == "cuda"
        if self.stats is not None and self.backend == "cuda" and not fused:
            self.stats.on_demotion()
        trace = None
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
                if want_trace:
                    idx, answer, d2, overflow, trace = \
                        mixed_query_dense_and_trace(self.index, qr, eps_t,
                                                    knn_t, k)
                else:
                    idx, answer, d2, overflow = mixed_query_dense(
                        self.index, qr, eps_t, knn_t, k)
        if want_trace and trace is None:
            trace = mixed_trace(self.index, qr, eps_t, knn_t, k, answer, d2)
        _trace_to_host(self, trace)
        return _to_host(self, (idx, answer, d2, overflow))


class _QuantizedBackend:
    """Tiered serving: the quantized screen stays on the device, the
    full-precision rows stay in host memory and are fetched only for the
    screen's survivors (``engine.quantized_mixed_query``, which escalates
    its own capacity).  Answers are set-identical to the full-precision
    backend: the widened screen keeps a superset and the verify is exact.
    On the ``cuda`` backend the screen is the ``fused_quant_range``
    kernel, followed for a stack beyond the paper pair by the extras'
    tests on its kept rows.  The answers come back compact, (Q, C) rather
    than (Q, B).
    """

    def __init__(self, tindex: TieredIndex, cfg: ServeConfig):
        self.tindex = tindex
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, tindex.dev.device)
        self.stats: Optional[StatsTracker] = None   # set by SearchService
        # Bytes the last dispatch copied from the device to the host, the
        # compaction capacity it reached, and its trace when asked for.
        self.last_d2h_bytes = 0
        self.last_capacity = 0
        self.last_trace = None

    @property
    def n(self) -> int:
        return self.tindex.dev.n

    @property
    def device(self) -> torch.device:
        return self.tindex.dev.device

    @property
    def size(self) -> int:
        return self.tindex.size

    def prepare_from_host(self, host):
        """Quantize ``host`` into this backend's mode and upload it (the
        heavy half of a generation swap, safe off the dispatch thread)."""
        return _prepare_on_side_stream(
            self.device, lambda: TieredIndex.from_host(
                host, self.tindex.mode, device=self.device))

    def install(self, prepared):
        self.tindex = prepared

    def trace_bytes(self, trace) -> dict:
        return tiered_trace_bytes(self.tindex, trace)

    def cost_estimate(self, Q: int, k: int) -> dict:
        qdev = self.tindex.dev
        return fused_pass_estimate(Q, self.size, self.n, qdev.levels,
                                   qdev.alphabet, k=int(k))

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int, want_trace: bool = False):
        """One tiered pass; ``want_trace`` as in
        :meth:`_SingleBackend.dispatch` (its series-screen count is
        ``fused_quant_range``'s keep count at the trace radius)."""
        qdev = self.tindex.dev
        dev = qdev.device
        qr = represent_queries(torch.as_tensor(q, dtype=torch.float32,
                                               device=dev),
                               qdev.levels, qdev.alphabet,
                               normalize=self.cfg.normalize_queries,
                               stack=qdev.stack)
        cap = self.cfg.capacity0 or max(4 * k, 64)
        eps_t = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        knn_t = torch.as_tensor(is_knn, dtype=torch.bool, device=dev)
        idx, answer, d2, overflow = quantized_mixed_query(
            self.tindex, qr, eps_t, knn_t, k,
            options=SearchOptions(backend=self.cfg.backend, capacity=cap,
                                  verify_prefetch=self.cfg.verify_prefetch))
        self.last_capacity = int(idx.shape[-1])
        _trace_to_host(self, quantized_mixed_trace(
            qdev, qr, eps_t, knn_t, k, answer, d2) if want_trace else None)
        return _to_host(self, (idx, answer, d2, overflow))


class SearchService:
    """Online range / k-NN service with dynamic micro-batching.

    ``ids`` maps the backend's row positions to external ids (a
    ``MutableIndex``'s live view); ``mutable``, when given, is the index
    live ingest writes to, and the service follows its commits."""

    def __init__(self, backend, cfg: ServeConfig = ServeConfig(),
                 ids: Optional[np.ndarray] = None, mutable=None):
        self.cfg = cfg
        self.backend = backend
        self._ids = None if ids is None else np.asarray(ids, dtype=np.int64)
        self.mutable = mutable
        self.stats = StatsTracker()
        backend.stats = self.stats
        # The tracing surfaces, allocated only with cfg.trace: the
        # untraced service keeps no observability state beyond counters.
        self.tracer = SpanRecorder(cfg.trace_ring) if cfg.trace else None
        self.calibration = (CalibrationLog(cfg.calibration_ring)
                            if cfg.trace else None)
        self._batcher = MicroBatcher(
            self._dispatch, max_batch=cfg.max_batch, max_queue=cfg.max_queue,
            max_wait_ms=cfg.max_wait_ms, stats=self.stats,
            tracer=self.tracer)
        if cfg.profile_dir:
            # The captures run on the dispatcher thread; the profiler's
            # first session must not (obs.spans.prepare_profiler).
            prepare_profiler(backend.device)
        self.breaker = CircuitBreaker(threshold=cfg.breaker_threshold,
                                      cooldown=cfg.breaker_cooldown)
        # Serialises the device passes of the dispatcher thread and of
        # direct queries from callers' threads with a generation swap, and
        # covers each pass's ids snapshot: a batch never maps one
        # generation's row positions through another generation's ids.
        self._device_lock = threading.Lock()
        self._refresh_thread: Optional[threading.Thread] = None
        # Range-only batches still bucket k at the warmed floor.
        self._k_floor = _pow2_at_least(
            min(cfg.warmup_ks) if cfg.warmup_ks else 1, self.backend.size)
        self._loaded_gen = mutable.generation if mutable is not None else -1
        self._last_refresh = time.perf_counter()
        self._stale = False
        # Seconds of the last swap's steps: the live-view snapshot, the
        # upload (with its wait) and the install under the lock.
        self.last_refresh_times: dict = {}
        self._unsubscribe = None
        if mutable is not None:
            self._unsubscribe = mutable.subscribe(self._on_commit)

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
    def from_store(cls, path, cfg: ServeConfig = ServeConfig(), mesh=None,
                   device=None) -> "SearchService":
        """Warm start from a committed store of either package on
        ``device`` (default: CUDA; raises without one):

        * a ``MutableIndex`` root (``CURRENT`` present): its live view,
          answers mapped to external ids, live ingest on;
        * a plain store: mmap-opened and uploaded once;
        * with ``cfg.quantization``, served tiered: a plain store with a
          stored tier of that mode serves it as it is, anything else is
          quantized in memory from the live view.

        ``levels`` / ``alphabet`` / ``stack`` come from the store, not
        ``cfg``.  The reference's sharded stores, and ``mesh``, need the
        multi-device slice of the port.
        """
        from ..index import mutable as _mutable
        from ..index import store as _store

        if mesh is not None:
            raise _not_ported("mesh")
        path = pathlib.Path(path)
        dev = resolve_device(device)
        quant = cfg.quantization != "none"
        if (path / _mutable.CURRENT).exists():
            mi = _mutable.MutableIndex.open(path)
            host, ids = mi.live_index()
            if quant:
                backend = _QuantizedBackend(TieredIndex.from_host(
                    host, cfg.quantization, device=dev), cfg)
            else:
                backend = _SingleBackend(device_index_from_host(host, dev),
                                         cfg)
            return cls(backend, cfg, ids=np.asarray(ids), mutable=mi)
        if _store.read_manifest(path).get("kind") in _SHARDED_KINDS:
            raise _not_ported("sharded_store")
        if quant:
            return cls(_QuantizedBackend(TieredIndex.from_store(
                path, quantization=cfg.quantization, device=dev), cfg), cfg)
        host = _store.load_index(path, mmap=True)
        return cls(_SingleBackend(device_index_from_host(host, dev), cfg),
                   cfg)

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> "SearchService":
        self._batcher.start()
        return self

    def stop(self):
        self._batcher.stop()
        self._unsubscribe_commits()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown: refuse new work, let queued and in-flight
        batches finish, then stop.  False if they did not finish in time."""
        drained = self._batcher.drain(timeout_s=timeout_s)
        self._unsubscribe_commits()
        return drained

    def _unsubscribe_commits(self):
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

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
                    self.backend.dispatch(q, eps, is_knn, kb,
                                          want_trace=self.cfg.trace)
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

    # --- live ingest --------------------------------------------------------

    def _require_mutable(self):
        if self.mutable is None:
            raise RuntimeError(
                "live ingest needs a MutableIndex-backed service "
                "(SearchService.from_store on an index root)")
        return self.mutable

    def insert(self, series: np.ndarray) -> np.ndarray:
        """Durably insert rows; returns their external ids.  Served
        answers include them after the next refresh."""
        return self._require_mutable().insert(np.asarray(series))

    def delete(self, ids) -> int:
        """Durably tombstone rows by external id; returns the live count."""
        return self._require_mutable().delete(ids)

    def _on_commit(self, _mi):
        # The MutableIndex commit hook, on the mutating thread after
        # CURRENT swapped: only a staleness mark.  The upload happens at a
        # batch boundary, so in-flight batches finish on one index.
        self._stale = True

    def _maybe_refresh(self, force: bool = False):
        mi = self.mutable
        if mi is None or not (self._stale or force):
            return
        if not force and self.cfg.async_refresh:
            # Non-blocking swap: kick the background upload and keep
            # serving the loaded generation; _refresh_bg installs the new
            # one under the device lock once its copies have landed.
            if self._refresh_thread is not None \
                    and self._refresh_thread.is_alive():
                return
            if (time.perf_counter() - self._last_refresh
                    < self.cfg.refresh_min_interval_s):
                return
            if mi.generation == self._loaded_gen:
                self._stale = False
                return
            self._refresh_thread = threading.Thread(
                target=self._refresh_bg, name="repro-torch-serve-refresh",
                daemon=True)
            self._refresh_thread.start()
            return
        with self._device_lock:
            if mi.generation == self._loaded_gen:
                self._stale = False
                return
            now = time.perf_counter()
            if not force and (now - self._last_refresh
                              < self.cfg.refresh_min_interval_s):
                return
            try:
                gen, host, ids = mi.live_snapshot()
                t1 = time.perf_counter()
                prepared = self.backend.prepare_from_host(host)
            except BaseException:
                self.stats.on_refresh_failure()
                self._stale = True
                raise
            t2 = time.perf_counter()
            self.backend.install(prepared)
            self.last_refresh_times = {"snapshot_s": t1 - now,
                                       "upload_s": t2 - t1,
                                       "install_s": time.perf_counter() - t2}
            self._ids = np.asarray(ids, dtype=np.int64)
            self._loaded_gen = gen
            self._last_refresh = now
            # A commit racing with the upload re-flags through the hook.
            self._stale = mi.generation != gen
        self.stats.on_refresh_swap()

    def _refresh_bg(self):
        """Background half of the non-blocking swap: the snapshot and the
        upload run with no lock held (serving goes on); only the install
        takes the device lock.  A failed upload keeps the old generation
        serving and re-flags staleness, so the next batch boundary tries
        again.  The reference's ``device_upload`` fault-injection site
        comes with the fault-tolerance slice (ROADMAP.md queue 1 item 8)."""
        mi = self.mutable
        t0 = time.perf_counter()
        try:
            gen, host, ids = mi.live_snapshot()
            t1 = time.perf_counter()
            prepared = self.backend.prepare_from_host(host)
        except BaseException:   # noqa: BLE001 — serving must survive
            self.stats.on_refresh_failure()
            self._stale = True
            return
        t2 = time.perf_counter()
        with self._device_lock:
            if gen <= self._loaded_gen:
                return   # a forced refresh() overtook this upload
            self.backend.install(prepared)
            self.last_refresh_times = {"snapshot_s": t1 - t0,
                                       "upload_s": t2 - t1,
                                       "install_s": time.perf_counter() - t2}
            self._ids = np.asarray(ids, dtype=np.int64)
            self._loaded_gen = gen
            self._last_refresh = time.perf_counter()
            self._stale = mi.generation != gen
        self.stats.on_refresh_swap()

    def refresh(self):
        """Bring the device index to the committed epoch now
        (synchronous: returns once served answers reflect it)."""
        self._maybe_refresh(force=True)

    @property
    def generation(self) -> int:
        """The committed generation the device index holds (−1 without a
        ``MutableIndex``)."""
        return self._loaded_gen

    # --- dispatch -----------------------------------------------------------

    def _dispatch(self, batch: list):
        """MicroBatcher callback: one padded, bucketed device pass."""
        self._maybe_refresh()
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
        tracing = self.tracer is not None
        try:
            with self._device_lock:
                t0 = time.perf_counter()
                with profiler_capture(self.cfg.profile_dir,
                                      self.backend.device):
                    idx, answer, d2 = self.backend.dispatch(
                        q, eps, is_knn, k_bucket, want_trace=tracing)
                t1 = time.perf_counter()
                trace = self.backend.last_trace
                ids = self._ids
        except BaseException:
            # The batcher resolves the batch FAILED; feed the breaker.
            self.breaker.on_failure()
            self.stats.set_breaker(self.breaker.state,
                                   self.breaker.state_code)
            raise
        self.breaker.on_success()
        self.stats.set_breaker(self.breaker.state, self.breaker.state_code)
        if not tracing:
            for i, req in live:
                self._finish(req, idx[i], answer[i], d2[i], ids)
            return
        # The dispatch's outputs are on the host already (the backend
        # copies them), so t1 − t0 covers the whole device pass with no
        # sync added to measure it.
        self.tracer.record("dispatch", t0, t1, batch=len(live), bucket=qb,
                           k=k_bucket)
        self.calibration.record(
            batch=len(live), k=k_bucket, backend=type(self.backend).__name__,
            measured_s=t1 - t0, estimate=self.backend.cost_estimate(
                qb, k_bucket))
        with self.tracer.span("verify", batch=len(live)):
            live_trace = select_queries(trace, [i for i, _ in live])
            totals = trace_totals(live_trace, self.backend.size)
            totals.update(self.backend.trace_bytes(live_trace))
            self.stats.on_cascade(totals)
        with self.tracer.span("reply", batch=len(live)):
            for i, req in live:
                self._finish(req, idx[i], answer[i], d2[i], ids)

    def _finish(self, req: Request, idx_row, answer_row, d2_row, ids_map):
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
        if ids_map is not None:
            rows = ids_map[rows]
        req._resolve(OK, ids=np.asarray(rows, dtype=np.int64),
                     distances=dist.astype(np.float64))

    def _postprocess(self, req: Request, rows, dist):
        """Answer-shaping hook between the device pass and the response:
        the base service returns the candidates as they are; the
        subsequence service's exclusion zone overrides it.  It runs the
        same on the batched and the direct path, so a replay still
        matches its batch."""
        return rows, dist

    # --- observability surface ----------------------------------------------

    def metrics_text(self) -> str:
        """The Prometheus text exposition of this service (what
        ``launch/serve.py --metrics`` serves), rebuilt per call from the
        stats snapshot and, when tracing, the calibration and span
        aggregates: no work on the request path."""
        from ..obs.metrics import build_registry

        cal = self.calibration.summary() if self.calibration else None
        spans = self.tracer.counts() if self.tracer else None
        return build_registry(self.stats.snapshot(), cal, spans).render()

    # --- unbatched reference path -------------------------------------------

    def direct_query(self, kind: str, query, epsilon: float = 0.0,
                     k: int = 0, meta: Optional[dict] = None):
        """One request, one device pass, no queue — the reference the
        exactness check replays against.  k is bucketed as in
        :meth:`_dispatch`, so the replay takes the same engine path;
        ``meta`` carries the answer-shaping hints a batched submit would
        attach, so the replay runs the same :meth:`_postprocess`."""
        self._maybe_refresh()
        n = self.backend.n
        q = np.asarray(query, dtype=np.float32).reshape(1, n)
        is_knn = np.asarray([kind == KIND_KNN])
        eps = np.asarray([0.0 if is_knn[0] else epsilon], np.float32)
        kk = _pow2_at_least(max(int(k), 1, self._k_floor), self.backend.size)
        with self._device_lock:
            idx, answer, d2 = self.backend.dispatch(q, eps, is_knn, kk)
            ids = self._ids
        req = Request(kind=kind, query=q[0], epsilon=epsilon,
                      k=max(int(k), 1), meta=meta)
        self._finish(req, idx[0], answer[0], d2[0], ids)
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
                   excl: Optional[int] = None,
                   device=None) -> "SubseqSearchService":
        """Warm start from a committed ``core.subseq.save_subseq_index``
        store (either package's): an mmap open of the streams and window
        features, uploaded to ``device`` (default: CUDA; raises without
        one)."""
        from ..core.subseq import load_subseq_index, subseq_device_index

        return cls(subseq_device_index(load_subseq_index(path),
                                       resolve_device(device)), cfg,
                   excl=excl)

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
