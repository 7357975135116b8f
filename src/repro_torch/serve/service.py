"""The online FAST_SAX query service.

Counterpart of ``repro/serve/service.py`` (``ServeConfig``, the
backends, ``SearchService``, ``SubseqSearchService``).  Request flow:

    submit → bounded queue (admission control, deadlines)
           → micro-batch  (MicroBatcher drains and coalesces)
           → bucket       (Q padded to a power of two, k to a power of two)
           → dispatch     (one mixed range/k-NN device pass: the fused
                           CUDA kernels on a CUDA index, else the torch
                           engine with capacity escalation; or, with
                           ``quantization``, the tiered engine over the
                           quantized resident tier; or the sharded
                           engines of ``core/dist_search.py`` over a mesh,
                           or independent failover shards)
           → respond      (per-request ids and distances, mapped to
                           external ids, latency)

Warm start: ``SearchService.from_store`` takes a committed store of
either package — a ``MutableIndex`` root (which also turns on live
ingest), a plain store, a plain store with a quantized tier, or a sharded
store of either kind (``index/sharded.py``) — and uploads it once.

Fault tolerance: ``ServeConfig(failover_shards=P)`` serves through
``core.dist_search.FailoverShards`` (per-shard timeouts, retries,
down-marking, probes); a lost shard degrades a batch to a
certified-partial answer (``Request.exact`` False, ``Request.coverage``)
instead of an outage.  A circuit breaker sheds batches while dispatches
keep failing, :meth:`SearchService.health` is the ``/healthz`` body, and
the chaos sites ``serve_dispatch`` and ``device_upload``
(``runtime/chaos.py``) sit where the reference has them.

Live ingest: ``insert`` / ``delete`` go through the ``MutableIndex``
(durable, crash-safe); its commit hook marks the device copy stale, and
at the next batch boundary the dispatcher swaps in a freshly uploaded
live view, in the background by default (``async_refresh``), at most
once per ``refresh_min_interval_s``.  One lock covers the swap, every
device pass and the ids snapshot that maps its row positions, so no
batch maps one generation's positions through another's ids.

Stages (always on, ``stats.snapshot()["stages"]`` and ``["d2h_bytes"]``):
every device pass of ``_SingleBackend`` and ``_QuantizedBackend`` times
``represent`` (the queries' upload and representation), ``engine`` (the
engine, up to the copy), ``compact`` (a dense pass's answers compacted on
the device, ``_SingleBackend`` only) and ``copy`` (the answers to the
host) on the host clock and, on a card, with CUDA events on the current
stream read after the copy's own sync (a traced dispatch's counting pass
falls between them, in no stage).  The service records every pass of
every backend, with its bytes, the answer slots its compaction kept
(``answer_slots``), its certificates and its requests, before it replies
to any of them; every served request adds ``queue``, ``reply_wait``,
``reply.knn`` / ``reply.range`` (the select step of :meth:`_finish`) and
``postprocess``, and the candidate slots its select step read to
``select_slots``.  While a ``torch.profiler`` records, each stage that is
work on the dispatcher thread (all but the two waits) is also a
``repro.<stage>`` range on the profiler's timeline.

Tracing (``ServeConfig(trace=True)``): the cascade counters of every
batch (``obs.trace.QueryTrace``, counted on the device and copied as
(Q, L) and (Q,) counters only) into ``stats``, a bounded span ring
(``tracer``: enqueue, batch form, dispatch and its stages, the cascade
count, reply and each request's stages, with request and batch ids), the
cost-model calibration of every dispatch against its ``engine`` stage's
device time (``calibration``) and the Prometheus text
(:meth:`SearchService.metrics_text`); ``profile_dir`` wraps every
batch's dispatch in a ``torch.profiler`` capture.  All off by default:
the untraced service keeps none of that state.
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
from ..core.engine import (_SEED_EPS_MAX, DeviceIndex, TieredIndex,
                           build_device_index, compact_dense,
                           device_index_from_host,
                           device_trace_bytes, mixed_query,
                           mixed_dense_trace, mixed_query_dense,
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
from ..obs.trace import (screen_row_bytes, select_queries, tier_bytes,
                         to_host, trace_totals)
from ..runtime import chaos
from .batcher import (BREAKER_OPEN, FAILED, KIND_KNN, KIND_RANGE, OK,
                      REJECTED_SHED, CircuitBreaker, MicroBatcher, Request)
from .stats import StatsTracker, reply_stage


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
    failover_shards: int = 0       # >0: serve through FailoverShards
    #                                (from_series splits into this many;
    #                                from_store uses the store's count)
    shard_timeout_s: float = 30.0  # per-shard attempt timeout floor
    shard_retries: int = 2         # transient-fault retries per shard
    shard_backoff_s: float = 0.02  # exponential-backoff base
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


# Its _is_profiler_enabled flag: one global read, so no profiler range
# object is made while none records.
_PROFILER = torch.autograd.profiler


def _staged(name: str, fn, *args):
    """``fn(*args)``, inside a ``name`` range while a profiler records."""
    if _PROFILER._is_profiler_enabled:
        with torch.profiler.record_function(name):
            return fn(*args)
    return fn(*args)


#: Mask slots a block of :func:`_answer_slots`' first, vectorised read.
_SCAN_BLOCK = 512


def _answer_slots(answer_row) -> np.ndarray:
    """``np.flatnonzero(answer_row)``, reading most of a sparse row once,
    as blocks of :data:`_SCAN_BLOCK` slots, with a vectorised ``any``:
    only the blocks that hold an answer go through ``flatnonzero``, whose
    loop over a 2^22-slot row takes milliseconds (4-7 ms with numpy 2.3
    on an H100's host, where the block read takes under one)."""
    nb = answer_row.size // _SCAN_BLOCK
    head = answer_row[: nb * _SCAN_BLOCK].reshape(nb, _SCAN_BLOCK)
    blk = np.flatnonzero(head.any(axis=1))
    p = np.flatnonzero(head[blk])
    tail = np.flatnonzero(answer_row[nb * _SCAN_BLOCK:]) + nb * _SCAN_BLOCK
    return np.concatenate((blk[p // _SCAN_BLOCK] * _SCAN_BLOCK
                           + p % _SCAN_BLOCK, tail))


def _select(req: Request, idx_row, answer_row, d2_row):
    """A reply's select step: a k-NN request's k nearest rows, ascending
    (d², slot) (slots are in row order, so ties go to the lowest database
    row), or a range request's answer rows; their rows and distances.

    Its candidates are the answer mask's slots with a finite d²: every
    engine sets d² = +inf off its answers, so the rows of a dense (Q, B)
    pass are never sorted whole.  The slots it read are noted in
    ``req.select_slots``."""
    s = _answer_slots(answer_row)
    req.select_slots = int(s.size)
    s = s[np.isfinite(d2_row[s])]
    if req.kind == KIND_KNN:
        s = s[np.lexsort((s, d2_row[s]))][: req.k]
    return idx_row[s], np.sqrt(d2_row[s])


class _PassClock:
    """The stages of one device pass, opened in order with :meth:`next`
    (``represent`` first) and closed by :meth:`close` after the copy.

    Each boundary is a ``time.perf_counter`` stamp and, on a CUDA device, a
    timing event recorded on the device's current stream; the events are
    the backend's, reused pass after pass (no device memory is allocated),
    and read once at the close, after the copy has synchronised the stream,
    so the timing adds no sync inside the pass.  On a CPU device a stage's
    device seconds are its host seconds."""

    def __init__(self, device: torch.device, events: list):
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)
        self._events = events
        self._times: list = []
        self._names: list = []     # the stage each later boundary closes
        self._stamp()
        self._open("represent")

    def _stamp(self) -> None:
        if self._stream is not None:
            i = len(self._times)
            if i == len(self._events):
                self._events.append(torch.cuda.Event(enable_timing=True))
            self._events[i].record(self._stream)
        self._times.append(time.perf_counter())

    def _open(self, name) -> None:
        self._name = name
        self._range = None
        if name and _PROFILER._is_profiler_enabled:
            self._range = torch.profiler.record_function("repro." + name)
            self._range.__enter__()

    def _shut(self) -> None:
        self.abort()
        self._stamp()
        self._names.append(self._name)

    def next(self, name) -> None:
        """Close the open stage and open ``name`` (None: a step that is no
        stage, such as a traced dispatch's counting pass)."""
        self._shut()
        self._open(name)

    def abort(self) -> None:
        """Close the open stage's profiler range (a pass that raised
        calls it too)."""
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def close(self) -> tuple:
        """Close the last stage; ``((name, t0, t1, device_s), ...)``."""
        self._shut()
        t, ev = self._times, self._events
        if self._stream is not None:
            ev[len(t) - 1].synchronize()
        return tuple(
            (name, t[i], t[i + 1],
             ev[i].elapsed_time(ev[i + 1]) / 1e3 if self._stream is not None
             else t[i + 1] - t[i])
            for i, name in enumerate(self._names) if name is not None)


def _trace_to_host(backend, trace) -> None:
    """Keep a dispatch's trace as host counters (None when untraced)."""
    backend.last_trace = None if trace is None else to_host(trace)


def _to_host(backend, out: tuple, clock: Optional[_PassClock] = None,
             count: Optional[np.ndarray] = None):
    """Copy a dispatch's ``(idx, answer, d2, overflow)`` to the host, close
    the pass's ``clock`` (its ``copy`` stage open) into ``last_stages``,
    note the bytes in ``last_d2h_bytes`` and the per-query certificates in
    ``last_certified`` (a query is exact when no buffer of it overflowed:
    ``overflow`` is (Q,), or (Q, P) over shards), return ``(idx, answer,
    d2)``.  A compacted pass hands ``(idx, d2, overflow)`` and its (Q,)
    host answer ``count``: the mask does not cross, slot j of row i is an
    answer when j < count[i], and the counts' bytes and slots are noted
    too (``last_answer_slots``).  The service records the pass in its
    stats."""
    out = [t.cpu().numpy() for t in out]
    backend.last_stages = clock.close() if clock is not None else ()
    nbytes = sum(a.nbytes for a in out)
    backend.last_answer_slots = 0
    if count is not None:
        idx, d2, overflow = out
        out = [idx, np.arange(idx.shape[-1]) < count[:, None], d2, overflow]
        nbytes += count.nbytes
        backend.last_answer_slots = int(count.sum())
    backend.last_d2h_bytes = nbytes
    bad = out[3].reshape(out[3].shape[0], -1).any(axis=-1)
    backend.last_certified = (int(bad.size - bad.sum()), int(bad.size))
    return tuple(out[:3])


class _SingleBackend:
    """One DeviceIndex on one device.

    On the ``cuda`` backend every micro-batch is one fused mixed pass
    (``mixed_query_fused``: a top-k tightening pass and a dense range pass)
    in the dense (Q, B) layout.  On ``torch`` the compacting
    ``mixed_query`` runs with sticky capacity escalation, switching for
    good to ``mixed_query_dense`` once the learned capacity passes
    ``dense_fallback_frac``·B, so a direct replay takes the same path as
    the batch that served it.  A dense pass is compacted on the device
    (``compact_dense``: each row's answer slots ascending, C the batch's
    largest answer count) before its copy, so the host receives the
    answers and not Q × B slots.  An index with a stack beyond the paper
    pair serves the same way: the kernels answer with the paper pair's
    cascade, the torch engine applies the extras too.
    """

    def __init__(self, index: DeviceIndex, cfg: ServeConfig):
        self.index = index
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, index.device)
        self._cap: Optional[int] = None   # learned capacity or _DENSE
        self.stats: Optional[StatsTracker] = None   # set by SearchService
        # Bytes the last dispatch copied from the device to the host, the
        # answer slots its compaction kept, its stages ((name, t0, t1,
        # device_s), _PassClock), its certificates (exact, total) and its
        # trace (host counters) when it was asked for one.
        self.last_d2h_bytes = 0
        self.last_answer_slots = 0
        self.last_stages = ()
        self.last_certified = None
        self.last_trace = None
        self._events: list = []    # the pass clock's CUDA events

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
        self._events = []

    def trace_bytes(self, trace) -> dict:
        return device_trace_bytes(self.index, trace)

    def cost_estimate(self, Q: int, k: int) -> dict:
        return fused_pass_estimate(Q, self.size, self.n, self.index.levels,
                                   self.index.alphabet, k=int(k))

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int, want_trace: bool = False):
        """One device pass: ``(idx, answer, d2)`` on the host, its stages
        in ``last_stages``.  With ``want_trace`` the batch's
        trace is counted on the device before the copy (outside the
        stages) and kept in ``last_trace`` as host counters."""
        clock = _PassClock(self.index.device, self._events)
        try:
            return self._pass(q, eps, is_knn, k, want_trace, clock)
        except BaseException:
            clock.abort()
            raise

    def _pass(self, q, eps, is_knn, k, want_trace, clock):
        B, dev = self.size, self.index.device
        qr = represent_queries(torch.as_tensor(q, dtype=torch.float32,
                                               device=dev),
                               self.index.levels, self.index.alphabet,
                               normalize=self.cfg.normalize_queries,
                               stack=self.index.stack)
        eps_t = torch.as_tensor(eps, dtype=torch.float32, device=dev)
        knn_t = torch.as_tensor(is_knn, dtype=torch.bool, device=dev)
        clock.next("engine")
        # Large k buckets demote the fused path to torch; the decision is
        # a function of (backend, k bucket) only, so every batch and every
        # direct replay of a bucket takes the same float path.
        fused = resolve_knn_backend(self.backend, k, dev) == "cuda"
        if self.stats is not None and self.backend == "cuda" and not fused:
            self.stats.on_demotion()
        dense = False
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
                dense = True
                idx, answer, d2, overflow = mixed_query_dense(
                    self.index, qr, eps_t, knn_t, k)
        trace = None
        if want_trace:
            # The counting pass, outside the engine stage.
            clock.next(None)
            trace = (mixed_dense_trace(self.index, qr, eps_t, knn_t, k,
                                       answer) if dense else
                     mixed_trace(self.index, qr, eps_t, knn_t, k, answer, d2))
        _trace_to_host(self, trace)
        if fused or dense:
            clock.next("compact")
            count, idx, d2 = compact_dense(answer, d2)
            clock.next("copy")
            return _to_host(self, (idx, d2, overflow), clock, count)
        clock.next("copy")
        return _to_host(self, (idx, answer, d2, overflow), clock)


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
        # compaction capacity it reached, its stages, its certificates and
        # its trace when asked for.
        self.last_d2h_bytes = 0
        self.last_answer_slots = 0     # no dense pass compacted
        self.last_capacity = 0
        self.last_stages = ()
        self.last_certified = None
        self.last_trace = None
        self._events: list = []

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
        self._events = []

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
        clock = _PassClock(self.tindex.dev.device, self._events)
        try:
            return self._pass(q, eps, is_knn, k, want_trace, clock)
        except BaseException:
            clock.abort()
            raise

    def _pass(self, q, eps, is_knn, k, want_trace, clock):
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
        clock.next("engine")
        idx, answer, d2, overflow = quantized_mixed_query(
            self.tindex, qr, eps_t, knn_t, k,
            options=SearchOptions(backend=self.cfg.backend, capacity=cap,
                                  verify_prefetch=self.cfg.verify_prefetch))
        self.last_capacity = int(idx.shape[-1])
        if want_trace:
            clock.next(None)
        _trace_to_host(self, quantized_mixed_trace(
            qdev, qr, eps_t, knn_t, k, answer, d2) if want_trace else None)
        clock.next("copy")
        return _to_host(self, (idx, answer, d2, overflow), clock)


def _host_index(series: np.ndarray, cfg: ServeConfig, normalize: bool):
    """The host index a tiered service quantizes."""
    return build_index(series, FastSAXConfig(
        n_segments=tuple(cfg.levels), alphabet=cfg.alphabet,
        stack=tuple(cfg.stack)), normalize=normalize)


def _failover_kw(cfg: ServeConfig) -> dict:
    """The ``FailoverShards`` knobs a ServeConfig sets."""
    return dict(timeout_s=cfg.shard_timeout_s, retries=cfg.shard_retries,
                backoff_s=cfg.shard_backoff_s, n_iters=cfg.n_iters,
                normalize_queries=cfg.normalize_queries, backend=cfg.backend)


class _ShardedBackend:
    """The database sharded over a mesh (``dist_search.ShardedDeviceIndex``),
    ``distributed_mixed_query`` per micro-batch: on the ``cuda`` backend
    every shard runs kernels 1-2 and compacts its dense answers into a
    per-shard buffer.  Capacity escalation (×4 up to the shard size) is
    sticky: the learned per-shard capacity stays for later batches, as in
    the reference."""

    def __init__(self, index, mesh, n_valid: int, cfg: ServeConfig,
                 axis: str = "data"):
        self.index = index
        self.mesh = mesh
        self.axis = axis
        self.n_valid = int(n_valid)
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, index.device)
        self._cap: Optional[int] = None   # learned per-shard capacity
        self.stats: Optional[StatsTracker] = None   # set by SearchService
        self.last_d2h_bytes = 0
        self.last_answer_slots = 0     # no dense pass compacted
        self.last_stages = ()          # no stages timed
        self.last_certified = None
        self.last_trace = None

    @property
    def n(self) -> int:
        return self.index.n

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def size(self) -> int:
        return self.n_valid

    def trace_bytes(self, trace) -> dict:
        rb = screen_row_bytes(self.index.levels, self.index.alphabet)
        return tier_bytes(trace, self.n_valid, rb, self.n)

    def cost_estimate(self, Q: int, k: int) -> dict:
        # Per-shard figure: each shard screens its own rows.
        return fused_pass_estimate(Q, self.index.b_loc, self.n,
                                   self.index.levels, self.index.alphabet,
                                   k=int(k))

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int, want_trace: bool = False):
        from ..core.dist_search import (distributed_cascade_trace,
                                        distributed_mixed_query)

        b_loc = self.index.b_loc
        cap = self._cap or self.cfg.capacity0 or max(4 * k, 64)
        cap = min(int(cap), b_loc)
        while True:
            gidx, answer, d2, overflow = distributed_mixed_query(
                self.index, q, eps, is_knn, k, self.mesh, axis=self.axis,
                options=SearchOptions(
                    backend=self.cfg.backend, capacity=cap,
                    n_iters=self.cfg.n_iters,
                    normalize_queries=self.cfg.normalize_queries),
                n_valid=self.n_valid)
            if cap >= b_loc or not bool(overflow.any()):
                break
            if self.stats is not None:
                self.stats.on_escalation()
            cap = min(b_loc, cap * 4)
        self._cap = max(cap, self._cap or 0)
        gidx, answer, d2 = _to_host(self, (gidx, answer, d2, overflow))
        self.last_trace = None
        if want_trace:
            # Each row's final radius from the merged buffers (as
            # engine.mixed_trace), then the counting pass on every shard,
            # summed.
            d2a = np.where(answer, d2, np.inf)
            k_eff = max(1, min(int(k), d2a.shape[-1]))
            kth = np.partition(d2a, k_eff - 1, axis=-1)[:, k_eff - 1]
            eps_knn = np.sqrt(np.maximum(kth, 0.0))
            eps_knn = np.where(np.isfinite(eps_knn), eps_knn,
                               _SEED_EPS_MAX)
            eps_f = np.where(is_knn, eps_knn, eps).astype(np.float32)
            trace = distributed_cascade_trace(
                self.index, q, eps_f, self.mesh, axis=self.axis,
                normalize_queries=self.cfg.normalize_queries,
                n_valid=self.n_valid)
            n_ans = np.isfinite(d2a).sum(axis=-1).astype(np.int32)
            answers = np.where(is_knn, np.minimum(n_ans, k_eff), n_ans)
            self.last_trace = dataclasses.replace(
                to_host(trace), answers=answers.astype(np.int32))
        return gidx, answer, d2


class _DistQuantizedBackend:
    """Distributed tiered serving: each mesh device holds its shard's
    quantized screen columns and screens them with kernel 5 on ``cuda``;
    only the survivors' global ids cross shards, and the exact verify
    gathers just those rows from the host raw tier (double-buffered with
    ``cfg.verify_prefetch``).  Escalation lives in
    ``dist_search.distributed_quantized_mixed_query``, so every answer is
    certified exact."""

    def __init__(self, dti, mesh, cfg: ServeConfig, axis: str = "data"):
        self.dti = dti
        self.mesh = mesh
        self.axis = axis
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, dti.device)
        self._cap: Optional[int] = None
        self.stats: Optional[StatsTracker] = None   # set by SearchService
        self.last_d2h_bytes = 0
        self.last_answer_slots = 0     # no dense pass compacted
        self.last_stages = ()          # no stages timed
        self.last_certified = None
        self.last_trace = None

    @property
    def n(self) -> int:
        return self.dti.n

    @property
    def device(self) -> torch.device:
        return self.dti.device

    @property
    def size(self) -> int:
        return int(self.dti.n_valid)

    def cost_estimate(self, Q: int, k: int) -> dict:
        return fused_pass_estimate(Q, self.dti.b_loc, self.n,
                                   self.dti.levels, self.dti.alphabet,
                                   k=int(k))

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int, want_trace: bool = False):
        from ..core.dist_search import distributed_quantized_mixed_query

        cap = self._cap or self.cfg.capacity0 or max(4 * k, 64)
        out = distributed_quantized_mixed_query(
            self.dti, q, eps, is_knn, k, self.mesh, axis=self.axis,
            options=SearchOptions(
                backend=self.cfg.backend, capacity=cap,
                normalize_queries=self.cfg.normalize_queries,
                verify_prefetch=self.cfg.verify_prefetch))
        self._cap = max(cap, self._cap or 0)
        return _to_host(self, out)


class _FailoverBackend:
    """Fault-tolerant sharded serving: ``core.dist_search.FailoverShards``
    (per-shard timeouts, retries, down-marking and probes) behind the
    backend interface.  A dispatch may succeed partially: the merged
    answer covers only the surviving shards, and ``last_coverage`` holds
    the ShardCoverage certificate the service attaches to every request
    of the batch."""

    def __init__(self, engine, cfg: ServeConfig):
        self.engine = engine
        self.cfg = cfg
        self.backend = resolve_backend(cfg.backend, engine.devices[0])
        self._stats: Optional[StatsTracker] = None
        self.last_coverage = None
        self.last_d2h_bytes = 0
        self.last_answer_slots = 0     # no dense pass compacted
        self.last_stages = ()          # no stages timed
        self.last_certified = None
        self.last_trace = None

    @property
    def stats(self):
        return self._stats

    @stats.setter
    def stats(self, tracker):
        self._stats = tracker
        if tracker is not None:
            def _on_event(kind, n=1):
                if kind == "retries":
                    tracker.on_retry(n)
                elif kind == "hedges":
                    tracker.on_hedge(n)
            self.engine.on_event = _on_event

    @property
    def n(self) -> int:
        return self.engine.n

    @property
    def device(self) -> torch.device:
        return self.engine.devices[0]

    @property
    def size(self) -> int:
        return self.engine.size

    def cost_estimate(self, Q: int, k: int) -> dict:
        from ..core.dist_search import _screen_of

        b_max = max(int(_screen_of(s).size) for s in self.engine.shards)
        return fused_pass_estimate(Q, b_max, self.n, self.engine.levels,
                                   self.engine.alphabet, k=int(k))

    def dispatch(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
                 k: int, want_trace: bool = False):
        gidx, answer, d2, overflow, cov = self.engine.query(
            q, eps, np.asarray(is_knn), k)
        self.last_coverage = cov
        self.last_d2h_bytes = gidx.nbytes + answer.nbytes + d2.nbytes
        # Capacity covers each full shard, so overflow is structurally
        # False: a query is exact iff every shard answered.
        bad = int(overflow.sum()) if cov.exact else gidx.shape[0]
        self.last_certified = (gidx.shape[0] - bad, gidx.shape[0])
        return gidx, answer, d2


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
        ``device`` (default: CUDA; raises without one).

        * ``mesh`` (``dist_search.ShardMesh``): the database padded and
          sharded over the mesh's devices (``distributed_build``, which
          z-normalises as the reference's does), or with
          ``cfg.quantization`` the tier resharded onto the mesh
          (``distributed_tiered_index``);
        * ``cfg.failover_shards``: that many independent failover shards
          (full precision only), placed by ``make_data_mesh`` on
          ``device``;
        * ``cfg.quantization``: built on the host, quantized into the
          resident tier on the device and served tiered;
        * else one ``DeviceIndex``."""
        series = np.asarray(series)
        if mesh is not None:
            from ..core.dist_search import (distributed_build,
                                            distributed_tiered_index,
                                            pad_database)
            if cfg.quantization != "none":
                tiered = TieredIndex.from_host(
                    _host_index(series, cfg, normalize), cfg.quantization,
                    device=mesh.devices[0])
                dti = distributed_tiered_index(tiered, mesh)
                return cls(_DistQuantizedBackend(dti, mesh, cfg), cfg)
            padded, n_valid = pad_database(series, mesh.shape["data"])
            index = distributed_build(padded, tuple(cfg.levels), cfg.alphabet,
                                      mesh, n_valid=n_valid,
                                      stack=tuple(cfg.stack))
            return cls(_ShardedBackend(index, mesh, n_valid, cfg), cfg)
        if cfg.failover_shards:
            if cfg.quantization != "none":
                raise ValueError("failover serving is full-precision — "
                                 "set quantization='none'")
            from ..core.dist_search import FailoverShards
            engine = FailoverShards.from_series(
                series, cfg.failover_shards, tuple(cfg.levels), cfg.alphabet,
                normalize=normalize, stack=tuple(cfg.stack),
                device=device, **_failover_kw(cfg))
            return cls(_FailoverBackend(engine, cfg), cfg)
        if cfg.quantization != "none":
            tiered = TieredIndex.from_host(_host_index(series, cfg, normalize),
                                           cfg.quantization,
                                           device=resolve_device(device))
            return cls(_QuantizedBackend(tiered, cfg), cfg)
        index = build_device_index(series, tuple(cfg.levels),
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
        * a sharded store (``index/sharded.py``): through
          ``FailoverShards`` with ``cfg.failover_shards``, else mapped
          onto ``mesh`` (default: the store's shard count over the
          visible cards, or every shard on ``device``);
        * a tiered sharded store: served quantized (it holds no
          full-precision screen columns) — failover tier shards, the
          distributed screen on a ``mesh``, else one tiered index;
        * a plain store: mmap-opened and uploaded once;
        * with ``cfg.quantization``, served tiered: a plain store with a
          stored tier of that mode serves it as it is, anything else is
          quantized in memory from the live view.

        ``levels`` / ``alphabet`` / ``stack`` come from the store, not
        ``cfg``.
        """
        from ..index import mutable as _mutable
        from ..index import sharded as _sharded
        from ..index import store as _store

        path = pathlib.Path(path)
        quant = cfg.quantization != "none"
        if (path / _mutable.CURRENT).exists():
            dev = resolve_device(device)
            mi = _mutable.MutableIndex.open(path)
            host, ids = mi.live_index()
            if quant:
                backend = _QuantizedBackend(TieredIndex.from_host(
                    host, cfg.quantization, device=dev), cfg)
            else:
                backend = _SingleBackend(device_index_from_host(host, dev),
                                         cfg)
            return cls(backend, cfg, ids=np.asarray(ids), mutable=mi)
        manifest = _store.read_manifest(path)
        kind = manifest.get("kind")
        if kind in (_sharded._KIND, _sharded._TIERED_KIND):
            from ..core import dist_search as _dist
            if kind == _sharded._KIND and quant:
                raise ValueError(
                    "quantized serving of a full-precision sharded store "
                    "is not supported — restore it with "
                    "store_sharded_quantized, or set quantization='none'")
            if cfg.failover_shards:
                engine = _dist.FailoverShards.from_store(
                    path, device=device, **_failover_kw(cfg))
                return cls(_FailoverBackend(engine, cfg), cfg)
            if kind == _sharded._TIERED_KIND:
                if mesh is not None:
                    dti = _dist.load_sharded_tiered(path, mesh)
                    return cls(_DistQuantizedBackend(dti, mesh, cfg), cfg)
                tiered, _n_valid = _sharded.load_sharded_quantized(
                    path, device=resolve_device(device))
                return cls(_QuantizedBackend(tiered, cfg), cfg)
            mesh = mesh or _dist.make_data_mesh(int(manifest["shards"]),
                                                device=device)
            index, n_valid = _dist.load_sharded(path, mesh)
            return cls(_ShardedBackend(index, mesh, n_valid, cfg), cfg)
        dev = resolve_device(device)
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

    def health(self):
        """Readiness probe body for ``/healthz``: ``(ready, detail)``.
        Not ready while the dispatcher is down, a drain is in progress,
        or the circuit breaker is open; a failover backend adds the last
        dispatch's shard coverage."""
        detail = {
            "running": self._batcher.running,
            "draining": self._batcher.draining,
            "breaker": self.breaker.state,
            "generation": self._loaded_gen,
            "stale": self._stale,
        }
        cov = getattr(self.backend, "last_coverage", None)
        if cov is not None:
            detail["coverage"] = cov.as_dict()
        ready = (self._batcher.running and not self._batcher.draining
                 and self.breaker.state != BREAKER_OPEN)
        return ready, detail

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
        the first requests pay no one-time costs (kernel build, caches).
        On a CUDA device the kernel library is built and loaded first,
        outside any dispatch: a failover shard's first attempt must not
        spend its timeout in ``nvcc``."""
        if self.backend.device.type == "cuda":
            from ..kernels import build
            build.load("fused_query")
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
                    self._record_pass(qb)
        return self

    def _record_pass(self, requests: int) -> tuple:
        """Record the backend's last device pass in the stats, under one
        lock: its stages, the bytes it copied to the host, its
        certificates, the ``requests`` it answered and the answer slots
        its compaction kept; return its stages ``((name, t0, t1,
        device_s), ...)``."""
        b = self.backend
        stages = b.last_stages
        self.stats.on_pass(
            [(name, t1 - t0, dev) for name, t0, t1, dev in stages],
            b.last_d2h_bytes, b.last_certified, requests,
            b.last_answer_slots)
        return stages

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
                chaos.maybe_fire("device_upload", key=str(gen))
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
        again (an injected ``device_upload`` fault takes this path)."""
        mi = self.mutable
        t0 = time.perf_counter()
        try:
            gen, host, ids = mi.live_snapshot()
            t1 = time.perf_counter()
            chaos.maybe_fire("device_upload", key=str(gen))
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
                chaos.maybe_fire("serve_dispatch")
                with profiler_capture(self.cfg.profile_dir,
                                      self.backend.device):
                    idx, answer, d2 = self.backend.dispatch(
                        q, eps, is_knn, k_bucket, want_trace=tracing)
                t1 = time.perf_counter()
                trace = self.backend.last_trace
                # Before any reply: a pass's bytes and its requests land
                # in the stats together.
                stages = self._record_pass(len(live))
                ids = self._ids
                coverage = getattr(self.backend, "last_coverage", None)
        except BaseException:
            # The batcher resolves the batch FAILED; feed the breaker.
            self.breaker.on_failure()
            self.stats.set_breaker(self.breaker.state,
                                   self.breaker.state_code)
            raise
        self.breaker.on_success()
        self.stats.set_breaker(self.breaker.state, self.breaker.state_code)
        # The answers are on the host from the end of the copy stage (the
        # end of the call for a backend without stages): each request's
        # reply_wait starts there.
        t_ready = stages[-1][2] if stages else t1
        for _, req in live:
            req.t_ready = t_ready
        if not tracing:
            for i, req in live:
                self._finish(req, idx[i], answer[i], d2[i], ids, coverage)
            return
        # The dispatch's outputs are on the host already (the backend
        # copies them), so t1 − t0 covers the whole device pass with no
        # sync added to measure it.
        bid = live[0][1].batch_id
        self.tracer.record("dispatch", t0, t1, batch=len(live), bucket=qb,
                           k=k_bucket, batch_id=bid)
        engine_s = t1 - t0
        for name, s0, s1, dev_s in stages:
            self.tracer.record(name, s0, s1, device_s=dev_s, batch_id=bid,
                               parent="dispatch")
            if name == "engine":
                engine_s = dev_s
        # The engine stage's device time (its kernels, torch ops and the
        # gaps between their launches), without the representation, the
        # counting pass, the copy and the sync (the whole call for a
        # backend without stages).
        self.calibration.record(
            batch=len(live), k=k_bucket, backend=type(self.backend).__name__,
            measured_s=engine_s, estimate=self.backend.cost_estimate(
                qb, k_bucket))
        if trace is not None:
            # The distributed tier and the failover shards count no trace.
            with self.tracer.span("cascade_count", batch=len(live),
                                  batch_id=bid):
                live_trace = select_queries(trace, [i for i, _ in live])
                totals = trace_totals(live_trace, self.backend.size)
                totals.update(self.backend.trace_bytes(live_trace))
                self.stats.on_cascade(totals)
        with self.tracer.span("reply", batch=len(live), batch_id=bid):
            for i, req in live:
                self._finish(req, idx[i], answer[i], d2[i], ids, coverage)
        for _, req in live:
            self._request_spans(req)

    def _request_spans(self, req: Request) -> None:
        """A replied request's stages as spans: ``reply_wait``, its
        ``reply.<kind>`` select step and ``postprocess`` (its ``queue``
        stage is the batcher's ``enqueue`` span)."""
        attrs = {"rid": req.rid, "batch_id": req.batch_id, "parent": "reply"}
        rec = self.tracer.record
        rec("reply_wait", req.t_ready, req.t_reply, **attrs)
        rec(reply_stage(req.kind), req.t_reply, req.t_selected, **attrs)
        rec("postprocess", req.t_selected, req.t_post, **attrs)

    def _finish(self, req: Request, idx_row, answer_row, d2_row, ids_map,
                coverage=None):
        """One request's reply from its row of the pass's answers; its
        stages stamped on ``req`` (``t_reply``, ``t_selected``,
        ``t_post``)."""
        req.t_reply = time.perf_counter()
        rows, dist = _staged("repro." + reply_stage(req.kind), _select, req,
                             idx_row, answer_row, d2_row)
        req.t_selected = time.perf_counter()
        rows, dist = _staged("repro.postprocess", self._postprocess, req,
                             rows, dist)
        req.t_post = time.perf_counter()
        if ids_map is not None:
            rows = ids_map[rows]
        if coverage is not None:
            # Certified-partial answer: exact over the surviving shards
            # only; the caller sees the gap instead of a wrong "exact".
            req.exact = bool(coverage.exact)
            req.coverage = coverage.as_dict()
            if not req.exact:
                self.stats.on_degraded()
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
        aggregates: no work on the request path.  The reference's
        families, then the stage and D2H byte counters."""
        from ..obs.metrics import build_registry, build_stage_registry

        cal = self.calibration.summary() if self.calibration else None
        spans = self.tracer.counts() if self.tracer else None
        snap = self.stats.snapshot()
        return (build_registry(snap, cal, spans).render()
                + build_stage_registry(snap).render())

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
            self._record_pass(1)
            ids = self._ids
            coverage = getattr(self.backend, "last_coverage", None)
        req = Request(kind=kind, query=q[0], epsilon=epsilon,
                      k=max(int(k), 1), meta=meta)
        self._finish(req, idx[0], answer[0], d2[0], ids, coverage)
        self.stats.on_select(req.select_slots)
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
