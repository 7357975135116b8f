"""Dynamic micro-batching: a bounded request queue + a dispatcher thread.

A copy of ``repro/serve/batcher.py`` (pure Python; the reference package
cannot be imported here because its ``serve`` package imports JAX).

The serving problem (DESIGN.md §6): requests arrive one at a time, but the
engines (``core/engine.py``) are batched — a device pass over Q queries
costs barely more than over one.
The batcher closes that gap:

  * **admission control** — the queue is bounded; a submit against a full
    queue is rejected immediately (backpressure beats unbounded latency),
    and a request whose deadline has already passed is rejected at the
    door;
  * **coalescing** — the dispatcher drains whatever is queued (up to
    ``max_batch``), waiting at most ``max_wait_ms`` for stragglers after
    the first request arrives (the dynamic part: under load the batch
    fills instantly and no waiting happens; when idle, a lone request pays
    at most the window);
  * **deadline enforcement** — requests that expired while queued are
    rejected at batch-formation time, never dispatched: a reply after the
    deadline is *stale*, and serving it would hide overload from the
    caller;
  * **shape bucketing** is the dispatch function's job (``service.py``
    pads the drained batch to a power-of-two bucket), so batch shapes
    come from a short fixed ladder.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Optional

import numpy as np

from .stats import StatsTracker

KIND_RANGE = "range"
KIND_KNN = "knn"

# Request terminal states.
OK = "ok"
REJECTED_QUEUE_FULL = "rejected_queue_full"
REJECTED_DEADLINE = "rejected_deadline"
REJECTED_SHED = "rejected_shed"   # breaker open / draining: load shed
FAILED = "failed"

# Circuit-breaker states (DESIGN.md §12).  The breaker turns a dispatch
# failure *storm* (every queued batch FAILs against a dead backend) into
# controlled shedding: after ``threshold`` consecutive failures it OPENs
# and batches are resolved REJECTED_SHED without touching the backend;
# after ``cooldown`` shed batches it lets exactly one probe batch
# through (HALF_OPEN) — success re-CLOSEs, failure re-OPENs.  Counting
# batches instead of wall clock keeps chaos replays deterministic.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
_BREAKER_CODE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1, BREAKER_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker for the dispatch path.  Driven by the
    single dispatcher thread (``allow``/``on_success``/``on_failure``);
    ``state`` may be read from any thread (/healthz, metrics)."""

    def __init__(self, threshold: int = 5, cooldown: int = 8):
        if threshold < 0 or cooldown < 1:
            raise ValueError("threshold must be >= 0, cooldown >= 1")
        self.threshold = int(threshold)   # 0 disables the breaker
        self.cooldown = int(cooldown)     # shed batches before a probe
        self._state = BREAKER_CLOSED
        self._consecutive = 0
        self._shed_batches = 0

    @property
    def state(self) -> str:
        return self._state

    @property
    def state_code(self) -> int:
        return _BREAKER_CODE[self._state]

    def allow(self) -> bool:
        """May this batch be dispatched?  While OPEN, counts the denial;
        after ``cooldown`` denials the next batch is the HALF_OPEN probe."""
        if self._state == BREAKER_CLOSED:
            return True
        if self._state == BREAKER_OPEN:
            if self._shed_batches >= self.cooldown:
                self._state = BREAKER_HALF_OPEN
                return True
            self._shed_batches += 1
            return False
        # HALF_OPEN: the probe is in flight on this very thread, so a
        # second allow() here means the probe's outcome never got
        # reported — fail safe by shedding.
        return False

    def on_success(self) -> None:
        self._state = BREAKER_CLOSED
        self._consecutive = 0
        self._shed_batches = 0

    def on_failure(self) -> None:
        self._consecutive += 1
        if self._state == BREAKER_HALF_OPEN or (
                self.threshold and self._consecutive >= self.threshold):
            self._state = BREAKER_OPEN
            self._shed_batches = 0


@dataclasses.dataclass(slots=True)
class Request:
    """One in-flight query.  ``wait()`` blocks the submitting thread until
    the dispatcher (or admission control) resolves it."""

    kind: str                      # KIND_RANGE | KIND_KNN
    query: np.ndarray              # (n,) float
    epsilon: float = 0.0           # range only
    k: int = 0                     # knn only
    deadline: Optional[float] = None   # absolute time.perf_counter() instant
    meta: Optional[dict] = None    # service-specific answer-shaping hints
    #                                (e.g. the subsequence service's
    #                                exclusion-zone parameters) — opaque to
    #                                the batcher, read by _postprocess hooks
    t_submit: float = 0.0
    status: str = ""
    ids: Optional[np.ndarray] = None
    distances: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    # Degraded-answer certificate (DESIGN.md §12): ``exact=False`` means
    # the answer covers only the surviving shards; ``coverage`` then
    # carries {shards_ok, shards_total, rows_ok, rows_total}.  Healthy
    # dispatches leave the defaults (exact, no coverage note).
    exact: bool = True
    coverage: Optional[dict] = None
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    # Ids for spans: the request's (the batcher's counter at submit) and
    # its batch's (at formation).  Stage stamps on time.perf_counter (0.0:
    # not reached), read by StatsTracker.on_served_batch: the batch formed,
    # the device pass's answers on the host, this request's reply started,
    # its select step done, its answer shaped, the request resolved.  And
    # the candidate slots its select step read.
    rid: int = 0
    batch_id: int = 0
    t_formed: float = 0.0
    t_ready: float = 0.0
    t_reply: float = 0.0
    t_selected: float = 0.0
    t_post: float = 0.0
    t_done: float = 0.0
    select_slots: int = 0

    def _resolve(self, status: str, ids=None, distances=None, error=None):
        self.t_done = time.perf_counter()
        self.status = status
        self.ids = ids
        self.distances = distances
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> str:
        """Block until resolved; returns the terminal status.  Raises the
        dispatch exception for FAILED requests — an engine error must not
        read as an empty answer set."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not resolved in {timeout}s")
        if self.status == FAILED and self.error is not None:
            raise self.error
        return self.status


class MicroBatcher:
    """Bounded queue + dispatcher thread.  ``dispatch_fn(batch)`` receives
    a non-empty list of un-expired requests and must resolve every one."""

    def __init__(
        self,
        dispatch_fn: Callable[[list], None],
        max_batch: int = 32,
        max_queue: int = 256,
        max_wait_ms: float = 2.0,
        stats: Optional[StatsTracker] = None,
        tracer=None,
        join_timeout_s: float = 30.0,
    ):
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self._dispatch_fn = dispatch_fn
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.join_timeout_s = float(join_timeout_s)
        self.stats = stats or StatsTracker()
        # Optional obs.spans.SpanRecorder: when set, every formed batch
        # records a "batch_form" span plus one "enqueue" span per member
        # (t_submit -> formation — queueing + coalescing time: the span of
        # the "queue" stage).  None (the default) keeps the hot path
        # span-free.
        self.tracer = tracer
        self._rids = itertools.count(1)
        self._batch_ids = itertools.count(1)
        self._queue: list = []
        self._cond = threading.Condition()
        self._stopping = False
        self._draining = False
        self._in_flight = 0
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stopping = False
        self._draining = False
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-serve-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop accepting work, fail anything still queued, join.
        Idempotent; raises if the dispatcher thread refuses to exit (a
        hung dispatch) — silently dropping the thread would report a
        clean shutdown while a daemon still holds the backend."""
        with self._cond:
            already = self._stopping and self._thread is None
            self._stopping = True
            pending, self._queue = self._queue, []
            self._cond.notify_all()
        if already:
            return
        self._fail_batch(pending, RuntimeError("service stopped"))
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self.join_timeout_s)
            if thread.is_alive():
                raise RuntimeError(
                    f"dispatcher thread failed to exit within "
                    f"{self.join_timeout_s:g}s — a dispatch is hung; "
                    f"the service is NOT cleanly stopped")
            self._thread = None

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful shutdown (SIGTERM path): stop *accepting* work but
        keep dispatching until the queue and the in-flight batch are
        empty (or ``timeout_s`` elapses), then stop.  New submissions
        during the drain are shed with REJECTED_SHED, not FAILED — the
        caller asked nicely, the answer is 'not here, retry elsewhere'.
        Returns True if the queue fully drained before the timeout."""
        with self._cond:
            self._draining = True
        deadline = time.perf_counter() + float(timeout_s)
        drained = False
        while time.perf_counter() < deadline:
            with self._cond:
                if not self._queue and self._in_flight == 0:
                    drained = True
                    break
            time.sleep(0.005)
        self.stop()
        return drained

    @property
    def running(self) -> bool:
        thread = self._thread
        return (thread is not None and thread.is_alive()
                and not self._stopping)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._queue)

    # --- submission ---------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Admission control: enqueue or reject immediately (never blocks)."""
        req.t_submit = time.perf_counter()
        req.rid = next(self._rids)
        self.stats.on_submit()
        if req.deadline is not None and req.t_submit >= req.deadline:
            self.stats.on_reject_deadline()
            req._resolve(REJECTED_DEADLINE)
            return req
        with self._cond:
            if self._stopping:
                req._resolve(FAILED, error=RuntimeError("service stopped"))
                self.stats.on_failed()
                return req
            if self._draining:
                self.stats.on_shed()
                req._resolve(REJECTED_SHED)
                return req
            if len(self._queue) >= self.max_queue:
                self.stats.on_reject_full()
                req._resolve(REJECTED_QUEUE_FULL)
                return req
            self._queue.append(req)
            self._cond.notify()
        return req

    # --- dispatcher ---------------------------------------------------------

    def _drain(self) -> list:
        """Wait for work, apply the coalescing window, return ≤ max_batch
        requests with expired ones rejected (not dispatched)."""
        with self._cond:
            while not self._queue and not self._stopping:
                self._cond.wait()
            if self._stopping:
                return []
            # Coalescing window: give stragglers max_wait to join, but stop
            # waiting the moment a full batch is available.
            t_window = time.perf_counter() + self.max_wait_s
            while len(self._queue) < self.max_batch:
                remaining = t_window - time.perf_counter()
                if remaining <= 0 or self._stopping:
                    break
                self._cond.wait(timeout=remaining)
            batch = self._queue[:self.max_batch]
            del self._queue[:len(batch)]
            # Claimed under the same lock the queue shrank under, so
            # drain() never observes "queue empty" while a batch is
            # between formation and dispatch.
            self._in_flight = len(batch)
        now = time.perf_counter()
        bid = next(self._batch_ids)
        live = []
        for req in batch:
            if req.deadline is not None and now >= req.deadline:
                self.stats.on_reject_deadline()
                req._resolve(REJECTED_DEADLINE)
            else:
                req.t_formed, req.batch_id = now, bid
                live.append(req)
        if self.tracer is not None and batch:
            t_first = min(r.t_submit for r in batch)
            self.tracer.record("batch_form", t_first, now,
                               batch=len(live), expired=len(batch) - len(live),
                               batch_id=bid)
            for req in live:
                self.tracer.record("enqueue", req.t_submit, now,
                                   kind=req.kind, rid=req.rid, batch_id=bid)
        return live

    def _loop(self):
        while True:
            batch = self._drain()
            try:
                with self._cond:
                    stopping = self._stopping
                if stopping:
                    # A batch drained in the stop() window must still be
                    # resolved — an abandoned request would block its
                    # submitter until timeout.
                    self._fail_batch(batch, RuntimeError("service stopped"))
                    break
                if not batch:
                    continue
                try:
                    self._dispatch_fn(batch)
                except BaseException as e:  # noqa: BLE001 — resolve, don't die
                    self._fail_batch(batch, e)
                else:
                    # The dispatch contract says every request gets
                    # resolved; sweep so a request the dispatcher forgot
                    # fails loudly instead of hanging its submitter
                    # until timeout.
                    self._fail_batch(batch, RuntimeError(
                        "dispatch_fn returned without resolving request"))
                # Latency to each request's own resolution, not to the
                # batch's end, and its stages: one lock a batch.
                self.stats.on_served_batch(
                    [req for req in batch if req.status == OK])
            finally:
                with self._cond:
                    self._in_flight = 0

    def _fail_batch(self, batch: list, error: BaseException):
        """Fail every not-yet-resolved request; count only those."""
        n_failed = 0
        for req in batch:
            if not req._done.is_set():
                req._resolve(FAILED, error=error)
                n_failed += 1
        if n_failed:
            self.stats.on_failed(n_failed)
