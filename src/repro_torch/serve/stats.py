"""Latency/throughput accounting for the online query service.

A copy of ``repro/serve/stats.py`` (pure Python; the reference package
cannot be imported here because its ``serve`` package imports JAX).

One tracker per service; every counter is updated under a single lock by
the submitting client threads and the dispatcher thread.  Percentiles are
computed over a bounded ring of recent samples (the service is long-lived;
an unbounded list would grow with every request ever served), so the
snapshot reports *recent* latency, which is what an operator watches.

The snapshot contract (DESIGN.md §10): every key is ALWAYS present with a
clean zero before any traffic — a tracker that has formed zero batches
reports ``mean_batch_size: 0.0`` and an all-zero ``latency_ms`` block,
never a missing key, NaN, or empty-percentile artifact — and rejection /
failure are reported as *rates* over submissions, not just counts, so a
dashboard can alert on them without keeping its own denominators.

Beyond the PR-3 request counters, the tracker carries the observability
counters of DESIGN.md §10: backend events (capacity escalations, fused→
torch demotions, exactness-certificate outcomes) and — when the service
runs with tracing enabled — the accumulated cascade pruning totals and
per-tier bytes from the engines' ``QueryTrace`` counters.

Always on, beside the request counters: the serving path's **stages**
(``snapshot()["stages"]``: per stage ``count``, ``host_s``, ``device_s``,
unrounded seconds) and the bytes the device passes copied to the host
(``d2h_bytes``) with the requests those passes answered
(``d2h_requests``, padding rows left out) and the answer slots their
compaction kept (``answer_slots``, C's padding left out).  A device pass
adds its stages (:data:`PASS_STAGES`, ``device_s`` from CUDA events on a
card, the host's seconds on a CPU), bytes, requests, answer slots and
certificates under one lock (:meth:`StatsTracker.on_pass`), before any of
its requests is replied to;
a batch adds its served requests' latencies and stages
(:data:`REQUEST_STAGES`, host work and waits, ``device_s`` 0) and the
candidate slots their select steps read (``select_slots``) under one lock
(:meth:`StatsTracker.on_served_batch`).
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

_RING = 8192   # latency / occupancy samples kept for percentile estimation

# Cascade accumulator keys — fixed so the snapshot (and the Prometheus
# families built from it) exposes clean zeros before the first traced
# dispatch, not a shape that changes when tracing turns on.
CASCADE_KEYS = ("queries", "rows_screened", "after_c9", "after_c10",
                "excluded_c9", "excluded_c10", "screen_survivors",
                "verified", "answers", "bytes_screen", "bytes_verify")

# The serving path's stages.  Per device pass: the queries' upload and
# representation, the engine up to the copy, the compaction of a dense
# pass's answers on the device, the copy of the answers to the host.  Per served request: the wait in the queue to its batch's
# formation, the wait from the end of the device pass to the start of its
# own reply, the reply's select step by request kind, and the
# answer-shaping hook (the subsequence exclusion zone).
PASS_STAGES = ("represent", "engine", "compact", "copy")
REQUEST_STAGES = ("queue", "reply_wait", "reply.knn", "reply.range",
                  "postprocess")
STAGE_KEYS = PASS_STAGES + REQUEST_STAGES


def reply_stage(kind: str) -> str:
    """The select stage of a request of ``kind`` (``serve.batcher``'s
    ``KIND_KNN``, ``"knn"``; any other kind replies as a range request)."""
    return "reply.knn" if kind == "knn" else "reply.range"


class StatsTracker:
    """Thread-safe request/batch accounting (DESIGN.md §6, §10).

    Counters: ``submitted``, ``served``, ``rejected_queue_full`` (admission
    control), ``rejected_deadline`` (expired before dispatch — never served
    stale), ``failed`` (dispatch raised), plus the backend event counters
    (``escalations``, ``demotions``, certificate outcomes).  Gauges: queue
    depth (sampled at every batch formation), batch occupancy (actual
    requests / padded bucket slots — the cost of shape bucketing).  Latency
    is measured submit→result per request, in seconds, and reported as
    p50/p95/p99 ms.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.t_start = time.perf_counter()
        self.submitted = 0
        self.served = 0
        self.rejected_queue_full = 0
        self.rejected_deadline = 0
        self.failed = 0
        self.batches = 0
        self.escalations = 0
        self.demotions = 0
        self.certified_exact = 0
        self.certified_total = 0
        # Fault-tolerance counters (DESIGN.md §12): shed = breaker-open /
        # draining rejections; degraded = answers served with exact=False
        # (partial shard coverage); retries / hedges = transient-fault
        # re-attempts and straggler re-dispatches in the failover engine;
        # refresh swaps/failures = background generation-swap outcomes.
        self.shed = 0
        self.degraded = 0
        self.retries = 0
        self.hedges = 0
        self.refresh_swaps = 0
        self.refresh_failures = 0
        self.breaker_state = "closed"
        self.breaker_state_code = 0
        self.cascade = collections.Counter({k: 0 for k in CASCADE_KEYS})
        # Per stage [count, host seconds, device seconds].
        self._stages = {k: [0, 0.0, 0.0] for k in STAGE_KEYS}
        self.d2h_bytes = 0
        self.d2h_requests = 0
        self.answer_slots = 0
        self.select_slots = 0
        self._latency = collections.deque(maxlen=_RING)
        self._occupancy = collections.deque(maxlen=_RING)
        self._queue_depth = collections.deque(maxlen=_RING)

    # --- recording (called by service / batcher) ---------------------------

    def on_submit(self):
        with self._lock:
            self.submitted += 1

    def on_reject_full(self):
        with self._lock:
            self.rejected_queue_full += 1

    def on_reject_deadline(self):
        with self._lock:
            self.rejected_deadline += 1

    def on_failed(self, n: int = 1):
        with self._lock:
            self.failed += n

    def on_batch(self, n_requests: int, bucket_slots: int, queue_depth: int):
        with self._lock:
            self.batches += 1
            self._occupancy.append(n_requests / max(1, bucket_slots))
            self._queue_depth.append(queue_depth)

    def on_served_batch(self, requests) -> None:
        """The served requests of one batch (``serve.batcher.Request``),
        under one lock: each one's latency, ``t_submit`` to ``t_done``,
        and the stages its stamps close (a zero stamp: not reached).
        ``queue``: ``t_submit`` to ``t_formed``; ``reply_wait``:
        ``t_ready`` to ``t_reply``; ``reply.knn`` (a k-NN request) or
        ``reply.range``: ``t_reply`` to ``t_selected``; ``postprocess``:
        ``t_selected`` to ``t_post``; and the candidate slots each select
        step read (``select_slots``)."""
        st = self._stages
        queue, wait, post = st["queue"], st["reply_wait"], st["postprocess"]
        with self._lock:
            for r in requests:
                self.served += 1
                self._latency.append(r.t_done - r.t_submit)
                if r.t_formed:
                    queue[0] += 1
                    queue[1] += r.t_formed - r.t_submit
                if r.t_reply:
                    if r.t_ready:
                        wait[0] += 1
                        wait[1] += r.t_reply - r.t_ready
                    sel = st[reply_stage(r.kind)]
                    sel[0] += 1
                    sel[1] += r.t_selected - r.t_reply
                    self.select_slots += r.select_slots
                    post[0] += 1
                    post[1] += r.t_post - r.t_selected

    def on_pass(self, stages=(), d2h_bytes: int = 0,
                certified: tuple | None = None, requests: int = 0,
                answer_slots: int = 0) -> None:
        """One device pass, under one lock: its stages as ``(name,
        host_s, device_s)``, the bytes of its answers copied to the host,
        its certificate outcomes ``(exact, total)``, the requests it
        answered (the bytes' denominator, kept in the same record) and the
        answer slots its compaction kept."""
        with self._lock:
            for name, host_s, device_s in stages:
                acc = self._stages[name]
                acc[0] += 1
                acc[1] += host_s
                acc[2] += device_s
            self.d2h_bytes += int(d2h_bytes)
            self.d2h_requests += int(requests)
            self.answer_slots += int(answer_slots)
            if certified is not None:
                self.certified_exact += int(certified[0])
                self.certified_total += int(certified[1])

    def on_select(self, slots: int) -> None:
        """The candidate slots of a select step outside a served batch
        (a direct replay)."""
        with self._lock:
            self.select_slots += int(slots)

    def on_escalation(self, n: int = 1):
        with self._lock:
            self.escalations += n

    def on_demotion(self, n: int = 1):
        with self._lock:
            self.demotions += n

    def on_shed(self, n: int = 1):
        with self._lock:
            self.shed += n

    def on_degraded(self, n: int = 1):
        with self._lock:
            self.degraded += n

    def on_retry(self, n: int = 1):
        with self._lock:
            self.retries += n

    def on_hedge(self, n: int = 1):
        with self._lock:
            self.hedges += n

    def on_refresh_swap(self):
        with self._lock:
            self.refresh_swaps += 1

    def on_refresh_failure(self):
        with self._lock:
            self.refresh_failures += 1

    def set_breaker(self, state: str, code: int):
        with self._lock:
            self.breaker_state = state
            self.breaker_state_code = int(code)

    def on_cascade(self, totals: dict):
        """Accumulate one traced dispatch's ``obs.trace.trace_totals`` /
        ``tier_bytes`` figures (any numeric keys; unknown keys are kept,
        so callers can extend the surface without touching this class)."""
        with self._lock:
            for key, val in totals.items():
                self.cascade[key] += int(val)

    # --- reading -----------------------------------------------------------

    def snapshot(self) -> dict:
        """A point-in-time summary; all latencies in milliseconds.  Every
        key present from construction — clean zeros, never NaN."""
        with self._lock:
            lat = np.asarray(self._latency, dtype=np.float64) * 1e3
            occ = np.asarray(self._occupancy, dtype=np.float64)
            depth = np.asarray(self._queue_depth, dtype=np.float64)
            elapsed = time.perf_counter() - self.t_start
            rejected = (self.rejected_queue_full + self.rejected_deadline
                        + self.shed)
            denom = max(1, self.submitted)
            out = {
                "submitted": self.submitted,
                "served": self.served,
                "rejected_queue_full": self.rejected_queue_full,
                "rejected_deadline": self.rejected_deadline,
                "rejected_shed": self.shed,
                "failed": self.failed,
                "breaker_state": self.breaker_state,
                "breaker_state_code": self.breaker_state_code,
                "batches": self.batches,
                "elapsed_s": round(elapsed, 3),
                "qps": round(self.served / elapsed, 1) if elapsed > 0 else 0.0,
                "reject_rate": round(rejected / denom, 6),
                "failure_rate": round(self.failed / denom, 6),
                "mean_batch_size":
                    round(self.served / self.batches, 2) if self.batches
                    else 0.0,
                "events": {
                    "escalations": self.escalations,
                    "demotions": self.demotions,
                    "certified_exact": self.certified_exact,
                    "certified_total": self.certified_total,
                    "degraded": self.degraded,
                    "retries": self.retries,
                    "hedges": self.hedges,
                    "refresh_swaps": self.refresh_swaps,
                    "refresh_failures": self.refresh_failures,
                },
                "cascade": dict(self.cascade),
                "stages": {k: {"count": c, "host_s": h, "device_s": d}
                           for k, (c, h, d) in self._stages.items()},
                "d2h_bytes": self.d2h_bytes,
                "d2h_requests": self.d2h_requests,
                "answer_slots": self.answer_slots,
                "select_slots": self.select_slots,
            }
        out["latency_ms"] = {
            "p50": round(float(np.percentile(lat, 50)), 3) if lat.size else 0.0,
            "p95": round(float(np.percentile(lat, 95)), 3) if lat.size else 0.0,
            "p99": round(float(np.percentile(lat, 99)), 3) if lat.size else 0.0,
            "mean": round(float(lat.mean()), 3) if lat.size else 0.0,
        }
        out["batch_occupancy"] = round(float(occ.mean()), 3) if occ.size \
            else 0.0
        out["queue_depth_mean"] = round(float(depth.mean()), 2) if depth.size \
            else 0.0
        out["queue_depth_max"] = int(depth.max()) if depth.size else 0
        return out
