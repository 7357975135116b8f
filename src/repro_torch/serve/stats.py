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

    def on_served(self, latency_s: float):
        with self._lock:
            self.served += 1
            self._latency.append(latency_s)

    def on_escalation(self, n: int = 1):
        with self._lock:
            self.escalations += n

    def on_demotion(self, n: int = 1):
        with self._lock:
            self.demotions += n

    def on_certificates(self, exact: int, total: int):
        with self._lock:
            self.certified_exact += int(exact)
            self.certified_total += int(total)

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
