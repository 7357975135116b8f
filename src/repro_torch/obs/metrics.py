"""The live metrics surface: a Prometheus-text registry over the serving
stats.

A copy of ``repro/obs/metrics.py`` (pure Python): for the same stats
snapshot the rendered text is the reference's, byte for byte.
:func:`build_registry` flattens a ``serve.stats.StatsTracker`` snapshot
(plus the optional calibration summary and span-ring counts) into typed
metric families; :meth:`MetricsRegistry.render` emits the Prometheus text
exposition format (``# HELP`` / ``# TYPE`` / samples), and
:func:`start_metrics_server` serves it from a stdlib HTTP thread
(``launch/serve.py --metrics PORT``).

The registry is rebuilt per scrape from the snapshot, so it adds no work
to the request path; every family exists (with clean zeros) from the
first scrape because the snapshot has every key from construction.
``REQUIRED_FAMILIES`` is the contract a scrape is checked against.
:func:`build_stage_registry` adds the port's serving-path stage,
device-to-host byte, answer-slot and select-slot counters
(``STAGE_FAMILIES``), which the service renders after the reference's
families, at full precision.
``/healthz`` answers when a ``health_fn`` is given (the launcher passes
``SearchService.health``): 200 when ready, 503 when not, the detail as
JSON; without one it answers 404.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

# The families every scrape of a live service must expose.
REQUIRED_FAMILIES = (
    "repro_requests_total",
    "repro_request_rate",
    "repro_batches_total",
    "repro_latency_ms",
    "repro_qps",
    "repro_queue_depth",
    "repro_cascade_rows_total",
    "repro_tier_bytes_total",
    "repro_events_total",
    "repro_calibration_rel_err",
    "repro_roofline_fraction",
    # The fault-tolerance surface: degraded (partial-coverage) answers,
    # circuit-breaker state, failover retries / hedges, and background
    # generation-swap outcomes.
    "repro_degraded_total",
    "repro_breaker_state",
    "repro_retries_total",
    "repro_refresh_swaps_total",
)

# The serving path's stage counters (``serve.stats``: the snapshot's
# ``stages``, ``d2h_bytes``, ``answer_slots`` and ``select_slots``).
STAGE_FAMILIES = (
    "repro_stage_seconds_total",
    "repro_stage_events_total",
    "repro_d2h_bytes_total",
    "repro_answer_slots_total",
    "repro_select_slots_total",
)

_LABEL_ESC = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})


class MetricsRegistry:
    """Ordered metric families -> Prometheus text exposition.  Values
    render with ``value_format`` (the reference's ``g``: six significant
    digits)."""

    def __init__(self, value_format: str = "g"):
        self._families: dict = {}    # name -> (type, help, [(labels, value)])
        self._fmt = value_format

    def add(self, name: str, value, *, kind: str = "gauge",
            help_text: str = "", labels: dict | None = None) -> None:
        fam = self._families.setdefault(name, (kind, help_text, []))
        fam[2].append((dict(labels or {}), float(value)))

    def families(self) -> list:
        return list(self._families)

    def render(self) -> str:
        lines = []
        for name, (kind, help_text, samples) in self._families.items():
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                if labels:
                    inner = ",".join(
                        f'{k}="{str(v).translate(_LABEL_ESC)}"'
                        for k, v in sorted(labels.items()))
                    lines.append(f"{name}{{{inner}}} "
                                 f"{format(value, self._fmt)}")
                else:
                    lines.append(f"{name} {format(value, self._fmt)}")
        return "\n".join(lines) + "\n"


def build_registry(snapshot: dict, calibration: dict | None = None,
                   span_counts: dict | None = None) -> MetricsRegistry:
    """Flatten a stats snapshot (``serve.stats.StatsTracker.snapshot()``
    shape) into the registry.  ``calibration`` is
    ``obs.calibration.CalibrationLog.summary()``; ``span_counts`` is
    ``obs.spans.SpanRecorder.counts()``.  Both optional — the families
    still render (zeros) without them, so the surface does not change
    shape when tracing is off."""
    reg = MetricsRegistry()
    for outcome in ("served", "rejected_queue_full", "rejected_deadline",
                    "rejected_shed", "failed"):
        reg.add("repro_requests_total", snapshot.get(outcome, 0),
                kind="counter", labels={"outcome": outcome},
                help_text="Requests by terminal outcome")
    reg.add("repro_requests_total", snapshot.get("submitted", 0),
            kind="counter", labels={"outcome": "submitted"})
    for rate in ("reject_rate", "failure_rate"):
        reg.add("repro_request_rate", snapshot.get(rate, 0.0),
                labels={"kind": rate},
                help_text="Terminal-outcome rates over submissions")
    reg.add("repro_batches_total", snapshot.get("batches", 0),
            kind="counter", help_text="Micro-batches dispatched")
    reg.add("repro_mean_batch_size", snapshot.get("mean_batch_size", 0.0))
    reg.add("repro_batch_occupancy", snapshot.get("batch_occupancy", 0.0),
            help_text="Requests per padded bucket slot")
    lat = snapshot.get("latency_ms", {}) or {}
    for q in ("p50", "p95", "p99", "mean"):
        reg.add("repro_latency_ms", lat.get(q, 0.0),
                labels={"quantile": q},
                help_text="Submit-to-result latency (recent ring)")
    reg.add("repro_qps", snapshot.get("qps", 0.0),
            help_text="Served requests per second since start")
    reg.add("repro_queue_depth", snapshot.get("queue_depth_mean", 0.0),
            labels={"agg": "mean"},
            help_text="Queue depth sampled at batch formation")
    reg.add("repro_queue_depth", snapshot.get("queue_depth_max", 0),
            labels={"agg": "max"})
    cascade = snapshot.get("cascade", {}) or {}
    for stage in ("rows_screened", "after_c9", "after_c10", "excluded_c9",
                  "excluded_c10", "screen_survivors", "verified", "answers"):
        reg.add("repro_cascade_rows_total", cascade.get(stage, 0),
                kind="counter", labels={"stage": stage},
                help_text="Cascade pruning counters from QueryTrace "
                          "(traced dispatches only)")
    for tier in ("screen", "verify"):
        reg.add("repro_tier_bytes_total", cascade.get(f"bytes_{tier}", 0),
                kind="counter", labels={"tier": tier},
                help_text="Bytes touched per memory tier (traced "
                          "dispatches only)")
    events = snapshot.get("events", {}) or {}
    for kind in ("escalations", "demotions", "certified_exact",
                 "certified_total"):
        reg.add("repro_events_total", events.get(kind, 0), kind="counter",
                labels={"kind": kind},
                help_text="Backend events: capacity escalations, "
                          "pallas->xla demotions, exactness certificates")
    reg.add("repro_degraded_total", events.get("degraded", 0),
            kind="counter",
            help_text="Answers served with exact=False (partial shard "
                      "coverage under failover)")
    reg.add("repro_breaker_state", snapshot.get("breaker_state_code", 0),
            labels={"state": snapshot.get("breaker_state", "closed")},
            help_text="Dispatch circuit breaker: 0=closed 1=half_open "
                      "2=open")
    for kind in ("retries", "hedges"):
        reg.add("repro_retries_total", events.get(kind, 0), kind="counter",
                labels={"kind": kind},
                help_text="Failover re-attempts: transient-fault retries "
                          "and straggler hedges")
    for result in ("swap", "failure"):
        reg.add("repro_refresh_swaps_total",
                events.get(f"refresh_{result}s", 0), kind="counter",
                labels={"result": result},
                help_text="Background generation-swap outcomes "
                          "(non-blocking live-ingest refresh)")
    cal = calibration or {}
    reg.add("repro_calibration_rel_err", cal.get("mean_abs_rel_err", 0.0),
            labels={"agg": "mean_abs"},
            help_text="Cost-model (measured-predicted)/measured residual")
    reg.add("repro_calibration_rel_err", cal.get("mean_rel_err", 0.0),
            labels={"agg": "mean"})
    reg.add("repro_roofline_fraction", cal.get("mean_roofline_frac", 0.0),
            help_text="Roofline bound / measured dispatch time (mean)")
    reg.add("repro_calibration_samples", cal.get("n", 0), kind="counter")
    for name, count in sorted((span_counts or {}).items()):
        reg.add("repro_spans", count, labels={"name": name},
                help_text="Spans currently resident in the trace ring")
    return reg


def build_stage_registry(snapshot: dict) -> MetricsRegistry:
    """The stage families of a stats snapshot: seconds per stage and clock
    (``host``, ``device``), events per stage, the bytes the device
    passes copied to the host, the answer slots their compaction kept and
    the slots the select steps read;
    counters, rendered with 17 significant digits so that a rate over
    them is not rounded away.  Every stage of the snapshot renders, with
    zeros before traffic."""
    reg = MetricsRegistry(value_format=".17g")
    stages = snapshot.get("stages", {}) or {}
    for stage, acc in stages.items():
        for clock in ("host", "device"):
            reg.add("repro_stage_seconds_total", acc.get(f"{clock}_s", 0.0),
                    kind="counter", labels={"stage": stage, "clock": clock},
                    help_text="Seconds in each serving stage, on the host's "
                              "clock and on the device's (CUDA events)")
    for stage, acc in stages.items():
        reg.add("repro_stage_events_total", acc.get("count", 0),
                kind="counter", labels={"stage": stage},
                help_text="Device passes or served requests through each "
                          "serving stage")
    reg.add("repro_d2h_bytes_total", snapshot.get("d2h_bytes", 0),
            kind="counter",
            help_text="Bytes of answers copied from the device to the host")
    reg.add("repro_answer_slots_total", snapshot.get("answer_slots", 0),
            kind="counter",
            help_text="Answer slots the device passes' compaction kept")
    reg.add("repro_select_slots_total", snapshot.get("select_slots", 0),
            kind="counter",
            help_text="Candidate slots the replies' select steps read")
    return reg


class _MetricsHandler(BaseHTTPRequestHandler):
    render_fn = staticmethod(lambda: "")
    health_fn = None   # () -> (ready: bool, body: dict) | None

    def do_GET(self):  # noqa: N802  (http.server API)
        path = self.path.split("?")[0].rstrip("/")
        if path == "/healthz":
            self._do_healthz()
            return
        if path not in ("", "/metrics"):
            self.send_error(404)
            return
        body = type(self).render_fn().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _do_healthz(self):
        """Readiness: 200 while the service can accept work, 503 while
        the breaker is open or a drain is in progress — the signal a
        load balancer uses to route around a degraded replica."""
        health_fn = type(self).health_fn
        if health_fn is None:
            self.send_error(404)
            return
        ready, detail = health_fn()
        body = json.dumps(detail).encode()
        self.send_response(200 if ready else 503)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-scrape stderr noise
        pass


def start_metrics_server(render_fn, port: int, host: str = "127.0.0.1",
                         health_fn=None):
    """Serve ``render_fn()`` at ``http://host:port/metrics`` from a daemon
    thread.  When ``health_fn`` is given (``() -> (ready, detail_dict)``),
    ``/healthz`` answers 200/503 readiness with the detail as JSON.
    Returns the ``ThreadingHTTPServer`` — call ``.shutdown()``
    to stop; ``.server_address[1]`` carries the bound port (pass 0 to let
    the OS pick one)."""
    handler = type("_BoundMetricsHandler", (_MetricsHandler,),
                   {"render_fn": staticmethod(render_fn),
                    "health_fn": staticmethod(health_fn)
                    if health_fn is not None else None})
    server = ThreadingHTTPServer((host, int(port)), handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="repro-torch-metrics", daemon=True)
    thread.start()
    return server
