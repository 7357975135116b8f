"""Query-path observability on the PyTorch engines.

Counterpart of ``repro/obs``.  Four surfaces over one query path, all off
by default:

  * :mod:`.trace`: ``QueryTrace``, the cascade counters (survivors after
    C9, after C10, after the series screen, verified rows, answers) that
    the engines' ``*_traced`` twins return beside unchanged answers;
  * :mod:`.spans`: a bounded ring of span records (enqueue → batch form
    → dispatch and its stages → cascade count → reply and each request's
    stages) with JSONL and Chrome trace export, and the opt-in
    ``torch.profiler`` capture;
  * :mod:`.metrics`: the Prometheus text registry the service exposes
    (``launch/serve.py --metrics``), with the serving stages' counters;
  * :mod:`.calibration`: per-dispatch predicted-against-measured latency
    residuals with the H100 roofline share.

Nothing here imports the engines or the serving layer: ``core`` and
``serve`` import ``obs``, never the reverse.
"""
from .calibration import CalibrationLog, DispatchRecord
from .metrics import (MetricsRegistry, build_registry, build_stage_registry,
                      start_metrics_server)
from .spans import SpanRecorder, profiler_capture
from .trace import (QueryTrace, excluded_c9, excluded_c10, merge_traces,
                    select_queries, tier_bytes, trace_totals)

__all__ = [
    "CalibrationLog", "DispatchRecord", "MetricsRegistry", "QueryTrace",
    "SpanRecorder", "build_registry", "build_stage_registry",
    "excluded_c9", "excluded_c10", "merge_traces", "profiler_capture",
    "select_queries", "start_metrics_server", "tier_bytes", "trace_totals",
]
