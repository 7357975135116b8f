"""Online query serving on the PyTorch engines.

``SearchService`` turns the batched device engines into a long-lived
service: bounded-queue admission control, per-request deadlines, dynamic
micro-batching into shape-bucketed device passes and p50/p95/p99 latency
accounting; ``SubseqSearchService`` serves the windows of long streams
the same way.  Counterpart of ``repro/serve`` (single-device part).
"""
from .batcher import (FAILED, KIND_KNN, KIND_RANGE, OK, REJECTED_DEADLINE,
                      REJECTED_QUEUE_FULL, REJECTED_SHED, MicroBatcher,
                      Request)
from .loadgen import (LoadResult, WorkloadSpec, check_exactness,
                      make_workload, run_closed_loop)
from .service import SearchService, ServeConfig, SubseqSearchService
from .stats import StatsTracker

__all__ = [
    "FAILED", "KIND_KNN", "KIND_RANGE", "OK", "REJECTED_DEADLINE",
    "REJECTED_QUEUE_FULL", "REJECTED_SHED", "MicroBatcher", "Request",
    "LoadResult", "WorkloadSpec", "check_exactness", "make_workload",
    "run_closed_loop", "SearchService", "ServeConfig", "StatsTracker",
    "SubseqSearchService",
]
