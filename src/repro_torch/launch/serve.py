"""The online query service event loop, driven by the closed-loop load
generator.

Counterpart of the ``--serve`` paths of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --serve \\
        --db-size 1048576 --bench-requests 64 --verify-exact \\
        [--quantization int8 [--verify-prefetch]]
    PYTHONPATH=src python -m repro_torch.launch.serve --serve --subseq \\
        --streams 16 --stream-len 262144 --bench-requests 64 --verify-exact

The first builds a wafer-like database of ``--db-size`` series of length
128 and serves a mixed range / k-NN workload (``--quantization``: from
the quantized resident tier); the second indexes every ``--window``-long
window of ``--streams`` wafer-like streams at ``--stride`` and serves
range and exclusion-zone k-NN requests on them.  Both print a final
machine-readable line ``[serve] summary {...}`` with
``"exact_mismatches": 0`` when every replayed request matched.  Runs on
CUDA unless ``--device cpu``.  ``--search`` (the one-shot distributed
search) needs the multi-device slice of the port and raises.
"""
from __future__ import annotations

import argparse
import json
import time


def serve_service(args) -> dict:
    from ..data.timeseries import make_queries, make_wafer_like
    from ..serve import (SearchService, ServeConfig, WorkloadSpec,
                         check_exactness, make_workload, run_closed_loop)

    cfg = ServeConfig(max_batch=args.max_batch, max_queue=args.max_queue,
                      max_wait_ms=args.max_wait_ms, alphabet=args.alphabet,
                      default_deadline_ms=args.deadline_ms or None,
                      backend=args.backend, quantization=args.quantization,
                      verify_prefetch=args.verify_prefetch)
    db = make_wafer_like(args.db_size, 128, seed=0)
    t0 = time.perf_counter()
    service = SearchService.from_series(db, cfg, device=args.device)
    tier = ("" if args.quantization == "none"
            else f", {args.quantization} resident tier")
    print(f"[serve] cold build: {args.db_size} rows on "
          f"{service.backend.device} ({service.backend.backend} "
          f"backend{tier}) in {time.perf_counter() - t0:.2f}s")
    queries = make_queries(db, max(args.queries, 16), seed=1)

    k = args.knn or 5
    t0 = time.perf_counter()
    service.warmup(ks=(k,))
    print(f"[serve] warmup {time.perf_counter() - t0:.1f}s")

    spec = WorkloadSpec(n_requests=args.bench_requests,
                        knn_frac=args.knn_frac, k=k,
                        epsilon=args.epsilon,
                        deadline_ms=args.deadline_ms or None)
    workload = make_workload(queries, spec)
    with service:
        result = run_closed_loop(service, workload, clients=args.clients,
                                 deadline_ms=spec.deadline_ms)
        mismatches = -1
        if args.verify_exact:
            mismatches = check_exactness(service, workload, result)
    snap = service.stats.snapshot()
    summary = result.summary(snap)
    summary["exact_mismatches"] = mismatches
    lat = snap.get("latency_ms", {})
    print(f"[serve] {summary['served']}/{summary['requests']} served at "
          f"{summary['qps']} qps; p50/p95/p99 = {lat.get('p50')}/"
          f"{lat.get('p95')}/{lat.get('p99')} ms; "
          f"mean batch {snap.get('mean_batch_size')}")
    print(f"[serve] summary {json.dumps(summary, sort_keys=True)}")
    return summary


class _SubseqLoadShim:
    """Adapts a ``SubseqSearchService`` to the load generator's
    ``submit_knn`` / ``submit_range`` / ``direct_query`` surface, so
    ``run_closed_loop`` and ``check_exactness`` drive the subsequence
    request family as they drive the whole-series service."""

    def __init__(self, svc):
        self.svc = svc

    def submit_knn(self, q, k, deadline_ms=None):
        return self.svc.submit_subseq_knn(q, k, deadline_ms=deadline_ms)

    def submit_range(self, q, eps, deadline_ms=None):
        return self.svc.submit_subseq_range(q, eps, deadline_ms=deadline_ms)

    def direct_query(self, kind, q, epsilon=0.0, k=0):
        if kind == "knn":
            return self.svc.direct_subseq_knn(q, k)
        return self.svc.direct_subseq_range(q, epsilon)


def serve_subseq_service(args) -> dict:
    """The subsequence service: windows-as-rows micro-batches with the
    exclusion-zone k-NN, driven by the closed-loop load generator and
    replayed request by request."""
    from ..data.timeseries import make_subseq_queries, make_wafer_like
    from ..serve import (ServeConfig, SubseqSearchService, WorkloadSpec,
                         check_exactness, make_workload, run_closed_loop)

    cfg = ServeConfig(max_batch=args.max_batch, max_queue=args.max_queue,
                      max_wait_ms=args.max_wait_ms, alphabet=args.alphabet,
                      default_deadline_ms=args.deadline_ms or None,
                      backend=args.backend)
    streams = make_wafer_like(args.streams, args.stream_len, seed=0,
                              normalize=False)
    excl = None if args.excl < 0 else args.excl
    t0 = time.perf_counter()
    service = SubseqSearchService.from_streams(
        streams, args.window, args.stride, cfg, excl=excl,
        device=args.device)
    print(f"[subseq-serve] indexed {service.sidx.n_windows} windows on "
          f"{service.backend.device} ({service.backend.backend} backend) "
          f"in {time.perf_counter() - t0:.2f}s (excl={service.excl})")
    queries = make_subseq_queries(streams, max(args.queries, 16),
                                  args.window, seed=1)
    k = args.knn or 3
    t0 = time.perf_counter()
    service.warmup(ks=(service._fetch_k(k, service.excl),))
    print(f"[subseq-serve] warmup {time.perf_counter() - t0:.1f}s")
    spec = WorkloadSpec(n_requests=args.bench_requests,
                        knn_frac=args.knn_frac, k=k, epsilon=args.epsilon,
                        deadline_ms=args.deadline_ms or None)
    workload = make_workload(queries, spec)
    shim = _SubseqLoadShim(service)
    with service:
        result = run_closed_loop(shim, workload, clients=args.clients,
                                 deadline_ms=spec.deadline_ms)
        mismatches = -1
        if args.verify_exact:
            mismatches = check_exactness(shim, workload, result)
    snap = service.stats.snapshot()
    summary = result.summary(snap)
    summary["exact_mismatches"] = mismatches
    lat = snap.get("latency_ms", {})
    print(f"[subseq-serve] {summary['served']}/{summary['requests']} "
          f"served at {summary['qps']} qps; p50/p95/p99 = {lat.get('p50')}/"
          f"{lat.get('p95')}/{lat.get('p99')} ms; "
          f"mean batch {snap.get('mean_batch_size')}")
    print(f"[serve] summary {json.dumps(summary, sort_keys=True)}")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--serve", action="store_true",
                      help="run the online query service event loop")
    mode.add_argument("--search", action="store_true",
                      help="one-shot distributed search (needs the "
                           "multi-device slice of the port)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run the "
                         "plain versions on the CPU)")
    ap.add_argument("--db-size", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--epsilon", type=float, default=2.0)
    ap.add_argument("--knn", type=int, default=0, metavar="K",
                    help="the workload's k (0: 5, or 3 with --subseq)")
    ap.add_argument("--alphabet", type=int, default=10)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda"),
                    help="'auto' runs the fused CUDA kernels on a CUDA "
                         "device and the torch engine on the CPU")
    ap.add_argument("--quantization", default="none",
                    choices=("none", "bf16", "int8"),
                    help="serve from the quantized resident tier (screen "
                         "columns on the device, raw rows on the host)")
    ap.add_argument("--verify-prefetch", action="store_true",
                    help="with --quantization: overlap the raw-tier row "
                         "fetch with the device's verify (same answers)")
    ap.add_argument("--subseq", action="store_true",
                    help="subsequence workload: index every window of a "
                         "batch of streams; k-NN answers apply the "
                         "exclusion zone")
    ap.add_argument("--streams", type=int, default=8,
                    help="with --subseq: number of streams")
    ap.add_argument("--stream-len", type=int, default=1024,
                    help="with --subseq: samples per stream")
    ap.add_argument("--window", type=int, default=128,
                    help="with --subseq: window length w")
    ap.add_argument("--stride", type=int, default=4,
                    help="with --subseq: window stride")
    ap.add_argument("--excl", type=int, default=-1,
                    help="with --subseq: exclusion-zone radius in start "
                         "positions (-1 = window // 2, 0 = off)")
    ap.add_argument("--bench-requests", type=int, default=256)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--knn-frac", type=float, default=0.5)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline (0 = none)")
    ap.add_argument("--verify-exact", action="store_true",
                    help="replay every served request through the direct "
                         "path and count mismatches")
    args = ap.parse_args(argv)
    if args.search:
        raise NotImplementedError(
            "--search (the distributed one-shot search, with or without "
            "--subseq) needs the multi-device slice of the port (ROADMAP.md "
            "queue 1 item 8)")
    if args.subseq:
        return serve_subseq_service(args)
    return serve_service(args)


if __name__ == "__main__":
    main()
