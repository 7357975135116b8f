"""The online query service event loop, driven by the closed-loop load
generator.

Counterpart of the ``--serve`` paths of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --serve \\
        --db-size 1048576 --bench-requests 64 --verify-exact \\
        [--quantization int8 [--verify-prefetch]]
    PYTHONPATH=src python -m repro_torch.launch.serve --serve \\
        --index-dir IDX --bench-requests 64 --verify-exact
    PYTHONPATH=src python -m repro_torch.launch.serve --serve --subseq \\
        --streams 16 --stream-len 262144 --bench-requests 64 --verify-exact

The first builds a wafer-like database of ``--db-size`` series of length
128 and serves a mixed range / k-NN workload (``--quantization``: from
the quantized resident tier); the second warm-starts the same service
from a committed store or ``MutableIndex`` root of either package
(``python -m repro_torch.index.cli build --dir IDX``), with live ingest
on for a root; the third indexes every ``--window``-long
window of ``--streams`` wafer-like streams at ``--stride`` and serves
range and exclusion-zone k-NN requests on them.  Each prints a final
machine-readable line ``[serve] summary {...}`` with
``"exact_mismatches": 0`` when every replayed request matched.  Runs on
CUDA unless ``--device cpu``.  ``--search`` (the one-shot distributed
search) needs the multi-device slice of the port and raises.

Observability, off by default: ``--trace`` counts the cascade of every
batch into the stats and keeps the span ring and the cost-model
calibration; after the run ``--trace-jsonl``, ``--chrome-trace`` and
``--calibration-out`` write them, ``--request-log`` the load
generator's per-request JSONL, and ``--profile-dir`` collects one
``torch.profiler`` Chrome trace per batch.  ``--metrics PORT`` serves
the Prometheus text at ``http://127.0.0.1:PORT/metrics`` (0: a port the
OS picks) while the workload runs, and ``--metrics-hold-s`` keeps it up
after it::

    PYTHONPATH=src python -m repro_torch.launch.serve --serve --device cpu \\
        --db-size 512 --bench-requests 32 --trace --metrics 0 \\
        --trace-jsonl spans.jsonl --chrome-trace spans.json \\
        --calibration-out calibration.jsonl --request-log requests.jsonl
"""
from __future__ import annotations

import argparse
import json
import time


def _obs_start(args, service):
    """Start the metrics endpoint when ``--metrics`` is set (port 0 lets
    the OS pick); returns the server, or None, for :func:`_obs_finish`."""
    if args.metrics < 0:
        return None
    from ..obs.metrics import start_metrics_server

    server = start_metrics_server(service.metrics_text, args.metrics)
    print(f"[serve] metrics at "
          f"http://127.0.0.1:{server.server_address[1]}/metrics")
    return server


def _obs_finish(args, service, server):
    """Write the trace artifacts, keep the metrics endpoint up for
    ``--metrics-hold-s``, then shut it down."""
    tracer = service.tracer
    if tracer is not None and args.trace_jsonl:
        n = tracer.to_jsonl(args.trace_jsonl)
        print(f"[serve] wrote {n} spans -> {args.trace_jsonl}")
    if tracer is not None and args.chrome_trace:
        n = tracer.to_chrome_trace(args.chrome_trace)
        print(f"[serve] wrote {n} chrome trace events -> {args.chrome_trace}")
    calibration = service.calibration
    if calibration is not None and args.calibration_out:
        n = calibration.to_jsonl(args.calibration_out)
        print(f"[serve] wrote {n} calibration records -> "
              f"{args.calibration_out} (one DispatchRecord per line)")
    if args.profile_dir:
        print(f"[serve] torch.profiler traces, one per batch, in "
              f"{args.profile_dir}")
    if server is not None:
        if args.metrics_hold_s > 0:
            print(f"[serve] holding the metrics endpoint for "
                  f"{args.metrics_hold_s:g}s")
            time.sleep(args.metrics_hold_s)
        server.shutdown()
        server.server_close()


def serve_service(args) -> dict:
    from ..data.timeseries import make_queries, make_wafer_like
    from ..serve import (SearchService, ServeConfig, WorkloadSpec,
                         check_exactness, make_workload, run_closed_loop)

    cfg = ServeConfig(max_batch=args.max_batch, max_queue=args.max_queue,
                      max_wait_ms=args.max_wait_ms, alphabet=args.alphabet,
                      default_deadline_ms=args.deadline_ms or None,
                      backend=args.backend, quantization=args.quantization,
                      verify_prefetch=args.verify_prefetch,
                      trace=args.trace, profile_dir=args.profile_dir)
    tier = ("" if args.quantization == "none"
            else f", {args.quantization} resident tier")
    if args.index_dir:
        t0 = time.perf_counter()
        service = SearchService.from_store(args.index_dir, cfg,
                                           device=args.device)
        print(f"[serve] warm start: {service.backend.size} rows from "
              f"{args.index_dir} on {service.backend.device} "
              f"({service.backend.backend} backend{tier}) in "
              f"{time.perf_counter() - t0:.3f}s (live ingest: "
              f"{'on' if service.mutable else 'off'})")
        # The query pool only needs rows near the database's distribution;
        # the warm path does not regenerate the database.
        pool_src = make_wafer_like(max(64, 4 * args.queries),
                                   service.backend.n, seed=0)
    else:
        pool_src = make_wafer_like(args.db_size, 128, seed=0)
        t0 = time.perf_counter()
        service = SearchService.from_series(pool_src, cfg,
                                            device=args.device)
        print(f"[serve] cold build: {args.db_size} rows on "
              f"{service.backend.device} ({service.backend.backend} "
              f"backend{tier}) in {time.perf_counter() - t0:.2f}s")
    queries = make_queries(pool_src, max(args.queries, 16), seed=1)

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
        server = _obs_start(args, service)
        result = run_closed_loop(service, workload, clients=args.clients,
                                 deadline_ms=spec.deadline_ms,
                                 jsonl_path=args.request_log or None)
        mismatches = -1
        if args.verify_exact:
            mismatches = check_exactness(service, workload, result)
        _obs_finish(args, service, server)
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
                      backend=args.backend, trace=args.trace,
                      profile_dir=args.profile_dir)
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
        server = _obs_start(args, service)
        result = run_closed_loop(shim, workload, clients=args.clients,
                                 deadline_ms=spec.deadline_ms,
                                 jsonl_path=args.request_log or None)
        mismatches = -1
        if args.verify_exact:
            mismatches = check_exactness(shim, workload, result)
        _obs_finish(args, service, server)
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
    ap.add_argument("--index-dir", default="",
                    help="with --serve: warm-start from this committed "
                         "store or MutableIndex root instead of building "
                         "--db-size rows")
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
    ap.add_argument("--trace", action="store_true",
                    help="query-path tracing: cascade counters into the "
                         "stats, the span ring, per-dispatch cost-model "
                         "calibration")
    ap.add_argument("--metrics", type=int, default=-1, metavar="PORT",
                    help="serve Prometheus metrics at "
                         "http://127.0.0.1:PORT/metrics (0 = a port the OS "
                         "picks, -1 = off)")
    ap.add_argument("--metrics-hold-s", type=float, default=0.0,
                    help="with --metrics: keep the endpoint up this many "
                         "seconds after the workload, for external scrapers")
    ap.add_argument("--trace-jsonl", default="",
                    help="with --trace: write the span ring to this JSONL "
                         "file after the run")
    ap.add_argument("--chrome-trace", default="",
                    help="with --trace: write the span ring as Chrome "
                         "trace-event JSON (chrome://tracing, Perfetto)")
    ap.add_argument("--calibration-out", default="",
                    help="with --trace: write the cost-model calibration "
                         "log to this JSONL file after the run")
    ap.add_argument("--request-log", default="",
                    help="write the load generator's per-request JSONL to "
                         "this file")
    ap.add_argument("--profile-dir", default="",
                    help="wrap each batch's dispatch in a torch.profiler "
                         "capture and write its Chrome trace here (the "
                         "card's kernels and copies on a CUDA device)")
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
