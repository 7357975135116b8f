"""The online query service event loop, driven by the closed-loop load
generator.

Counterpart of the ``--serve`` path of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --serve \\
        --db-size 1048576 --bench-requests 64 --verify-exact \\
        [--quantization int8 [--verify-prefetch]]

It builds a wafer-like database of ``--db-size`` series of length 128,
serves a mixed range / k-NN workload and prints a final machine-readable
line ``[serve] summary {...}`` with ``"exact_mismatches": 0`` when every
replayed request matched.  ``--quantization`` serves from the quantized
resident tier.  Runs on CUDA unless ``--device cpu``.
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

    t0 = time.perf_counter()
    service.warmup(ks=(args.knn,))
    print(f"[serve] warmup {time.perf_counter() - t0:.1f}s")

    spec = WorkloadSpec(n_requests=args.bench_requests,
                        knn_frac=args.knn_frac, k=args.knn,
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--serve", action="store_true", required=True,
                    help="run the online query service event loop")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run the "
                         "plain versions on the CPU)")
    ap.add_argument("--db-size", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--epsilon", type=float, default=2.0)
    ap.add_argument("--knn", type=int, default=5, metavar="K",
                    help="the workload's k")
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
    serve_service(args)


if __name__ == "__main__":
    main()
