"""The LM decode loop, the online query service event loop, driven by
the closed-loop load generator, and the one-shot distributed search.

Counterpart of ``repro/launch/serve.py``.  With neither ``--serve`` nor
``--search`` it runs the LM decode loop, as the reference does: a
randomly initialised ``--arch`` (its smoke config unless ``--no-smoke``)
prefills ``--batch`` random prompts of ``--prompt-len`` tokens and
decodes ``--gen`` tokens greedily, and prints three ``[serve]`` lines::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --no-smoke --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch granite-3-2b --gen 4

The search modes::

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
CUDA unless ``--device cpu``.  ``--failover-shards P`` serves through P
independently queried shards with timeout / retry failover.  A SIGTERM
drains the service (accepted requests finish, new ones are shed).

``--search`` answers one batch of range (or, with ``--knn K``, k-NN)
queries over the database sharded on a mesh of ``--shards`` shards (one
per card by default, placed round robin over the cards; on
``--device cpu`` every shard on the CPU), with ``--subseq`` over the
stream-sharded windows; ``--index-dir`` warm-starts it from a sharded
store, or stores the cold build there for the next start::

    PYTHONPATH=src python -m repro_torch.launch.serve --search --shards 4 \\
        --db-size 4096 --index-dir SHIDX [--knn 5]
    PYTHONPATH=src python -m repro_torch.launch.serve --search --subseq \\
        --shards 4 --streams 8 --stream-len 1024 [--knn 3]

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
import os
import threading
import time

import numpy as np


def lm_inputs(cfg, batch: int, prompt_len: int, device, seed: int = 0):
    """Random prompts (B, prompt_len) and, for the encdec and vlm kinds,
    stub frame or patch embeddings (B, Sm, d), from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    memory = None
    if cfg.kind in ("encdec", "vlm"):
        n = cfg.enc_seq if cfg.kind == "encdec" else cfg.img_tokens
        memory = torch.randn((batch, n, cfg.d_model), generator=gen,
                             device=device).to(cfg.torch_dtype)
    return tokens, memory


def generate(model, tokens, memory, gen: int) -> dict:
    """Greedy decoding: ``prefill`` over the prompt, then ``gen``
    ``decode_step``s.  Returns every step's logits (B, gen + 1, V) — the
    prefill's first — the generated tokens (B, gen) and the times (the
    host clock around work that ends in a synchronise on a card)."""
    import torch

    from ..models.transformer import decode_step, prefill

    def sync():
        if tokens.device.type == "cuda":
            torch.cuda.synchronize(tokens.device)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(model, tokens, memory=memory,
                                max_seq=tokens.shape[1] + gen)
        sync()
        t_prefill = time.perf_counter() - t0
        steps, out = [logits], []
        nxt = torch.argmax(logits, dim=-1)[:, None]
        t0 = time.perf_counter()
        for j in range(gen):
            out.append(nxt)
            logits, cache = decode_step(model, cache, nxt)
            steps.append(logits)
            nxt = torch.argmax(logits, dim=-1)[:, None]
        sync()
        t_decode = (time.perf_counter() - t0) / max(gen, 1)
    return {"logits": torch.stack(steps, dim=1),
            "generated": torch.cat(out, dim=1) if out else tokens[:, :0],
            "prefill_s": t_prefill, "decode_s": t_decode}


def serve_lm(args) -> dict:
    """The LM decode loop (the reference's default mode): init, prefill,
    greedy decode, three ``[serve]`` lines.  Runs on the card unless
    ``--device cpu``; raises when there is none."""
    import torch

    from .. import configs
    from ..models.transformer import init_params

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the LM on the CPU")
    device = torch.device(args.device or "cuda")
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = init_params(cfg, device, seed=args.seed)
    B = args.batch
    tokens, memory = lm_inputs(cfg, B, args.prompt_len, device, args.seed)
    res = generate(model, tokens, memory, args.gen)
    t_decode = res["decode_s"]
    print(f"[serve] arch={cfg.name} batch={B} prompt={args.prompt_len}")
    print(f"[serve] prefill {res['prefill_s'] * 1e3:.1f} ms; "
          f"decode {t_decode * 1e3:.1f} ms/token "
          f"({B / t_decode:.1f} tok/s aggregate)")
    print(f"[serve] sample generation (first row): "
          f"{res['generated'][0][:16].tolist()}")
    res.update(cfg=cfg, model=model, tokens=tokens, memory=memory)
    return res


def _mesh(args):
    from ..core.dist_search import make_data_mesh

    return make_data_mesh(args.shards or None, device=args.device)


def serve_subseq_search(args):
    """One-shot stream-sharded subsequence search: index every window of
    a stream batch across the mesh, then answer windowed range or
    exclusion-zone k-NN queries (kernels 3-4 per shard on a card)."""
    from ..core.dist_search import (distributed_subseq_index,
                                    distributed_subseq_knn_query,
                                    distributed_subseq_range_query)
    from ..core.fastsax import FastSAXConfig
    from ..core.options import SearchOptions
    from ..core.subseq import build_subseq_index
    from ..data.timeseries import make_subseq_queries, make_wafer_like

    mesh = _mesh(args)
    streams = make_wafer_like(args.streams, args.stream_len, seed=0,
                              normalize=False)
    t0 = time.perf_counter()
    hidx = build_subseq_index(
        streams, FastSAXConfig(n_segments=(8, 16), alphabet=args.alphabet),
        args.window, args.stride)
    dsx = distributed_subseq_index(hidx, mesh)
    print(f"[subseq] indexed {dsx.n_valid} windows "
          f"({args.streams}x{args.stream_len}, w={args.window}, "
          f"s={args.stride}) on {mesh.size} shard(s) "
          f"in {time.perf_counter() - t0:.2f}s")
    queries = make_subseq_queries(streams, args.queries, args.window, seed=1)
    excl = None if args.excl < 0 else args.excl
    opts = SearchOptions(backend=args.backend)
    if args.knn:
        t0 = time.perf_counter()
        sel_idx, sel_d2, exact = distributed_subseq_knn_query(
            dsx, queries, args.knn, mesh, excl=excl, options=opts)
        dt = time.perf_counter() - t0
        W_s = dsx.windows_per_stream
        for qi in range(min(4, args.queries)):
            pairs = [f"s{w // W_s}@{(w % W_s) * dsx.stride}:{d:.3f}"
                     for w, d in zip(sel_idx[qi], np.sqrt(sel_d2[qi]))
                     if w >= 0]
            print(f"[subseq-knn] q{qi}: {' '.join(pairs)}")
        print(f"[subseq-knn] k={args.knn} "
              f"excl={dsx.window // 2 if excl is None else excl}: "
              f"{args.queries} queries in {dt * 1e3:.1f} ms; "
              f"exact={bool(exact.all())}")
        return {"exact": bool(exact.all()), "sel_idx": sel_idx}
    t0 = time.perf_counter()
    gidx, ans, d2, overflow = distributed_subseq_range_query(
        dsx, queries, args.epsilon, mesh, options=opts)
    ans, gidx = ans.cpu().numpy(), gidx.cpu().numpy()
    dt = time.perf_counter() - t0
    for qi in range(min(4, args.queries)):
        hits = sorted(gidx[qi][ans[qi]].tolist())
        print(f"[subseq] q{qi}: {ans[qi].sum()} windows within "
              f"eps={args.epsilon} (first: {hits[:6]})")
    print(f"[subseq] {args.queries} queries in {dt * 1e3:.1f} ms "
          f"({args.queries / dt:.0f} qps); "
          f"overflow={bool(overflow.any())}")
    return {"overflow": bool(overflow.any()),
            "answers": [sorted(gidx[i][ans[i]].tolist())
                        for i in range(ans.shape[0])]}


def serve_search(args):
    """One-shot range / k-NN search over a sharded database.  With
    ``--index-dir`` a matching sharded store warm-starts it, and a cold
    build is stored there for the next start — into an empty or absent
    directory only, never over an existing store that failed to load."""
    from ..core.dist_search import (distributed_build, distributed_knn_query,
                                    distributed_range_query_auto,
                                    load_sharded, pad_database,
                                    store_sharded)
    from ..core.options import SearchOptions
    from ..data.timeseries import make_queries, make_wafer_like

    mesh = _mesh(args)
    index = None
    store_after_build = False
    if args.index_dir:
        try:
            t0 = time.perf_counter()
            index, n_valid = load_sharded(args.index_dir, mesh)
            print(f"[search] warm start: {n_valid} series from "
                  f"{args.index_dir} on {mesh.size} shard(s) "
                  f"in {time.perf_counter() - t0:.3f}s")
        except (FileNotFoundError, ValueError, IOError) as e:
            print(f"[search] cold start ({e})")
            index = None
            store_after_build = (not os.path.exists(args.index_dir)
                                 or (os.path.isdir(args.index_dir)
                                     and not os.listdir(args.index_dir)))
            if not store_after_build:
                print(f"[search] NOT overwriting existing {args.index_dir}; "
                      f"remove it or pick a fresh --index-dir to persist")
    if index is None:
        db = make_wafer_like(args.db_size, 128, seed=0)
        padded, n_valid = pad_database(db, mesh.size)
        t0 = time.perf_counter()
        index = distributed_build(padded, (8, 16), args.alphabet, mesh,
                                  n_valid=n_valid)
        print(f"[search] indexed {n_valid} series on {mesh.size} shard(s) "
              f"in {time.perf_counter() - t0:.2f}s")
        if store_after_build:
            t0 = time.perf_counter()
            store_sharded(index, args.index_dir, n_valid=n_valid)
            print(f"[search] stored sharded index -> {args.index_dir} "
                  f"in {time.perf_counter() - t0:.2f}s")
    else:
        # The warm path needs only query-shaped rows, not the database.
        db = make_wafer_like(max(4 * args.queries, 64), 128, seed=0)
    queries = make_queries(db, args.queries, seed=1)
    if args.knn:
        k = args.knn
        t0 = time.perf_counter()
        nn_idx, nn_d2, exact = distributed_knn_query(
            index, queries, k, mesh, n_valid=n_valid,
            options=SearchOptions(backend=args.backend,
                                  normalize_queries=False))
        nn_idx = nn_idx.cpu().numpy()[:, :k]
        nn_d = np.sqrt(nn_d2.cpu().numpy())[:, :k]
        dt = time.perf_counter() - t0
        for qi in range(min(4, args.queries)):
            pairs = [f"{i}:{d:.3f}" for i, d in zip(nn_idx[qi], nn_d[qi])]
            print(f"[knn] q{qi}: {' '.join(pairs[:6])}")
        print(f"[knn] k={k}: {args.queries} queries in {dt * 1e3:.1f} ms "
              f"({args.queries / dt:.0f} qps); "
              f"exact={bool(exact.all())}")
        return {"exact": bool(exact.all()), "nn_idx": nn_idx}
    t0 = time.perf_counter()
    # Auto-escalating capacity: a shard whose survivors overflow its
    # buffer is re-queried at 4x capacity (up to the shard size).
    gidx, ans, d2, overflow = distributed_range_query_auto(
        index, queries, args.epsilon, mesh,
        options=SearchOptions(backend=args.backend, capacity=128,
                              normalize_queries=False))
    ans, gidx = ans.cpu().numpy(), gidx.cpu().numpy()
    dt = time.perf_counter() - t0
    for qi in range(min(4, args.queries)):
        hits = gidx[qi][ans[qi]]
        print(f"[search] q{qi}: {ans[qi].sum()} answers "
              f"(first: {sorted(hits.tolist())[:6]})")
    print(f"[search] {args.queries} queries in {dt * 1e3:.1f} ms "
          f"({args.queries / dt:.0f} qps); overflow={bool(overflow.any())}")
    return {"overflow": bool(overflow.any()),
            "answers": [sorted(gidx[i][ans[i]].tolist())
                        for i in range(ans.shape[0])]}


def _obs_start(args, service):
    """Start the metrics endpoint when ``--metrics`` is set (port 0 lets
    the OS pick), readiness at ``/healthz`` from ``service.health``;
    returns the server, or None, for :func:`_obs_finish`."""
    if args.metrics < 0:
        return None
    from ..obs.metrics import start_metrics_server

    server = start_metrics_server(service.metrics_text, args.metrics,
                                  health_fn=service.health)
    print(f"[serve] metrics at "
          f"http://127.0.0.1:{server.server_address[1]}/metrics "
          f"(readiness at /healthz)")
    return server


def _drain_on_preempt(ph, service):
    """Arm a watcher that drains the service gracefully when the
    ``runtime.fault_tolerance.PreemptionHandler`` catches SIGTERM: new
    submits are shed, accepted requests finish, then the dispatcher
    stops — a preemption never drops an accepted request."""

    def watch():
        ph.requested.wait()
        print("[serve] SIGTERM: draining (new submits shed)")
        ok = service.drain(timeout_s=30.0)
        print(f"[serve] drain {'complete' if ok else 'TIMED OUT'}")

    t = threading.Thread(target=watch, name="repro-torch-drain-watch",
                         daemon=True)
    t.start()
    return t


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
    from ..runtime.fault_tolerance import PreemptionHandler
    from ..serve import (SearchService, ServeConfig, WorkloadSpec,
                         check_exactness, make_workload, run_closed_loop)

    cfg = ServeConfig(max_batch=args.max_batch, max_queue=args.max_queue,
                      max_wait_ms=args.max_wait_ms, alphabet=args.alphabet,
                      default_deadline_ms=args.deadline_ms or None,
                      backend=args.backend, quantization=args.quantization,
                      verify_prefetch=args.verify_prefetch,
                      trace=args.trace, profile_dir=args.profile_dir,
                      failover_shards=args.failover_shards)
    tier = ("" if args.quantization == "none"
            else f", {args.quantization} resident tier")
    if args.failover_shards:
        tier += f", {args.failover_shards} failover shards"
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
    with PreemptionHandler() as ph, service:
        _drain_on_preempt(ph, service)
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
    from ..runtime.fault_tolerance import PreemptionHandler
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
    with PreemptionHandler() as ph, service:
        _drain_on_preempt(ph, service)
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
    from .. import configs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--serve", action="store_true",
                      help="run the online query service event loop")
    mode.add_argument("--search", action="store_true",
                      help="one-shot range / k-NN search over the "
                           "database sharded on a mesh (--shards)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run the "
                         "plain versions on the CPU)")
    # The LM decode loop (neither --serve nor --search)
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="use the smoke-sized arch config (--no-smoke for "
                         "the full published config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--db-size", type=int, default=4096)
    ap.add_argument("--index-dir", default="",
                    help="--serve: warm-start from this committed store, "
                         "MutableIndex root or sharded store instead of "
                         "building --db-size rows; --search: a sharded "
                         "store, written after a cold build")
    ap.add_argument("--shards", type=int, default=0,
                    help="with --search: shards of the mesh (0 = one per "
                         "card; on --device cpu, 1)")
    ap.add_argument("--failover-shards", type=int, default=0, metavar="P",
                    help="with --serve: split the database over P "
                         "independently queried shards with timeout / "
                         "retry failover; a lost shard degrades answers "
                         "to certified-partial (exact=False + coverage) "
                         "instead of an outage (0 = off; a warm start "
                         "from a sharded store uses its shard count)")
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
        return serve_subseq_search(args) if args.subseq else \
            serve_search(args)
    if not args.serve:
        return serve_lm(args)
    if args.subseq:
        return serve_subseq_service(args)
    return serve_service(args)


if __name__ == "__main__":
    main()
