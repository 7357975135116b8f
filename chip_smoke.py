#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises and exits non-zero):

1. Environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, whether nvcc and triton exist, the TF32 flags (matmul TF32
   must be off: the engine's top-k tie window is sized for f32 noise).
2. Build: compile ``kernels/csrc/fused_query.cu`` for sm_90a with nvcc.
3. Serving index: ``SearchService.from_series`` over
   ``make_wafer_like(1_048_576, 128, seed=0)`` with the default
   ``ServeConfig`` (levels (8, 16), alphabet 10, max_batch 32), then
   ``warmup``.
4. Kernels against their plain PyTorch versions on the card, on inputs
   made the way the serving path makes them (z-normalised queries, half
   k-NN rows at their seed radius, half range rows at ε = 2): at the
   serving shape Q = 32, B = 2^20, at Q = 32, B = 65,536 and at a ragged
   Q = 27, B = 50,001.  d² must agree within 1e-3 + 1e-5·d² (f32
   summation order of the matmul form), no answer may differ outside
   that band around ε², and the merged top-k must agree up to swaps of
   near-equal d².  Kernel, plain-version and yardstick times, and the
   least time the card could take (bytes over 3.35 TB/s or FLOPs over
   67 TFLOP/s f32, whichever is larger, for the data this run needs).
5. The slice: with the launch counts set to 0, 64 requests from 16
   closed-loop clients (k-NN fraction 0.5, k = 5, ε = 2); both kernels
   must have launched.  Every request is replayed alone
   (``check_exactness``: 0 mismatches), and 16 of them are checked
   against an f64 brute force on the host.
6. Where the time of one served micro-batch goes.

The line before the last is one JSON object with every kernel's figures;
the last line is ``{"ok": true, "device": {...}}``.  Longer results go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
N_SERVE = 1_048_576
SOURCE = "src/repro_torch/kernels/csrc/fused_query.cu"
REPLACES = {"fused_range": "src/repro/kernels/fused_query.py:245",
            "fused_topk": "src/repro/kernels/fused_query.py:291"}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def environment(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    env = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvcc": shutil.which("nvcc") or (
            "/usr/local/cuda/bin/nvcc"
            if pathlib.Path("/usr/local/cuda/bin/nvcc").exists() else None),
        "triton": importlib.util.find_spec("triton") is not None,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
    log(smi)
    log(f"[env] torch {env['torch']} cuda {env['cuda']} python "
        f"{env['python']}; nvcc {env['nvcc']}; triton "
        f"{'present' if env['triton'] else 'absent'}; TF32 matmul "
        f"{env['tf32_matmul']} cudnn {env['tf32_cudnn']}")
    check(not env["tf32_matmul"], "TF32 matmul must stay off")
    return env


def path_inputs(torch, engine, index, queries: np.ndarray, k: int = 8):
    """The fused kernels' inputs as the serving path makes them for one
    micro-batch: z-normalised queries, alternate k-NN rows at their
    slacked seed radius and range rows at ε = 2."""
    dev = index.device
    Q = queries.shape[0]
    qr = engine.represent_queries(
        torch.as_tensor(queries, dtype=torch.float32, device=dev),
        index.levels, index.alphabet)
    knn = (torch.arange(Q, device=dev) % 2 == 0).reshape(Q, 1)
    seed = engine._seed_eps(index, qr, k, None)
    eps = torch.where(knn, engine._slacked(seed),
                      torch.full_like(seed, 2.0))
    panels = engine._query_panels(qr, index.alphabet)
    args = engine._fused_inputs(index, qr, index.residuals, panels, eps)
    k_sel = k + engine._TOPK_GUARD
    tq, tb = engine._fused_blocks(index, Q, k_sel)
    rq, rb = engine._fused_blocks(index, Q, 0)
    return qr, args, dict(block_q=rq, block_b=rb), \
        dict(block_q=tq, block_b=tb, k=min(k_sel, tb))


def alive_by_level(torch, ref, args) -> list:
    """Surviving (query, row) pairs before each level and after the last
    (the work the cascade and the verify need on these inputs)."""
    eps = args["eps"].reshape(-1, 1)
    alive = torch.ones((args["q"].shape[0], args["series"].shape[0]),
                       dtype=torch.bool, device=eps.device)
    counts = [int(alive.sum())]
    for li, N in enumerate(args["levels"]):
        one = {k: (v[li:li + 1] if k in ("words", "residuals", "q_panels",
                                          "q_residuals") else v)
               for k, v in args.items()}
        alive &= ref.cascade_alive_ref(one["words"], one["residuals"],
                                       one["q_panels"], one["q_residuals"],
                                       args["eps"], (N,), args["n"])
        counts.append(int(alive.sum()))
    return counts


def bound_ms(torch, ref, args, outputs, topk: bool) -> tuple:
    """Least time for the work: every input read once and every output
    written once over the memory rate, or the operations these inputs
    need over the f32 rate, whichever is larger."""
    tensors = [args["series"], args["norms_sq"], args["q"], args["eps"],
               *args["words"], *args["residuals"], *args["q_panels"],
               *args["q_residuals"], *outputs]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    counts = alive_by_level(torch, ref, args)
    ops = 0.0
    for li, N in enumerate(args["levels"]):
        ops += counts[li] * (3 + 2 * N + 2)         # C9, C10 gather-FMA
    n = args["n"]
    ops += counts[-1] * (2 * n + 4)                 # verify on survivors
    if topk:
        ops += counts[-1]                           # selection compares
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes, ops, counts


def compare_kernels(torch, engine, fq, ref, index, queries, label,
                    timing: bool) -> dict:
    qr, args, rtile, ttile = path_inputs(torch, engine, index, queries)
    ref_args = {k: v for k, v in args.items() if k != "alphabet"}
    Q, B = args["q"].shape[0], args["series"].shape[0]
    eps2 = (args["eps"] * args["eps"]).cpu().numpy()[:, None]
    out = {"Q": Q, "B": B, "range_tile": rtile, "topk_tile": ttile}

    ga, gd = fq.fused_range(**args, **rtile)
    torch.cuda.synchronize()
    wa, wd = ref.fused_range_ref(**ref_args)
    ga, gd, wa, wd = (t.cpu().numpy() for t in (ga, gd, wa, wd))
    d_ref = np.where(np.isfinite(wd), wd, gd)
    in_band = np.abs(d_ref - eps2) <= band(eps2)
    differ = ga != wa
    both = ga & wa
    err = float(np.abs(gd[both] - wd[both]).max()) if both.any() else 0.0
    out["range"] = {
        "answers": int(wa.sum()), "max_abs_err": err,
        "mismatch_outside_band": int((differ & ~in_band).sum()),
        "mismatch_in_band": int((differ & in_band).sum()),
        "d2_outside_band": int((np.abs(gd[both] - wd[both])
                                > band(wd[both])).sum()),
        "inf_off_answers": bool(np.all(np.isinf(gd[~ga])))}
    check(out["range"]["mismatch_outside_band"] == 0
          and out["range"]["d2_outside_band"] == 0
          and out["range"]["inf_off_answers"],
          f"fused_range disagrees with its plain version at {label}: "
          f"{out['range']}")

    k = ttile["k"]
    gi, gdd = fq.fused_topk(**args, **ttile)
    torch.cuda.synchronize()
    wi, wdd = ref.fused_topk_ref(**ref_args, k=k, block_b=ttile["block_b"])
    mgi, mgd = (t.cpu().numpy() for t in fq.merge_topk_partials(gi, gdd, 8))
    mwi, mwd = (t.cpu().numpy() for t in fq.merge_topk_partials(wi, wdd, 8))
    gi, gdd, wi, wdd = (t.cpu().numpy() for t in (gi, gdd, wi, wdd))
    same = gi == wi
    fin = same & np.isfinite(wdd)
    err_k = float(np.abs(gdd[fin] - wdd[fin]).max()) if fin.any() else 0.0
    swaps = mgi != mwi
    with np.errstate(invalid="ignore"):          # inf − inf on empty slots
        near = np.abs(mgd - mwd) <= band(mwd)
    fin_m = np.isfinite(mwd)
    d2_ok = bool(np.array_equal(np.isfinite(mgd), fin_m)
                 and np.all(np.abs(mgd[fin_m] - mwd[fin_m])
                            <= band(mwd[fin_m])))
    out["topk"] = {
        "k_sel": k, "partial_slots_equal": float(same.mean()),
        "max_abs_err": err_k, "merged_equal": bool(np.array_equal(mgi, mwi)),
        "merged_swaps_near_tie": int((swaps & near).sum()),
        "merged_mismatch": int((swaps & ~near).sum()),
        "merged_d2_within_band": d2_ok}
    check(out["topk"]["merged_mismatch"] == 0 and d2_ok,
          f"fused_topk disagrees with its plain version at {label}: "
          f"{out['topk']}")
    log(f"[kernels] {label}: Q={Q} B={B} range answers="
        f"{out['range']['answers']} max|Δd²|={err:.3g} outside-band="
        f"{out['range']['mismatch_outside_band']} in-band="
        f"{out['range']['mismatch_in_band']}; top-k merged equal="
        f"{out['topk']['merged_equal']} near-tie swaps="
        f"{out['topk']['merged_swaps_near_tie']} max|Δd²|={err_k:.3g}")

    if timing:
        lib_ms = cuda_ms(torch, lambda: torch.matmul(args["q"],
                                                     args["series"].T), 20)
        for name, fn, plain, outputs, topk in (
                ("fused_range", lambda: fq.fused_range(**args, **rtile),
                 lambda: ref.fused_range_ref(**ref_args),
                 fq.fused_range(**args, **rtile), False),
                ("fused_topk", lambda: fq.fused_topk(**args, **ttile),
                 lambda: ref.fused_topk_ref(**ref_args, k=k,
                                            block_b=ttile["block_b"]),
                 fq.fused_topk(**args, **ttile), True)):
            b_ms, b_by, nbytes, ops, counts = bound_ms(torch, ref, args,
                                                       outputs, topk)
            out[name] = {"ms": cuda_ms(torch, fn, 20),
                         "plain_ms": cuda_ms(torch, plain, 3),
                         "library_ms": lib_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "ops": ops,
                         "alive_by_level": counts}
            log(f"[kernels] {name} at {label}: {out[name]['ms']:.4f} ms "
                f"(plain {out[name]['plain_ms']:.3f} ms, torch.matmul "
                f"of the verify {lib_ms:.4f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP)")
    return out


def exactness_details(service, workload, result, limit: int = 8) -> list:
    """For a failed replay check: how the first mismatching requests
    differ between their batch and their replay."""
    out = []
    for (kind, q, eps, k), req in zip(workload, result.requests):
        ids, dist = service.direct_query(kind, q, epsilon=eps, k=k)
        if np.array_equal(ids, req.ids) and np.allclose(
                dist, req.distances, rtol=1e-6, atol=1e-9):
            continue
        same = ids.size == req.ids.size and np.array_equal(ids, req.ids)
        out.append({"kind": kind, "ids_equal": bool(same),
                    "n_batch": int(req.ids.size), "n_replay": int(ids.size),
                    "sym_diff": int(np.setxor1d(ids, req.ids).size),
                    "max_rel_dist": float(np.max(np.abs(dist - req.distances)
                                                 / np.maximum(dist, 1e-30)))
                    if same else None})
        if len(out) >= limit:
            break
    return out


def brute_force_check(service, workload, result, n_check: int) -> dict:
    """f64 brute force on the host for ``n_check`` served requests (half
    of each kind).  Range id sets and k-NN ids must be equal; a row whose
    f64 d² lies within the f32 band of ε² (range) or of the k-th distance
    (k-NN) may differ and is counted instead."""
    from repro_torch.core.paa import znormalize_np
    series = service.backend.index.series.cpu().numpy().astype(np.float64)
    picked = {"range": [], "knn": []}
    for i, (kind, *_rest) in enumerate(workload):
        if len(picked[kind]) < n_check // 2 and \
                result.requests[i].status == "ok":
            picked[kind].append(i)
    stats = {"checked": 0, "exact_equal": 0, "boundary": 0, "wrong": 0,
             "boundary_rows": []}
    for i in picked["range"] + picked["knn"]:
        kind, q, eps, k = workload[i]
        req = result.requests[i]
        qz = znormalize_np(np.asarray(q, np.float32).astype(np.float64))
        d2 = np.empty(series.shape[0])
        for s in range(0, series.shape[0], 1 << 16):
            diff = series[s:s + (1 << 16)] - qz
            d2[s:s + (1 << 16)] = np.einsum("ij,ij->i", diff, diff)
        if kind == "range":
            sym = np.setxor1d(np.flatnonzero(d2 <= eps * eps), req.ids)
            gap = np.abs(d2[sym] - eps * eps)
            ok = np.all(gap <= band(eps * eps))
        else:
            want = np.lexsort((np.arange(d2.size), d2))[:k]
            sym = np.flatnonzero(want != req.ids)
            gap = np.abs(d2[want[sym]] - d2[req.ids[sym]])
            ok = req.ids.size == k and np.all(gap <= band(d2[want[sym]]))
        if sym.size:
            stats["boundary_rows"].append(
                {"kind": kind, "rows": int(sym.size),
                 "max_d2_gap": float(gap.max())})
        stats["checked"] += 1
        if sym.size == 0:
            stats["exact_equal"] += 1
        elif ok:
            stats["boundary"] += 1
        else:
            stats["wrong"] += 1
    return stats


def breakdown(torch, engine, fq, service, queries) -> dict:
    """Where one served micro-batch (Q = 32, k bucket 8, half k-NN) spends
    its time: the steps of ``engine.mixed_query_fused`` timed with CUDA
    events, then the device-to-host copy and the host ``_finish``."""
    from repro_torch.serve.batcher import KIND_KNN, KIND_RANGE, Request
    index, cfg = service.backend.index, service.cfg
    dev = index.device
    Q, k = 32, 8
    qs = queries[:Q].astype(np.float32)
    is_knn = np.arange(Q) % 2 == 0
    eps_np = np.where(is_knn, 0.0, 2.0).astype(np.float32)

    def run(ev):
        ev[0].record()
        qr = engine.represent_queries(
            torch.as_tensor(qs, device=dev), index.levels, index.alphabet,
            normalize=cfg.normalize_queries)
        knn_col = torch.as_tensor(is_knn, device=dev).reshape(Q, 1)
        eps_req = torch.as_tensor(eps_np, device=dev).reshape(Q, 1)
        panels = engine._query_panels(qr, index.alphabet)
        eps = torch.where(knn_col, engine._seed_eps(index, qr, k, None),
                          eps_req)
        tq, tb = engine._fused_blocks(index, Q, k + engine._TOPK_GUARD)
        ev[1].record()
        idxp, _ = fq.fused_topk(
            **engine._fused_inputs(index, qr, index.residuals, panels,
                                   engine._cascade_eps(eps, knn_col)),
            k=min(k + engine._TOPK_GUARD, tb), block_q=tq, block_b=tb)
        ev[2].record()
        d2v = engine._reverify_rows(index, qr, idxp)
        tight = torch.minimum(eps, torch.sqrt(engine._kth_smallest(d2v, k)))
        eps = torch.where(knn_col, tight, eps)
        ev[3].record()
        rq, rb = engine._fused_blocks(index, Q, 0)
        ans, d2 = fq.fused_range(
            **engine._fused_inputs(index, qr, index.residuals, panels,
                                   engine._cascade_eps(eps, knn_col)),
            block_q=rq, block_b=rb)
        idx = torch.arange(index.size, dtype=torch.int32,
                           device=dev)[None, :].expand(Q, index.size)
        ev[4].record()
        return idx, ans, d2, idxp

    evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    run(evs)
    torch.cuda.synchronize()
    reps, acc = 5, np.zeros(4)
    for _ in range(reps):
        idx, ans, d2, idxp = run(evs)
        torch.cuda.synchronize()
        acc += [evs[j].elapsed_time(evs[j + 1]) for j in range(4)]
    acc /= reps
    t0 = time.perf_counter()
    host = [t.cpu().numpy() for t in (idx, ans, d2)]
    t_copy = (time.perf_counter() - t0) * 1e3
    reqs = [Request(kind=KIND_KNN if is_knn[i] else KIND_RANGE, query=qs[i],
                    epsilon=float(eps_np[i]), k=5) for i in range(Q)]
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        service._finish(req, host[0][i], host[1][i], host[2][i])
    t_finish = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    service.backend.dispatch(qs, eps_np, is_knn, k)
    t_dispatch = (time.perf_counter() - t0) * 1e3
    n = index.n
    out = {
        "queries_and_seed_ms": acc[0], "fused_topk_ms": acc[1],
        "reverify_gather_ms": acc[2], "fused_range_ms": acc[3],
        "d2h_copy_ms": t_copy, "host_finish_ms": t_finish,
        "dispatch_total_ms": t_dispatch,
        "d2h_bytes": int(sum(a.nbytes for a in host)),
        "reverify_gather_bytes": int(idxp.numel() * n * 4),
        "topk_partials_per_query": int(idxp.shape[1]),
    }
    log("[breakdown] " + json.dumps(out, sort_keys=True))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import engine
    from repro_torch.data.timeseries import make_queries, make_wafer_like
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_query as fq
    from repro_torch.kernels import ref
    from repro_torch.serve import (SearchService, ServeConfig, WorkloadSpec,
                                   check_exactness, make_workload,
                                   run_closed_loop)

    report = {"env": environment(torch)}

    t0 = time.perf_counter()
    build.build(["fused_query"])
    info = build.BUILD_INFO["fused_query"]
    report["build"] = {"seconds": time.perf_counter() - t0,
                       "nvcc_seconds": info["seconds"], "log": info["log"]}
    log(f"[build] fused_query.cu in {report['build']['seconds']:.1f}s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("[build] " + line.strip())

    t0 = time.perf_counter()
    db = make_wafer_like(N_SERVE, 128, seed=0)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = SearchService.from_series(db, ServeConfig())
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check(service.backend.backend == "cuda", "serving must use the kernels")
    t0 = time.perf_counter()
    service.warmup()
    torch.cuda.synchronize()
    report["index"] = {"rows": N_SERVE, "data_s": t_data,
                       "build_s": t_build,
                       "warmup_s": time.perf_counter() - t0,
                       "memory_allocated": torch.cuda.memory_allocated()}
    log(f"[index] {N_SERVE} rows: data {t_data:.1f}s, device build "
        f"{t_build:.2f}s, warmup {report['index']['warmup_s']:.1f}s")

    queries = make_queries(db, 64, seed=1)
    small_db = make_wafer_like(65_536, 128, seed=1)
    small = engine.build_device_index(small_db, (8, 16), 10)
    ragged_db = make_wafer_like(50_001, 128, seed=2)
    ragged = engine.build_device_index(ragged_db, (8, 16), 10)
    report["kernels"] = {
        "serving": compare_kernels(torch, engine, fq, ref,
                                   service.backend.index, queries[:32],
                                   "Q=32 B=1048576", timing=True),
        "b65536": compare_kernels(torch, engine, fq, ref, small,
                                  make_queries(small_db, 32, seed=3),
                                  "Q=32 B=65536", timing=True),
        "ragged": compare_kernels(torch, engine, fq, ref, ragged,
                                  make_queries(ragged_db, 27, seed=4),
                                  "Q=27 B=50001", timing=False),
    }
    del small, ragged

    spec = WorkloadSpec(n_requests=64, knn_frac=0.5, k=5, epsilon=2.0)
    workload = make_workload(queries, spec)
    fq.reset_launch_counts()
    with service:
        result = run_closed_loop(service, workload, clients=16)
        launches = {"fused_range": fq.fused_range.launches,
                    "fused_topk": fq.fused_topk.launches}
    d2h_batch = service.backend.last_d2h_bytes     # the last served batch
    snap = service.stats.snapshot()
    check(result.served == len(workload),
          f"served {result.served} of {len(workload)}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path did not launch: {launches}")
    t0 = time.perf_counter()
    mismatches = check_exactness(service, workload, result)
    t_replay = time.perf_counter() - t0
    if mismatches:
        log("[serve] exactness mismatches: " + json.dumps(
            exactness_details(service, workload, result)))
    check(mismatches == 0, f"{mismatches} exactness mismatches")
    bf = brute_force_check(service, workload, result, 16)
    check(bf["wrong"] == 0 and bf["checked"] >= 8,
          f"brute-force disagreement: {bf}")
    lat = snap["latency_ms"]
    report["serve"] = {"summary": result.summary(snap), "launches": launches,
                       "exact_mismatches": mismatches, "replay_s": t_replay,
                       "brute_force": bf,
                       "d2h_bytes_last_batch": d2h_batch}
    log(f"[serve] {result.served}/{len(workload)} served at "
        f"{result.qps:.2f} qps; p50 {lat['p50']} ms p99 {lat['p99']} ms; "
        f"mean batch {snap['mean_batch_size']} over {snap['batches']} "
        f"batches; launches {launches}; exactness mismatches {mismatches} "
        f"({t_replay:.1f}s); brute force {bf}; device-to-host {d2h_batch} "
        f"bytes in the last batch")

    report["breakdown"] = breakdown(torch, engine, fq, service, queries)

    kernels = []
    for name in ("fused_range", "fused_topk"):
        main = report["kernels"]["serving"][name]
        key = "range" if name == "fused_range" else "topk"
        err = max(report["kernels"][s][key]["max_abs_err"]
                  for s in report["kernels"])
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"],
                        "library_ms": main["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(report, indent=1, sort_keys=True, default=str))
    print(report["env"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
