"""One run of one cell: set-up, the timed window, the check, the result.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  The cell is found by name in ``BENCHMARK.json``; its
traffic in ``workloads/<cell>.json``, its configuration in
``configs/<config>.json``, each metric's reader in
``metrics/<metric>.py``.  With ``--trace 0`` the run reports the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones (the same
untraced service, its device passes and replies timed by the harness,
``torch.profiler`` over the window, the cascade counted after it).  The last line of standard
output is one JSON object; the numbers compared for ``correct`` are the
last lines of standard error.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

from . import arith, datagen, tracelib
from .client import OK, run_closed_loop, run_open_loop

ROOT = pathlib.Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LOOPS = ("closed", "open")
# Requests of the window whose cascade a traced run counts after it.
CASCADE_REQUESTS = 128


class RunError(Exception):
    """A run that cannot give a result (exit code 2, no result line)."""


# --- finding a cell ---------------------------------------------------------

def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(repo: pathlib.Path = REPO) -> dict:
    path = repo / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(f"no {path}")
    return load_json(path)


def resolve(name: str, bench: dict, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name``: its manifest entry, traffic, configuration and
    the metric entries it reports, split by ``--trace``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    traffic = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{entry['config']}.json")
    if traffic.get("config") != entry["config"]:
        raise RunError(f"workloads/{name}.json names config "
                       f"{traffic.get('config')!r}, BENCHMARK.json "
                       f"{entry['config']!r}")

    if traffic.get("loop") not in LOOPS:
        raise RunError(f"workloads/{name}.json: loop "
                       f"{traffic.get('loop')!r} is none of {LOOPS}")

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return {"entry": entry, "traffic": traffic, "config": config,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``, or, where that file
    is missing, of the file of the name before its first dot: one reader
    serves ``dispatch_ms.sat`` and ``dispatch_ms.light``."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        path = root / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- inputs -----------------------------------------------------------------

def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """The database (host array the service's constructor takes), the
    request stream's queries and mix, all from ``seed``."""
    gen = datagen.generator(seed, device)
    R = int(traffic["requests"])
    noise = float(traffic.get("query_noise", 0.05))
    if config["generator"] != "random_walks":
        raise RunError(f"unknown generator {config['generator']!r}")
    if config["kind"] == "whole_series":
        x = datagen.random_walks(int(config["rows"]), int(config["length"]),
                                 gen)
        q = datagen.whole_series_queries(x, R, gen, noise)
    else:
        x = datagen.random_walks(int(config["streams"]),
                                 int(config["stream_len"]), gen)
        q = datagen.subseq_queries(x, R, int(config["window"]), gen, noise)
    # The mix's order is the traffic's own (``order_seed``): every seed
    # sends the same kinds in the same order, with its own data and
    # queries.
    is_knn, eps = datagen.request_mix(
        R, float(traffic["knn_frac"]), traffic.get("epsilons", ()),
        datagen.generator(int(traffic.get("order_seed", 0)), device))
    data, queries = x.cpu().numpy(), q.cpu().numpy()
    del x, q
    return {"data": data, "queries": queries, "is_knn": is_knn, "eps": eps}


def in_flight(traffic: dict) -> int:
    """The most requests the traffic can have queued at once: the closed
    loop's clients, or, open, as many as a batch holds."""
    if traffic["loop"] == "closed":
        return int(traffic["clients"])
    return int(traffic.get("max_batch", 32))


def run_loop(traffic: dict, submit, seconds: float):
    """The traffic's loop over the window: closed (``clients`` callers)
    or open (``rate`` requests a second, evenly spaced)."""
    if traffic["loop"] == "closed":
        return run_closed_loop(submit, int(traffic["clients"]), seconds)
    return run_open_loop(submit, datagen.arrivals(float(traffic["rate"]),
                                                  seconds), seconds)


def reference_db(config: dict, data: np.ndarray, device):
    from .reference import brute

    if config["kind"] == "subsequence":
        return brute.WindowDatabase(data, int(config["window"]),
                                    int(config.get("stride", 1)), device)
    return brute.RowDatabase(data, device)


# --- the check --------------------------------------------------------------

def judged_requests(loop, inputs: dict, traffic: dict, excl: int) -> tuple:
    """The requests answered OK, as the reference takes them."""
    R = len(inputs["is_knn"])
    rows, reqs, served = [], [], []
    for o in loop.outcomes:
        if o.status != OK:
            continue
        i = o.index % R
        rows.append(i)
        reqs.append({"knn": bool(inputs["is_knn"][i]),
                     "eps": float(inputs["eps"][i]),
                     "k": int(traffic["k"]), "excl": excl})
        served.append((np.asarray(o.ids), np.asarray(o.distances)))
    return np.asarray(rows, np.int64), reqs, served


def check(db, queries: np.ndarray, rows: np.ndarray, reqs: list,
          served: list, fetch: int, limits: dict, unanswered: int) -> tuple:
    """``(correct, checks)``: the served answers judged by the reference.

    ``queries``: the traffic's raw queries; ``rows``: the row of them each
    request of ``reqs`` / ``served`` sent.  Requests of one row ask the
    same, so the reference scans each distinct row once, and each request
    is judged against its row's answer."""
    from .reference import brute, compare

    tau = float(limits["d2_gap_limit"])
    distinct, first, of_row = np.unique(rows, return_index=True,
                                        return_inverse=True)
    ref = brute.scan(db, queries[distinct], [reqs[j]["knn"] for j in first],
                     [reqs[j]["eps"] for j in first], fetch, tau)
    got = compare.judge(db, queries[rows], reqs, served,
                        [ref[u] for u in of_row], tau)
    checks = {
        "d2_gap": {"value": got["d2_gap"], "limit": tau},
        "set_faults": {"value": got["set_faults"],
                       "limit": int(limits["set_faults_limit"])},
        "unanswered": {"value": int(unanswered),
                       "limit": int(limits["unanswered_limit"])},
        "judged_at_least": {"value": got["compared"], "limit": 1},
    }
    ok = (got["compared"] >= 1 and got["d2_gap"] <= tau
          and got["set_faults"] <= checks["set_faults"]["limit"]
          and unanswered <= checks["unanswered"]["limit"])
    return ok, checks


def ref_fetch(config: dict, traffic: dict, excl: int) -> int:
    """How many nearest rows the reference keeps for a k-NN request:
    k, or under an exclusion zone enough for the greedy to find k."""
    k = int(traffic["k"])
    if config["kind"] == "subsequence" and excl > 0:
        return k * 2 * excl
    return k


# --- one run ----------------------------------------------------------------

def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux:
    /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.perf_counter() - (up - start)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_origin: float | None = None) -> dict:
    """Set up, run the window, free the program, judge its answers.

    Returns the record the metric readers take: the client's outcomes
    (``loop``), ``setup_s``, ``peak_bytes``, ``checks`` / ``correct``;
    traced, the stats snapshots around the window, the harness's timings
    of the device passes and replies (``timing``), the parsed
    ``profile`` and the cascade counters of the window's first requests
    (``cascade``, counted after the window)."""
    import torch

    from .systems import System

    t_origin = time.perf_counter() if t_origin is None else t_origin
    config, traffic = cell["config"], cell["traffic"]
    cuda = torch.device(device).type == "cuda"
    inputs = make_inputs(config, traffic, seed, device)
    if cuda:
        # The generator's own memory is gone before the program's peak.
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    system = System(config, traffic, inputs["data"], device)
    excl = int(system.excl)
    system.warm(in_flight(traffic))
    if cuda:
        torch.cuda.synchronize(device)
    R = len(inputs["is_knn"])
    queries, is_knn, eps = inputs["queries"], inputs["is_knn"], inputs["eps"]

    def submit(i):
        j = i % R
        return system.submit(queries[j], is_knn[j], eps[j])

    rec = {"cell": cell["entry"]["name"], "config": config,
           "traffic": traffic, "seed": int(seed), "seconds": seconds,
           "n": int(config.get("length", config.get("window", 0))),
           "n_rows": int(system.service.backend.size),
           "stats_before": None, "stats_after": None, "timing": None,
           "profile": None, "cascade": None,
           "device_name": (torch.cuda.get_device_name(device) if cuda
                           else "cpu")}
    if trace:
        rec["stats_before"] = system.snapshot()
        prof: dict = {}
        timing: dict = {}
        with system.timed(timing), tracelib.capture(prof, cuda=cuda):
            loop = run_loop(traffic, submit, seconds)
        rec["profile"], rec["timing"] = prof, timing
        rec["stats_after"] = system.snapshot()
    else:
        loop = run_loop(traffic, submit, seconds)
    rec["loop"] = loop
    rec["setup_s"] = loop.t0 - t_origin
    rec["peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                         if cuda else 0)
    if trace:
        first = sorted(o.index % R for o in loop.outcomes
                       if o.status == OK)[:CASCADE_REQUESTS]
        rec["cascade"] = system.cascade_totals(
            queries[first], [is_knn[i] for i in first],
            [eps[i] for i in first]) if first else None
    system.close()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    db = reference_db(config, inputs["data"], device)
    rows, reqs, served = judged_requests(loop, inputs, traffic, excl)
    rec["range_answers"] = [len(ids) for r, (ids, _d) in zip(reqs, served)
                            if not r["knn"]]
    fetch = ref_fetch(config, traffic, excl)
    limits = traffic["check"]
    rec["correct"], rec["checks"] = check(
        db, queries, rows, reqs, served, fetch, limits, arith.failed(loop))
    rec["check_s"] = time.perf_counter() - t_check
    return rec


# --- the result line --------------------------------------------------------

def card_info() -> dict:
    """The card's name and power limit from nvidia-smi ("unknown" when it
    cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        name, limit = [s.strip() for s in out[0].split(",")]
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": "unknown", "power_limit": "unknown"}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell: dict, rec: dict, trace: bool, card: dict) -> dict:
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in entries:
        val = reader(m["name"])(rec)
        if val is not None and math.isfinite(val):
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    loop = rec["loop"]
    device = {"platform": "gpu", "kind": rec["device_name"],
              "count": int(cell["entry"].get("chips", 1)),
              "memory_peak_bytes": int(rec["peak_bytes"])}
    out = {"correct": bool(rec["correct"]),
           "attempted": arith.attempted(loop),
           "failed": arith.failed(loop),
           "metrics": metrics, "device": device}
    if trace:
        prof = rec["profile"]
        device["busy_s"] = tracelib.busy_s(prof)
        device["window_s"] = tracelib.window_s(prof)
        out["breakdown"] = {
            "device_ops": tracelib.top_device_ops(prof),
            "idle_gaps": tracelib.labelled_gaps(prof, rec["timing"])}
    out["card"] = card
    out["checks"] = rec["checks"]
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_origin: float | None = None) -> int:
    t_origin = process_start() if t_origin is None else t_origin
    args = parse_args(argv)
    try:
        if not (REPO / "src" / "repro_torch").is_dir():
            raise RunError(f"the program is not here: no "
                           f"{REPO / 'src' / 'repro_torch'}")
        cell = resolve(args.workload, manifest())
        import torch
        chips = int(cell["entry"].get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise RunError(f"needs {chips} CUDA device(s); "
                           f"torch.cuda.is_available()="
                           f"{torch.cuda.is_available()}, device_count="
                           f"{torch.cuda.device_count()}")
        rec = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_origin=t_origin)
        found = forbidden_modules()
        if found:
            raise RunError("the process loaded " + ", ".join(found))
        if args.trace and tracelib.busy_s(rec["profile"]) <= 0:
            raise RunError("the profiler's trace shows no device activity")
        card = card_info()
        line = result_line(cell, rec, bool(args.trace), card)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    _report(rec, line, card)
    print(json.dumps(line))
    return 0


def _report(rec: dict, line: dict, card: dict) -> None:
    """Standard error: the run's own numbers, the shares beside the card,
    and last the numbers compared with their limits."""
    err = sys.stderr
    loop = rec["loop"]
    print(f"portbench: {rec['cell']} seed {rec['seed']}: "
          f"{arith.attempted(loop)} requests, "
          f"{arith.served_in_window(loop)} answered in the window, "
          f"setup {rec['setup_s']:.3f} s, check {rec['check_s']:.3f} s",
          file=err)
    for name, m in line["metrics"].items():
        where = ""
        if m["unit"] == "%":
            where = f" on {card['name']}, power limit {card['power_limit']}"
        print(f"portbench: {name} {m['value']!r} {m['unit']}{where}",
              file=err)
    sizes = rec.get("range_answers") or []
    if sizes:
        q = [arith.percentile(sizes, p) for p in (0, 50, 95, 100)]
        print(f"portbench: range answers min {q[0]:g} median {q[1]:g} "
              f"p95 {q[2]:g} max {q[3]:g} over {len(sizes)} requests",
              file=err)
    if rec.get("profile"):
        kernels, lost = tracelib.engine_kernels(rec["profile"],
                                                rec["timing"]["dispatch"])
        print(f"portbench: {len(kernels)} kernels in the device passes, "
              f"{lost} kernels without a traced launch", file=err)
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
