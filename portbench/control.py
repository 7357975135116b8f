"""The control of a cell's check: the reference, in TF32, in the
program's place.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --requests 600

For each seed it makes the cell's data and request stream as a run does,
answers the first ``--requests`` requests of the stream with the
reference computed one precision below the configuration's float32
(TF32 inner products, ``reference/brute.py``), and judges those answers
as a run judges the program's.  Each seed prints one JSON line with the
numbers compared and their limits; the check is sound only where the
control comes out not correct.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import harness


def control_readings(cell: dict, seed: int, n_requests: int,
                     device) -> dict:
    """``{"correct": bool, "checks": {...}}`` of the control on the first
    ``n_requests`` requests of ``seed``'s stream."""
    from .reference import compare

    config, traffic = cell["config"], cell["traffic"]
    inputs = harness.make_inputs(config, traffic, seed, device)
    excl = int(traffic.get("excl") or config.get("window", 0) // 2) \
        if config["kind"] == "subsequence" else 0
    rows = np.arange(n_requests) % len(inputs["is_knn"])
    reqs = [{"knn": bool(inputs["is_knn"][i]), "eps": float(inputs["eps"][i]),
             "k": int(traffic["k"]), "excl": excl} for i in rows]
    db = harness.reference_db(config, inputs["data"], device)
    fetch = harness.ref_fetch(config, traffic, excl)
    q = inputs["queries"][rows]
    served = compare.control_answers(db, q, reqs, fetch)
    ok, checks = harness.check(db, inputs["queries"], rows, reqs, served,
                               fetch, traffic["check"], 0)
    return {"correct": ok, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload, harness.manifest())
    for seed in (int(s) for s in args.seeds.split(",")):
        got = control_readings(cell, seed, args.requests, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, **got}))
        sys.stdout.flush()
    return 0
