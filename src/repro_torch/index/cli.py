"""Index lifecycle command line, counterpart of ``repro/index/cli.py``::

    python -m repro_torch.index.cli build   --dir IDX [--db-size 4096] [--input X.npy]
    python -m repro_torch.index.cli insert  --dir IDX [--db-size 256]  [--input X.npy]
    python -m repro_torch.index.cli delete  --dir IDX --ids 3,17,42
    python -m repro_torch.index.cli compact --dir IDX
    python -m repro_torch.index.cli info    --dir IDX [--stats]
    python -m repro_torch.index.cli verify  --dir IDX

``--input`` takes a ``.npy`` of shape (B, n); without it the rows come
from the synthetic wafer-like generator (``--db-size`` / ``--length`` /
``--seed``), so the whole lifecycle runs with no data file.  Every
command works on the host (numpy); a root it writes warm-starts
``SearchService.from_store`` of either package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from ..core.fastsax import FastSAXConfig
from .mutable import MutableIndex


def _rows(args) -> np.ndarray:
    if args.input:
        series = np.load(args.input)
        if series.ndim != 2:
            raise SystemExit(f"{args.input}: expected (B, n), "
                             f"got {series.shape}")
        return series
    from ..data.timeseries import make_wafer_like
    return make_wafer_like(n_series=args.db_size, length=args.length,
                           seed=args.seed, normalize=False)


def _parse_levels(s: str) -> tuple:
    return tuple(int(p) for p in s.split(",") if p.strip())


def cmd_build(args) -> None:
    stack = tuple(p.strip() for p in args.stack.split(",") if p.strip())
    cfg = FastSAXConfig(n_segments=_parse_levels(args.levels),
                        alphabet=args.alphabet, stack=stack)
    rows = _rows(args)
    t0 = time.perf_counter()
    mi = MutableIndex.create(args.dir, rows, cfg,
                             quantization=args.quantization)
    quant = (f", quantization={mi.quantization}"
             if mi.quantization != "none" else "")
    print(f"[index] built gen 0: {mi.n_live} rows (n={rows.shape[1]}, "
          f"levels={cfg.n_segments}, alphabet={cfg.alphabet}{quant}) "
          f"in {time.perf_counter() - t0:.2f}s -> {args.dir}")


def cmd_insert(args) -> None:
    mi = MutableIndex.open(args.dir)
    rows = _rows(args)
    t0 = time.perf_counter()
    ids = mi.insert(rows)
    print(f"[index] inserted {ids.size} rows (ids {ids[0]}..{ids[-1]}) "
          f"in {time.perf_counter() - t0:.2f}s; live={mi.n_live}")


def cmd_delete(args) -> None:
    mi = MutableIndex.open(args.dir)
    ids = [int(p) for p in args.ids.split(",") if p.strip()]
    live = mi.delete(ids)
    print(f"[index] tombstoned {len(ids)} rows; live={live}")


def cmd_compact(args) -> None:
    mi = MutableIndex.open(args.dir)
    before = mi.info()
    t0 = time.perf_counter()
    info = mi.compact()
    print(f"[index] compacted gen {before['gen']} -> gen {info['gen']}: "
          f"{before['rows']} rows ({before['n_deltas']} delta(s), "
          f"{before['tombstoned']} tombstone(s)) -> {info['rows']} live "
          f"in {time.perf_counter() - t0:.2f}s")


def _probe_stats(mi: MutableIndex, n_queries: int, epsilon: float) -> dict:
    """Cascade pruning over the committed store: a strided sample of live
    rows queried back through the op-counted host engine."""
    from ..core.cost_model import OpCounter
    from ..core.fastsax import represent_query
    from ..core.search import fastsax_range_query

    index, _ids = mi.live_index()
    B = index.size
    if B == 0:
        return {"queries": 0, "epsilon": float(epsilon), "rows": 0}
    nq = max(1, min(int(n_queries), B))
    sample = np.linspace(0, B - 1, nq).astype(np.int64)
    counter = OpCounter()
    totals = {k: 0 for k in ("candidates", "excluded_c9", "excluded_c10",
                             "answers", "levels_visited")}
    for qi in sample:
        # Stored series are z-normalised already: represent them as they are.
        qr = represent_query(np.asarray(index.series[qi], np.float64),
                             mi.config, normalize=False)
        r = fastsax_range_query(index, qr, epsilon, counter=counter)
        totals["candidates"] += int(r.candidates)
        totals["excluded_c9"] += int(r.excluded_c9)
        totals["excluded_c10"] += int(r.excluded_c10)
        totals["answers"] += int(r.answers.size)
        totals["levels_visited"] += int(r.levels_visited)
    ops = {f.name: getattr(counter, f.name)
           for f in dataclasses.fields(counter) if f.name != "weights"}
    return {"queries": nq, "epsilon": float(epsilon), "rows": int(B),
            "rows_screened": nq * int(B), **totals, "ops": ops,
            "model_latency": counter.latency()}


def cmd_info(args) -> None:
    mi = MutableIndex.open(args.dir)
    info = mi.info()
    if args.stats:
        info["stats"] = _probe_stats(mi, args.stats_queries,
                                     args.stats_epsilon)
    print(json.dumps(info, indent=1))


def cmd_verify(args) -> None:
    names = MutableIndex.open(args.dir).verify()
    for name in names:
        print(f"[index] {name}: checksums OK")
    print(f"[index] verified {len(names)} store(s)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.index.cli",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, data=True):
        p.add_argument("--dir", required=True, help="index root directory")
        if data:
            p.add_argument("--input", default="",
                           help=".npy of (B, n) rows; default: synthetic")
            p.add_argument("--db-size", type=int, default=4096)
            p.add_argument("--length", type=int, default=128)
            p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("build", help="build generation 0")
    common(p)
    p.add_argument("--levels", default="8,16",
                   help="comma-separated segment counts, coarse→fine")
    p.add_argument("--alphabet", type=int, default=10)
    p.add_argument("--stack", default="linfit_residual,sax_word",
                   help="comma-separated registered representation names")
    p.add_argument("--quantization", default="none",
                   choices=("none", "bf16", "int8"),
                   help="quantized resident tier written with every "
                        "segment")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("insert", help="append rows as a delta segment")
    common(p)
    p.set_defaults(fn=cmd_insert, seed=1)

    p = sub.add_parser("delete", help="tombstone rows by external id")
    common(p, data=False)
    p.add_argument("--ids", required=True, help="comma-separated ids")
    p.set_defaults(fn=cmd_delete)

    p = sub.add_parser("compact", help="fold deltas+tombstones into a new base")
    common(p, data=False)
    p.set_defaults(fn=cmd_compact)

    p = sub.add_parser("info", help="print the committed epoch summary")
    common(p, data=False)
    p.add_argument("--stats", action="store_true",
                   help="also query a strided sample of live rows back "
                        "through the op-counted host engine and attach "
                        "the cascade's pruning under a 'stats' key")
    p.add_argument("--stats-queries", type=int, default=16,
                   help="with --stats: probe sample size")
    p.add_argument("--stats-epsilon", type=float, default=2.0,
                   help="with --stats: probe range-query radius")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("verify", help="re-hash every segment's checksums")
    common(p, data=False)
    p.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    try:
        args.fn(args)
    except (FileNotFoundError, FileExistsError, KeyError, ValueError,
            IOError) as e:
        print(f"[index] error: {e}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
