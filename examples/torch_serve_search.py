"""Sharded FAST_SAX search on the PyTorch port: the paper's engine over a
database split into shards (one per card, or several round robin on one
card), with batched queries; on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_search.py [--shards 4]
  PYTHONPATH=src python examples/torch_serve_search.py --device cpu
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.dist_search import (distributed_build,  # noqa: E402
                                          distributed_range_query,
                                          distributed_survivor_count,
                                          make_data_mesh, pad_database)
from repro_torch.core.options import SearchOptions  # noqa: E402
from repro_torch.data.timeseries import make_queries, make_wafer_like  # noqa: E402


def sync(mesh):
    for dev in {torch.device(d) for d in mesh.devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=0,
                    help="shards of the mesh (0: one per card; 1 on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device of every shard (default: the cards)")
    args = ap.parse_args()
    mesh = make_data_mesh(args.shards or None, device=args.device)
    n_dev = mesh.size
    db = make_wafer_like(8192, 128, seed=0)
    padded, n_valid = pad_database(db, n_dev)

    t0 = time.perf_counter()
    index = distributed_build(padded, (8, 16), alphabet=10, mesh=mesh,
                              n_valid=n_valid)
    sync(mesh)
    print(f"offline phase: {n_valid} series indexed across {n_dev} "
          f"shard(s) in {time.perf_counter() - t0:.2f}s")

    queries = make_queries(db, 32, seed=1)
    counts = np.asarray(distributed_survivor_count(
        index, queries, 2.0, mesh, normalize_queries=False).cpu())
    print(f"survivor counts (phase 1, summed over shards): "
          f"min={counts.min()} median={int(np.median(counts))} "
          f"max={counts.max()}")

    t0 = time.perf_counter()
    gidx, ans, d2, overflow = distributed_range_query(
        index, queries, 2.0, mesh, options=SearchOptions(
            capacity=max(64, int(counts.max()) // n_dev + 8),
            normalize_queries=False))
    sync(mesh)
    dt = time.perf_counter() - t0
    ans, gidx = ans.cpu().numpy(), gidx.cpu().numpy()
    assert not bool(overflow.any())
    for qi in (0, 1, 2):
        hits = sorted(gidx[qi][ans[qi]].tolist())
        print(f"q{qi}: {ans[qi].sum():3d} answers within eps=2.0 "
              f"(first few: {hits[:5]})")
    print(f"{len(queries)} queries answered in {dt * 1e3:.1f} ms "
          f"({len(queries) / dt:.0f} qps on {mesh.devices[0]})")


if __name__ == "__main__":
    main()
