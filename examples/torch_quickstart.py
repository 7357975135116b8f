"""Quickstart on the PyTorch port: build a FAST_SAX index, run range
queries, compare against classical SAX (the paper's op-counted host
engines), then answer the same queries with the device engine, on the
card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import engine  # noqa: E402
from repro_torch.core.cost_model import DEFAULT_WEIGHTS  # noqa: E402
from repro_torch.core.fastsax import (FastSAXConfig, build_index,  # noqa: E402
                                      represent_query)
from repro_torch.core.search import (fastsax_range_query,  # noqa: E402
                                     linear_scan, sax_range_query)
from repro_torch.data.timeseries import make_queries, make_wafer_like  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the device engine (default: cuda)")
    args = ap.parse_args()
    # 1. A wafer-like database of 4,096 z-normalised series (UCR stand-in).
    db = make_wafer_like(n_series=4096, length=128, seed=0)

    # 2. Offline phase: SAX words + optimal-linear-fit residuals per level.
    cfg = FastSAXConfig(n_segments=(8, 16), alphabet=10)
    index = build_index(db, cfg, normalize=False)
    print(f"indexed {index.size} series, levels={cfg.levels}, "
          f"alphabet={cfg.alphabet}")

    # 3. Online phase: range queries on the op-counted host engines.
    queries = make_queries(db, 5, seed=1)
    for eps in (1.0, 2.0):
        print(f"\n=== epsilon {eps} (latency weights: {DEFAULT_WEIGHTS}) ===")
        for qi, q in enumerate(queries):
            qr = represent_query(q, cfg, normalize=False)
            truth = linear_scan(index, qr, eps)
            sax = sax_range_query(index, qr, eps)
            fast = fastsax_range_query(index, qr, eps)
            assert np.array_equal(truth.answers, fast.answers)
            assert np.array_equal(truth.answers, sax.answers)
            print(f"q{qi}: {len(fast.answers):3d} answers | "
                  f"latency scan={truth.latency:.2e} sax={sax.latency:.2e} "
                  f"fast_sax={fast.latency:.2e} "
                  f"(speedup vs SAX: {sax.latency / fast.latency:.2f}x; "
                  f"C9 excluded {fast.excluded_c9}, "
                  f"C10 excluded {fast.excluded_c10})")

    # 4. The same queries, batched, on the device engine.
    dindex = engine.build_device_index(db, cfg.levels, cfg.alphabet,
                                       normalize=False, device=args.device)
    qt = torch.as_tensor(queries, dtype=torch.float32, device=dindex.device)
    answers, _ = engine.range_query(
        dindex, engine.represent_queries(qt, cfg.levels, cfg.alphabet,
                                         normalize=False), 2.0)
    answers = answers.cpu().numpy()
    for qi, q in enumerate(queries):
        truth = linear_scan(index, represent_query(q, cfg, normalize=False),
                            2.0)
        assert np.array_equal(np.flatnonzero(answers[qi]),
                              np.sort(truth.answers))
    print(f"\ndevice engine on {dindex.device}: {len(queries)} queries at "
          f"epsilon 2.0, the same answers as the linear scan")


if __name__ == "__main__":
    main()
