"""Data curation on the PyTorch port: FAST_SAX near-duplicate filtering
inside a streaming ingestion pipeline, the pool and its index on the card
unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_curation_pipeline.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.data.curation import NearDuplicateFilter  # noqa: E402
from repro_torch.data.timeseries import make_wafer_like  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the pool (default: cuda)")
    args = ap.parse_args()
    filt = NearDuplicateFilter(length=128, epsilon=1.0, levels=(8, 16),
                               alphabet=10, device=args.device)
    rng = np.random.default_rng(0)
    kept_rows = []
    total_in = total_kept = 0
    for batch_idx in range(8):
        # Stream: fresh process runs + re-ingested duplicates of old ones.
        fresh = make_wafer_like(256, 128, seed=100 + batch_idx)
        if kept_rows:
            pool = np.concatenate(kept_rows)
            dups = pool[rng.integers(0, len(pool), size=64)] \
                + 0.001 * rng.standard_normal((64, 128)).astype(np.float32)
            batch = np.concatenate([fresh, dups])
        else:
            batch = fresh
        keep = filt.admit(batch)
        kept_rows.append(batch[keep])
        total_in += len(batch)
        total_kept += int(keep.sum())
        print(f"batch {batch_idx}: admitted {keep.sum():3d}/{len(batch)} "
              f"(pool={filt.pool_size})")
    st = filt.stats
    print(f"\ningested {total_in}, kept {total_kept}, "
          f"rejected {st.rejected_duplicates} near-duplicates "
          f"({st.rejected_duplicates / total_in:.0%}) on {filt.device}")


if __name__ == "__main__":
    main()
