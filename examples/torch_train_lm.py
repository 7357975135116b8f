"""End-to-end training on the PyTorch port: a granite-family smoke model
for a few hundred steps on the deterministic token pipeline, with
checkpointing, the watchdog and resume; on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]

(This wraps ``repro_torch/launch/train.py``, the launcher that trains the
full published configs on the card without ``--smoke``.)
"""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.launch.train import main as train_main  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "granite-3-2b", "--smoke",
                "--steps", str(args.steps),
                "--global-batch", "16", "--seq-len", "128",
                "--lr", "1e-3", "--ckpt-dir", args.ckpt_dir or tmp,
                "--ckpt-every", "100", "--log-every", "20"]
        if args.device:
            argv += ["--device", args.device]
        losses = train_main(argv)
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'decreased' if last < first else 'no decrease'})")


if __name__ == "__main__":
    main()
