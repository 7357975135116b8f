"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (see ``portbench/README.md``);
``run.py control ...`` runs the check's control (``control.py``).
"""
import os
import pathlib
import sys

if __name__ == "__main__":
    _repo = pathlib.Path(__file__).resolve().parent.parent
    # Every build and kernel cache in fixed directories of the checkout.
    _cache = _repo / "build" / "portbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(_cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(_cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(_cache / "nv")
    sys.path[:0] = [str(_repo), str(_repo / "src")]
    if len(sys.argv) > 1 and sys.argv[1] == "control":
        from portbench.control import main
        sys.exit(main(sys.argv[2:]))
    from portbench.harness import main
    sys.exit(main(sys.argv[1:]))
