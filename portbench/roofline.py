"""The yardstick of the kernels layer: peaks and the least work of a window.

After ``chip_smoke.py::bound_ms``, but counted from shapes and counters
alone, whatever implements the search: each input byte once per device
pass (the database's series, norms, words and residuals, and the
queries) and the outputs the answers need (an id and a d² per answer),
not a dense (Q, B) mask.  Words count one byte a symbol (an alphabet of
at most 256 fits one); series, norms, residuals and queries four.
A query counts as a row.
Operations: the level-0 C9 test on every (query, row) pair (3), in
float32.  The exact distances of the pairs that survive the cascade are
left out: their count needs the program's counting pass, which the timed
path does not run, and leaving work out keeps the bound a lower bound.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12},
}


def peaks_for(device_name: str) -> dict:
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    raise KeyError(f"no peaks for {device_name!r}")


def row_bytes(n: int, levels) -> int:
    """Bytes of one database row: series, its norm, a word and a
    residual per level."""
    levels = [int(N) for N in levels]
    return 4 * int(n) + 4 + sum(levels) + 4 * len(levels)


def window_work(B: int, n: int, levels, buckets, answers: int) -> tuple:
    """``(bytes, flops)`` the window's device passes need: one pass per
    entry of ``buckets`` (its Q bucket), ``answers`` ids and d² out."""
    nbytes = (len(buckets) * int(B) * row_bytes(n, levels)
              + sum(int(q) for q in buckets) * row_bytes(n, levels)
              + int(answers) * 8)
    flops = 3 * int(B) * sum(int(q) for q in buckets)
    return nbytes, flops


def bound_s(nbytes: float, flops: float, peaks: dict) -> tuple:
    """``(seconds, "bytes" | "flops")``: the larger of the two times."""
    tb = nbytes / peaks["hbm_bytes_per_s"]
    tf = flops / peaks["f32_flops_per_s"]
    return (tb, "bytes") if tb >= tf else (tf, "flops")
