#!/usr/bin/env python3
"""The torch engine's dense mixed pass (``engine.mixed_query_dense``) of
this checkout against another checkout's, on one NVIDIA GPU: timed in
turns, and each side's exactness across the service's dense switch.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 scripts/dense_ab.py build/base

The other checkout (``build/`` is git-ignored) is loaded in the same
process as the package ``repro_torch_base`` (``kernel_ab.load_package``).
Inputs: serve-1M's shapes, 2^20 z-normalised random walks of n = 128
made on the card from a seed, levels (8, 16), α 10; mixed batches of
Q = 1 and Q = 32 requests (rows plus noise, every other one a k-NN
request with k = 5, range requests at ε = 4).  Each side builds its own
index from the same walks and represents the same queries.

Times: CUDA events around each call, 5 calls after one warm-up, in the
order base, change, change, base; the median of each side's calls.
Exactness: the side's compacting pass (``mixed_query_auto``) against its
dense pass on the same batch, each row's answer ids and distances bit
for bit (range rows: the answer set and its d²; k-NN rows: the top-k
ids and d²); the rows that differ are counted, 0 is exact.  The two
sides' range answers must agree by the band rule |d² − ε²| ≤ 1e-3 +
1e-5·ε².  Everything is written to ``chiprun_out/dense_ab.json``.
Needs a card; ``chip_smoke.py`` does not use this script.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, N_LEN, LEVELS, ALPHABET, K, EPS = 1 << 20, 128, (8, 16), 10, 5, 4.0
REPS = 5


def batch(torch, engine, series, Q: int, gen):
    """One mixed batch on ``engine``'s side: ``(qr, eps, is_knn)``."""
    dev = series.device
    rows = torch.arange(Q, device=dev) * (B // 32 - 1)
    noise = 0.1 * torch.randn((Q, N_LEN), generator=gen, device=dev)
    qr = engine.represent_queries(series[rows] + noise, LEVELS, ALPHABET)
    is_knn = torch.arange(Q, device=dev) % 2 == 1
    return qr, torch.full((Q,), EPS, device=dev), is_knn


def timed(torch, fn, reps: int = REPS) -> list:
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(stop))
    return out


def exact_rows(torch, engine, index, qr, eps, is_knn) -> int:
    """Rows whose compact and dense answers differ in any bit."""
    idx, ans, d2, _ = engine.mixed_query_auto(index, qr, eps, is_knn, K)
    didx, dans, dd2, _ = engine.mixed_query_dense(index, qr, eps, is_knn, K)
    bad = 0
    for qi in range(qr.q.shape[0]):
        if bool(is_knn[qi]):
            ci, cd = engine.mixed_topk(idx[qi:qi + 1], d2[qi:qi + 1], K)
            di, dd = engine.mixed_topk(didx[qi:qi + 1], dd2[qi:qi + 1], K)
            bad += not (torch.equal(ci, di) and torch.equal(cd, dd))
        else:
            got = idx[qi][ans[qi]].long()
            same = torch.equal(torch.sort(got).values,
                               torch.nonzero(dans[qi]).flatten())
            bad += not (same and torch.equal(d2[qi][ans[qi]],
                                              dd2[qi][got]))
    return bad


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    from kernel_ab import load_package
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("dense_ab: no CUDA device", file=sys.stderr)
        return 2
    base_root = pathlib.Path(sys.argv[1]).resolve()
    load_package(base_root / "src", "repro_torch_base")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import engine as change
    import repro_torch_base.core.engine as base

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    walk = torch.cumsum(torch.randn((B, N_LEN), generator=gen, device=dev),
                        dim=-1)
    sides = {name: eng.build_device_index(walk, LEVELS, ALPHABET)
             for name, eng in (("base", base), ("change", change))}
    del walk
    engines = {"base": base, "change": change}
    report = {"card": card, "rows": B, "eps": EPS, "k": K, "reps": REPS,
              "batches": {}}
    for Q in (1, 32):
        inputs = {}
        for name, eng in engines.items():
            g = torch.Generator(device=dev).manual_seed(100 + Q)
            inputs[name] = batch(torch, eng, sides[name].series, Q, g)
        times = {"base": [], "change": []}
        for name in ("base", "change", "change", "base"):
            eng, index = engines[name], sides[name]
            qr, eps, is_knn = inputs[name]
            times[name] += timed(torch, lambda: eng.mixed_query_dense(
                index, qr, eps, is_knn, K))
        ans = {}
        for name, eng in engines.items():
            qr, eps, is_knn = inputs[name]
            _, a, d2, _ = eng.mixed_query_dense(sides[name], qr, eps, is_knn,
                                                K)
            ans[name] = (a & ~is_knn[:, None], d2)
        differ = ans["base"][0] != ans["change"][0]
        d2 = torch.where(ans["base"][0], ans["base"][1], ans["change"][1])
        near = (d2 - EPS * EPS).abs() <= 1e-3 + 1e-5 * EPS * EPS
        entry = {
            "ms_median": {n: sorted(t)[len(t) // 2] for n, t in times.items()},
            "ms": times,
            "range_rows_band": int((differ & near).sum()),
            "range_rows_wrong": int((differ & ~near).sum()),
            "compact_vs_dense_rows_differing": {
                name: exact_rows(torch, eng, sides[name], *inputs[name])
                for name, eng in engines.items()}}
        report["batches"][str(Q)] = entry
        print(f"[dense-ab] Q={Q}: mixed_query_dense ms (median of "
              f"{2 * REPS}) base {entry['ms_median']['base']:.3f} change "
              f"{entry['ms_median']['change']:.3f}; range rows band "
              f"{entry['range_rows_band']} wrong {entry['range_rows_wrong']};"
              f" rows whose compact and dense answers differ "
              f"{entry['compact_vs_dense_rows_differing']}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dense_ab.json").write_text(json.dumps(report, indent=1))
    print(card)
    ok = all(e["range_rows_wrong"] == 0
             and e["compact_vs_dense_rows_differing"]["change"] == 0
             for e in report["batches"].values())
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
