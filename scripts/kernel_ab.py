#!/usr/bin/env python3
"""The fused kernels of this checkout against another checkout's, on one
NVIDIA GPU: bit for bit on the same inputs, timed in turns, and (with
``--split``) where each kernel body's time goes.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 scripts/kernel_ab.py build/base [--split] [--rows 65536]

The other checkout (``build/`` is git-ignored) is loaded in the same
process as the package ``repro_torch_base``; each side builds its own
``csrc/fused_query.cu``.  The inputs are those ``chip_smoke.py`` makes:
serve-1M (Q = 32, B = 2^20, n = 128, levels (8, 16), α 10) for kernels 1,
2, 5 and 6 (int8 and bf16) at the path's tiles, and subseq-1M (16 streams
of 262,144 samples, windows of 128 at stride 4) for kernels 3, 4 and 7.
A side whose wrappers take the per-query MINDIST panels gets them
(``ops.query_panels``); one that takes the query words gets those.

Each kernel's outputs must be equal bit for bit on both sides (the run
fails otherwise).  Times: CUDA events over 20 launches, in the order
base, change, change, base.  ``--split`` builds a copy of each side's
source with ``clock64()`` stamps summed per warp into staging (the
barrier and copy time at the top of a sub-tile), cascade (C9 + C10),
verify and the rest (outputs, top-k merge), and reports each share; the
copies live in ``build/kernel_ab/`` and the sources stay as they are.
Everything is written to ``chiprun_out/kernel_ab.json``.  Needs a card;
``chip_smoke.py`` does not use this script.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import pathlib
import re
import subprocess
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLIT_DIR = ROOT / "build" / "kernel_ab"
PHASES = ("stage", "cascade", "verify", "rest")


def load_package(src_dir: pathlib.Path, name: str):
    """Import ``src_dir/repro_torch`` as the package ``name``."""
    pkg = src_dir / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The split: clock64() stamps in a copy of a side's source.
# ---------------------------------------------------------------------------

HEADER = r"""
__device__ unsigned long long g_split[8];
#define SPLIT_MARK(k) { const long long _n = clock64(); _sp[k] += _n - _tl; _tl = _n; }
"""
FLUSH = r"""  SPLIT_MARK(3);
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < 4; ++k) atomicAdd(&g_split[k], (unsigned long long)_sp[k]);
    atomicAdd(&g_split[4], 1ull);
  }
"""
TAIL = r"""
extern "C" int split_reset() {
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_split, z, sizeof z);
}
extern "C" int split_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_split, 8 * sizeof(unsigned long long));
}
"""
# (anchor, mark, before the anchor?) per body version; mark k closes the
# phase PHASES[k] at that point.
ANCHORS = {
    "ring": [
        ("    cp_async_wait_all();\n    __syncthreads();\n", 3, True),
        ("                                row0 + TB, next_rows);\n", 0, False),
        ("      // ---- verify:", 1, True),
        ("      // The limit on d²:", 2, True),
        ("  if (TOPK) {\n    __syncthreads();\n    const long width", 3, True)],
    "synchronous": [
        ("    __syncthreads();\n    stage_rows<MODE, STREAM>(", 3, True),
        ("      // ---- cascade: alive bits", 0, True),
        ("      // ---- verify:", 1, True),
        ("      // The limit on d²:", 2, True),
        ("  if (TOPK) {\n    __syncthreads();\n    const long width", 3, True)],
}
INIT = "  const float INF = __int_as_float(0x7f800000);\n"
BODY_END = re.compile(r"\n}\n\n// (Both forms|The range form)")


def instrument(text: str) -> str:
    kind = "ring" if "cp_async_wait_all();" in text else "synchronous"
    text = text.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    assert text.count(INIT) == 1
    text = text.replace(INIT, INIT + "  long long _sp[4] = {0, 0, 0, 0};\n"
                        "  long long _tl = clock64();\n", 1)
    for anchor, mark, before in ANCHORS[kind]:
        assert text.count(anchor) == 1, anchor
        stamp = f"SPLIT_MARK({mark});\n"
        text = text.replace(anchor, ("  " * 3 + stamp + anchor) if before
                            else anchor + "  " * 3 + stamp)
    m = list(BODY_END.finditer(text))
    assert len(m) == 1
    i = m[0].start() + 1
    return text[:i] + FLUSH + text[i:] + TAIL


def build_split(side: str, pkg) -> ctypes.CDLL:
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    src = pathlib.Path(pkg.kernels.build.CSRC) / "fused_query.cu"
    cu = SPLIT_DIR / f"{side}_split.cu"
    so = SPLIT_DIR / f"lib{side}_split.so"
    cu.write_text(instrument(src.read_text()))
    b = pkg.kernels.build
    proc = subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(so))


# ---------------------------------------------------------------------------
# The kernels of one side on the shared inputs.
# ---------------------------------------------------------------------------


class Side:
    """One checkout's wrappers, adapting the query side to what they
    take (panels or words)."""

    def __init__(self, name, pkg):
        from importlib import import_module
        self.name, self.pkg = name, pkg
        self.fq = import_module(f"{pkg.__name__}.kernels.fused_query")
        self.ops = import_module(f"{pkg.__name__}.kernels.ops")
        self.words = "q_words" in inspect.signature(
            self.fq.fused_range).parameters

    def query(self, q_words, alphabet):
        return q_words if self.words else tuple(
            self.ops.query_panels(w, alphabet) for w in q_words)

    def kw(self, args):
        """Keyword arguments of a whole-series or streaming wrapper."""
        out = {k: v for k, v in args.items() if k != "q_words"}
        out["q_words" if self.words else "q_panels"] = self.query(
            args["q_words"], args["alphabet"])
        return out

    def pos(self, args):
        """Positional arguments of a quantized wrapper."""
        qdev, q, q_words, q_res, eps = args
        return qdev, q, self.query(q_words, qdev.alphabet), q_res, eps

    def use(self, lib):
        self.pkg.kernels.build._libs["fused_query"] = lib


def cases(torch, cs, engine, ss, FastSAXConfig, build_index, make_queries,
          make_wafer_like, make_subseq_queries, rows=None):
    """(name, kernel, kind, args, tile) at serve-1M and subseq-1M, the
    inputs and tiles chip_smoke.py gives the kernels; with ``rows``, the
    whole-series kernels only, over ``rows`` series made as chip_smoke.py
    makes its B = 65,536 case (data seed 1, queries seed 3)."""
    if rows:
        db = make_wafer_like(rows, 128, seed=1)
        queries = make_queries(db, 32, seed=3)
    else:
        db = make_wafer_like(cs.N_SERVE, 128, seed=0)
        queries = make_queries(db, 64, seed=1)[:32]
    index = engine.build_device_index(db, (8, 16), 10)
    _, args, rtile, ttile = cs.path_inputs(torch, engine, index, queries)
    out = [("1 fused_range f32", "fused_range", "kw", args, rtile),
           ("2 fused_topk f32", "fused_topk", "kw", args, ttile)]
    host = build_index(db, FastSAXConfig(n_segments=(8, 16), alphabet=10))
    for mode in ("int8", "bf16"):
        tier = engine.TieredIndex.from_host(host, mode)
        qargs, qr_tile, qt_tile = cs.quant_path_inputs(torch, engine, tier,
                                                       queries)
        out += [(f"5 fused_quant_range {mode}", "fused_quant_range", "pos",
                 qargs, qr_tile),
                (f"6 fused_quant_topk {mode}", "fused_quant_topk", "pos",
                 qargs, qt_tile)]
    del db, host
    if rows:
        return out
    cfg = cs.SUBSEQ
    streams = make_wafer_like(cfg["streams"], cfg["stream_len"], seed=0,
                              normalize=False)
    hidx = ss.build_subseq_index(streams, FastSAXConfig(n_segments=(8, 16)),
                                 cfg["window"], cfg["stride"])
    sidx = ss.subseq_device_index(hidx)
    qr = ss.represent_subseq_queries(
        sidx, make_subseq_queries(streams, cfg["queries"], cfg["window"],
                                  seed=1))
    Q, W = qr.q.shape[0], sidx.n_windows
    kf = ss.knn_fetch_count(cfg["k"], cfg["excl"], cfg["stride"], W)
    sargs = cs.subseq_inputs(torch, engine, sidx, qr, kf)
    k_sel = kf + engine._TOPK_GUARD
    rq, rb = ss._subseq_blocks(sidx, Q, 0)
    tq, tb = ss._subseq_blocks(sidx, Q, k_sel)
    qq, qb = ss._subseq_blocks(sidx, Q, 0, quant="int8")
    qmeta = ss.quantize_subseq_meta(hidx, "int8")
    qsargs = {k: v for k, v in sargs.items()
              if k not in ("words", "residuals")}
    qsargs["qmeta"] = qmeta
    out += [("3 fused_subseq_range", "fused_subseq_range", "kw", sargs,
             dict(block_q=rq, block_b=rb)),
            ("4 fused_subseq_topk", "fused_subseq_topk", "kw", sargs,
             dict(block_q=tq, block_b=tb, k=k_sel)),
            ("7 fused_quant_subseq_range int8", "fused_quant_subseq_range",
             "kw", qsargs, dict(block_q=qq, block_b=qb))]
    return out


def caller(side, kernel, kind, args, tile):
    fn = getattr(side.fq, kernel)
    if kind == "pos":
        a = side.pos(args)
        return lambda: fn(*a, **tile)
    kw = side.kw(args)
    return lambda: fn(**kw, **tile)


def bits(torch, outs):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in outs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=pathlib.Path,
                    help="the other checkout (holds src/repro_torch)")
    ap.add_argument("--split", action="store_true",
                    help="also time each body's phases (clock64 copies)")
    ap.add_argument("--rows", type=int, default=None,
                    help="whole-series kernels only, over this many rows "
                         "(default: serve-1M and subseq-1M)")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.core import subseq as ss
    from repro_torch.core.fastsax import FastSAXConfig, build_index
    from repro_torch.data.timeseries import (make_queries,
                                             make_subseq_queries,
                                             make_wafer_like)
    base_pkg = load_package(opts.base.resolve() / "src", "repro_torch_base")
    sides = {"base": Side("base", base_pkg),
             "change": Side("change", repro_torch)}

    # Build both sides (and their split copies), all nvcc at once.
    libs, errors = {}, []

    def job(key, fn):
        try:
            libs[key] = fn()
        except Exception as e:          # re-raised below, after the join
            errors.append((key, e))
    jobs = []
    for name, side in sides.items():
        b = side.pkg.kernels.build
        jobs.append(threading.Thread(target=job, args=(
            name, lambda b=b: (b.build(["fused_query"]),
                               b.load("fused_query"))[1])))
        if opts.split:
            jobs.append(threading.Thread(target=job, args=(
                f"{name}_split", lambda n=name, s=side: build_split(n,
                                                                    s.pkg))))
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise RuntimeError(f"build failed: {errors}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    report = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "base": str(opts.base), "kernels": {},
              "ptxas": {n: s.pkg.kernels.build.BUILD_INFO["fused_query"]
                        ["log"] for n, s in sides.items()}}
    for name, side in sides.items():
        for line in cs.ptxas_summary(report["ptxas"][name]):
            print(f"[ptxas] {name}: {line}", flush=True)

    for label, kernel, kind, args, tile in cases(
            torch, cs, engine, ss, FastSAXConfig, build_index, make_queries,
            make_wafer_like, make_subseq_queries, opts.rows):
        fns = {n: caller(s, kernel, kind, args, tile)
               for n, s in sides.items()}
        for n, s in sides.items():
            s.use(libs[n])
        outs = {n: bits(torch, fn()) for n, fn in fns.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["base"],
                                                     outs["change"]))
        del outs
        turns = [(n, cs.cuda_ms(torch, fns[n], 20))
                 for n in ("base", "change", "change", "base")]
        ms = {n: sum(t for m, t in turns if m == n) / 2 for n in sides}
        row = {"bit_identical": same, "tile": tile, "turns_ms": turns,
               "base_ms": ms["base"], "change_ms": ms["change"]}
        if opts.split:
            for n, s in sides.items():
                lib = libs[f"{n}_split"]
                s.use(lib)
                fns[n]()
                torch.cuda.synchronize()
                lib.split_reset()
                t = cs.cuda_ms(torch, fns[n], 20)
                buf = (ctypes.c_ulonglong * 8)()
                lib.split_read(buf)
                total = sum(buf[:4])
                row[f"{n}_split"] = {
                    "ms_instrumented": t,
                    "cycles_per_warp": total / max(1, buf[4]),
                    **{p: buf[i] / total for i, p in enumerate(PHASES)}}
                s.use(libs[n])
        report["kernels"][label] = row
        split = "".join(
            f"; {n} split " + ", ".join(
                f"{p} {100 * row[f'{n}_split'][p]:.1f}%" for p in PHASES)
            for n in sides if opts.split)
        print(f"[ab] {label}: base {ms['base']:.4f} ms, change "
              f"{ms['change']:.4f} ms (turns "
              + ", ".join(f"{n} {t:.4f}" for n, t in turns)
              + f"); bit-identical {same}{split}", flush=True)
        if not same:
            raise RuntimeError(f"{label}: the outputs differ")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = f"kernel_ab_{opts.rows}.json" if opts.rows else "kernel_ab.json"
    (out / name).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
