#!/usr/bin/env python3
"""The kernels of this checkout against another checkout's, on one NVIDIA
GPU: bit for bit on the same inputs, timed in turns, and (with
``--split``) where each kernel body's time goes.

    mkdir -p build/base && git archive <commit> | tar -x -C build/base
    python3 scripts/kernel_ab.py build/base [--split] [--rows 65536]
    python3 scripts/kernel_ab.py build/base --level [--split]

The other checkout (``build/`` is git-ignored) is loaded in the same
process as the package ``repro_torch_base``; each side builds its own
sources.  By default the fused kernels (``csrc/fused_query.cu``) on the
inputs ``chip_smoke.py`` makes: serve-1M (Q = 32, B = 2^20, n = 128,
levels (8, 16), α 10) for kernels 1, 2, 5 and 6 (int8 and bf16) at the
path's tiles, and subseq-1M (16 streams of 262,144 samples, windows of
128 at stride 4) for kernels 3, 4 and 7.  A side whose wrappers take the
per-query MINDIST panels gets them (``ops.query_panels``); one that takes
the query words gets those.  With ``--level``, the per-level kernels
8-12 (``csrc/level_ops.cu``) on phase 12's and 13's inputs: the serve-1M
index's z-normalised rows, words and residuals at N = 8 and 16, one
query, ε = 2; ``prune_level`` with every row alive (phase 12) and with
the survivors of the level before (phase 13's second call); ``sqdist``
(f32 and bf16) over all 2^20 rows and over phase 13's mean survivor
count of them.  Where the change's ``sqdist`` has the register body, a
copy of it that writes each row from lane 0 of its lanes is timed
against it too.

Each kernel's outputs must be equal bit for bit on both sides (the run
fails otherwise).  Times: CUDA events over 20 launches, in the order
base, change, change, base; with ``--level`` both the kernel launched
alone, its launches queued behind a spin kernel so that the card's time
is measured and not the host's (``chip_smoke.device_ms``), and the
wrapper's whole call in a loop.  ``--split`` builds a copy of each
side's source with ``clock64()`` stamps summed per warp into the body's
phases and reports each share: for the fused body staging (the barrier
and copy time at the top of a sub-tile and the one-stage copy at its
bottom), cascade (C9 + C10), verify and the rest (outputs, top-k merge)
— a body with the streaming ring splits staging into the wait at the
top of a sub-tile, the copies' issue and the z-tile build, and reports
their sum as staging too; for the level bodies the phases each version
has (``LEVEL_SPLITS``).  The copies live in
``build/kernel_ab/`` and the sources stay as they are.  Everything is written to
``chiprun_out/kernel_ab.json`` (``kernel_ab_level.json`` with
``--level``).  Needs a card; ``chip_smoke.py`` does not use this script.
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

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPLIT_DIR = ROOT / "build" / "kernel_ab"


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
FLUSH = r"""  SPLIT_MARK(%d);
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < %d; ++k) atomicAdd(&g_split[k], (unsigned long long)_sp[k]);
    atomicAdd(&g_split[7], 1ull);
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
# Per version of the fused body, its phases and its stamps (anchor, mark,
# before the anchor?); mark k closes phase k at that point.  The ring
# bodies stamp the top-of-loop wait and the two-stage issue, and the
# one-stage issue at the bottom of the loop (the streaming loader's only
# stage before the streaming ring), so that the loader counts as
# "stage", not "rest".  The streaming ring splits "stage" into the wait
# and barrier at the top of a sub-tile, the copies' issue and the z-tile
# build (with its barrier); their sum is reported as "stage" too.
WAIT = "    cp_async_wait_all();\n    __syncthreads();\n"
ISSUE2 = "                                row0 + TB, next_rows);\n"
ISSUE1 = " row0 + TB, next_rows);\n    }\n"
ONE_STAGE = "    // One stage: the next copy waits"
VERIFY, LIMIT = "      // ---- verify:", "      // The limit on d²:"
END = "  if (TOPK) {\n    __syncthreads();\n    const long width"
Z_BUILD = "      build_windows(p, lay, sm, st, rows);\n      __syncthreads();\n"
STAGE = ("stage", "cascade", "verify", "rest")
SPLITS = {
    "synchronous": (STAGE, [
        ("    __syncthreads();\n    stage_rows<MODE, STREAM>(", 3, True),
        ("      // ---- cascade: alive bits", 0, True),
        (VERIFY, 1, True), (LIMIT, 2, True), (END, 3, True)]),
    "ring": (STAGE, [
        (WAIT, 3, True), (ISSUE2, 0, False), (VERIFY, 1, True),
        (LIMIT, 2, True), (ONE_STAGE, 3, True), (ISSUE1, 0, False),
        (END, 3, True)]),
    "streaming ring": (
        ("wait", "issue", "z build", "cascade", "verify", "rest"), [
            (WAIT, 5, True), (WAIT, 0, False), (ISSUE2, 1, False),
            (Z_BUILD, 2, False), (VERIFY, 3, True), (LIMIT, 4, True),
            (ONE_STAGE, 5, True), (ISSUE1, 1, False), (END, 5, True)]),
}
INIT = "  const float INF = __int_as_float(0x7f800000);\n"
BODY_END = re.compile(r"\n}\n\n// (Both forms|The range form)")


def fused_version(text: str) -> str:
    return ("streaming ring" if Z_BUILD in text else
            "ring" if "cp_async_wait_all();" in text else "synchronous")


def instrument(text: str) -> str:
    phases, marks = SPLITS[fused_version(text)]
    P = len(phases)
    text = text.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    assert text.count(INIT) == 1
    text = text.replace(INIT, INIT + f"  long long _sp[{P}] = {{0}};\n"
                        "  long long _tl = clock64();\n", 1)
    for anchor, mark, before in marks:
        assert text.count(anchor) == 1, anchor
        stamp = f"SPLIT_MARK({mark});\n"
        text = text.replace(anchor, ("  " * 3 + stamp + anchor) if before
                            else anchor + "  " * 3 + stamp)
    m = list(BODY_END.finditer(text))
    assert len(m) == 1
    i = m[0].start() + 1
    return text[:i] + FLUSH % (P - 1, P) + text[i:] + TAIL


# The level bodies (``--level``): per body, per version of that body in
# ``level_ops.cu``, the phases, the line after which the stamps start, the
# marks (anchor, mark, before the anchor?) and the line after which the
# last mark and the flush go.  Mark k closes phase k at that point.
LEVEL_SPLITS = {
    "linfit": {
        # Tiles staged in shared memory, halved one barriered step at a
        # time.
        "shared": (
            ("stage", "L-halving", "closed form", "N-halving+out"),
            "  const int tile = p.rows * n;\n",
            [("  row_sum_slices<BODY == LINFIT ? 3 : 1>(b0, b1, b2, rows * N,"
              " L, L);\n", 0, True),
             ("  row_sum_slices<BODY == LINFIT ? 3 : 1>(b0, b1, b2, rows * N,"
              " L, L);\n", 1, False),
             ("  row_sum_slices<1>(seg, nullptr, nullptr, rows, N, N);\n", 2,
              True)],
            "    p.out[row0 + r] = seg[r * N];\n"),
        # A segment per lane, shuffles.  A load's wait shows in the phase
        # of its first use, not in the one that issues it.
        "registers": (
            ("issue loads", "wait+segment sums", "closed form",
             "N-shuffles+out"),
            "  const bool live = r < per_warp && row < p.B;\n",
            [("    // ---- segment sums:", 0, True),
             ("    // ---- closed form\n", 1, True),
             ("  // ---- the row's segments:", 2, True)],
            "  if (live && s == 0) p.out[row] = v;\n"),
    },
    "words": {
        "shared": (
            ("panel", "stage+gather", "halving", "write"),
            "  float* cells = sm + word_panel_floats(N, A);\n",
            [("  stage(p.words + row0 * N, rows * N,", 0, True),
             ("  row_sum_slices<1>(cells, nullptr, nullptr, rows, N, N);\n", 1,
              True),
             ("  row_sum_slices<1>(cells, nullptr, nullptr, rows, N, N);\n", 2,
              False)],
            "      static_cast<float*>(p.out)[row] = md2;\n    }\n  }\n"),
        # A row per G lanes, shuffles.
        "registers": (
            ("table", "C9", "load+gather", "tree", "write"),
            "  constexpr int P = 32 / G;          // rows per step; G steps "
            "take 32 rows\n",
            [("  const int j = lane % G, k = lane / G;\n", 0, True),
             ("  const unsigned mask = __ballot_sync(FULL, need);\n", 1,
              False),
             ("      // ---- tree:", 2, True),
             ("      if (lane / P == st) md = t;\n", 3, False)],
            "  if (valid) write_row<PRUNE>(p, row, need, "
            "__fmul_rn(p.scale, md));\n"),
    },
    "sqdist": {
        # The block-cooperative segment body it shares with paa: the query
        # and a tile of rows staged in shared memory, all slices halved
        # together one barriered step at a time.
        "segment": (
            ("q load", "stage", "halving", "write"),
            "  const T* src = static_cast<const T*>(p.x) + row0 * n;\n",
            [("    stage(src, rows * n, [&](int e, T raw) {\n"
              "      const float d", 0, True),
             ("    row_sum_slices(b0, rows, n, n);\n", 1, True),
             ("    row_sum_slices(b0, rows, n, n);\n", 2, False)],
            "      p.out[row0 + r] = b0[r * n];\n"),
        # A row per G lanes in registers: strided loads, the in-lane tree,
        # shuffles, the rows handed to one lane each.  A load's wait shows
        # in the tree.
        "registers": (
            ("loads", "wait+in-lane tree", "shuffles+hand-off", "write"),
            "  const int rows = p.B - row0 < ROWS ? (int)(p.B - row0) : "
            "ROWS;\n",
            [("  // ---- squares and the in-lane tree", 0, True),
             ("  // ---- shuffles:", 1, True),
             ("  // ---- write:", 2, True)],
            "  if (lane < rows) p.out[row0 + lane] = d2;\n"),
    },
}
LEVEL_INIT = ("  long long _sp[6] = {0, 0, 0, 0, 0, 0};\n"
              "  long long _tl = clock64();\n")
LEVEL_FLUSH = r"""  SPLIT_MARK(%d);
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < 6; ++k) atomicAdd(&g_split[k], (unsigned long long)_sp[k]);
    atomicAdd(&g_split[7], 1ull);
  }
"""
# The sqdist register body with the other write: lane 0 of each row's
# lanes writes the row's sum where the shuffles leave it, in place of the
# hand-off of 32 rows' sums to the warp's lanes and one write of them.
HANDOFF = ("    // Row r·P + k's sum is in lane k·G; lane r·P + k takes it.\n"
           "    const float t = __shfl_sync(FULL, e[r][0], (lane % P) * G);\n"
           "    if (lane / P == r) d2 = t;\n")
LANE0_WRITE = ("    const int rr = r * P + k;\n"
               "    if (j == 0 && rr < rows) p.out[row0 + rr] = e[r][0];\n")
RUN_WRITE = "  if (lane < rows) p.out[row0 + lane] = d2;\n"


def level_versions(text: str) -> dict:
    """The version of each level body in a ``level_ops.cu``."""
    regs = "word_panel_floats" not in text
    return {"linfit": "registers" if regs else "shared",
            "words": "registers" if regs else "shared",
            "sqdist": "registers" if "sqdist_kernel" in text else "segment"}


def instrument_level(text: str) -> str:
    """``level_ops.cu`` with clock64() stamps in the linfit, word and
    sqdist bodies of its version (``LEVEL_SPLITS``)."""
    text = text.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    for body, version in level_versions(text).items():
        phases, init, marks, end = LEVEL_SPLITS[body][version]
        assert text.count(init) == 1, init
        text = text.replace(init, init + LEVEL_INIT, 1)
        for anchor, mark, before in marks:
            assert text.count(anchor) == 1, anchor
            stamp = f"  SPLIT_MARK({mark});\n"
            text = text.replace(anchor, stamp + anchor if before
                                else anchor + stamp)
        assert text.count(end) == 1, end
        text = text.replace(end, end + LEVEL_FLUSH % (len(phases) - 1))
    return text + TAIL


def lane0_write(text: str) -> str:
    """``level_ops.cu`` whose sqdist register body writes each row from
    lane 0 of its lanes (``LANE0_WRITE``)."""
    assert text.count(HANDOFF) == 1 and text.count(RUN_WRITE) == 1
    return text.replace(HANDOFF, LANE0_WRITE).replace(RUN_WRITE, "")


def build_split(side: str, pkg, source: str = "fused_query",
                transform=None, tag: str = "split") -> ctypes.CDLL:
    """Build a copy of a side's ``source`` changed by ``transform``
    (default: its ``clock64()`` stamps) under ``build/kernel_ab/``."""
    SPLIT_DIR.mkdir(parents=True, exist_ok=True)
    src = pathlib.Path(pkg.kernels.build.CSRC) / f"{source}.cu"
    cu = SPLIT_DIR / f"{side}_{source}_{tag}.cu"
    so = SPLIT_DIR / f"lib{side}_{source}_{tag}.so"
    if transform is None:
        transform = instrument_level if source == "level_ops" else instrument
    cu.write_text(transform(src.read_text()))
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


# The segment launcher's body codes, and the split of each level kind.
SEGMENT_BODIES = {"paa": 0, "linfit": 1, "sqdist": 2}
SPLIT_BODY = {"linfit": "linfit", "mindist": "words", "prune": "words",
              "sqdist": "sqdist"}
# sqdist's rows at phase 13's shape: the mean survivor count of its
# launches (chip_smoke.py's sqdist_at_survivors on serve-1M's first 16
# queries at ε 1 and 2).
SURVIVORS = 50_914


class Side:
    """One checkout's wrappers, adapting the query side to what they
    take (panels or words)."""

    def __init__(self, name, pkg):
        from importlib import import_module
        self.name, self.pkg = name, pkg
        self.fq = import_module(f"{pkg.__name__}.kernels.fused_query")
        self.ops = import_module(f"{pkg.__name__}.kernels.ops")
        self.lo = import_module(f"{pkg.__name__}.kernels.level_ops")
        # A side whose word launcher takes the query's panel (tq) or the
        # MINDIST table with the query word's offsets.
        self.panel = "tq" in inspect.signature(self.lo._word).parameters
        csrc = pathlib.Path(pkg.kernels.build.CSRC)
        self.versions = level_versions((csrc / "level_ops.cu").read_text())
        self.fused_phases = SPLITS[fused_version(
            (csrc / "fused_query.cu").read_text())][0]
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

    def use(self, lib, source="fused_query"):
        self.pkg.kernels.build._libs[source] = lib

    def level_call(self, kind, args):
        """The wrapper's whole call."""
        lo = self.lo
        fn = {"linfit": lo.linfit_residual_sq, "mindist": lo.mindist_sq,
              "prune": lo.prune_level, "sqdist": lo.sqdist,
              "paa": lo.paa}[kind]
        return lambda: fn(*args)

    def level_kernel(self, torch, kind, args):
        """The kernel launched alone, its output and query side made once
        (a launch outside the wrapper is not counted)."""
        lo = self.lo
        if kind in SEGMENT_BODIES:
            x, a = args
            body = SEGMENT_BODIES[kind]
            shape = (x.shape[0], a) if kind == "paa" else (x.shape[0],)
            out = torch.empty(shape, dtype=torch.float32, device=x.device)
            N, q = (1, a) if kind == "sqdist" else (a, None)
            return lambda: (lo._segment(body, x, N, q, out, kind), out)[1]
        if kind == "mindist":
            w, qword, n, A = args
            alive = res = None
            qres = eps = 0.0
            out = torch.empty(w.shape[0], dtype=torch.float32,
                              device=w.device)
        else:
            alive, res, w, qword, qres, eps, n, A = args
            qres, eps = float(np.float32(qres)), float(np.float32(eps))
            out = torch.empty(w.shape[0], dtype=torch.bool, device=w.device)
        prune = int(kind == "prune")
        if self.panel:
            query = (lo.query_table(qword, A, w.device),)
        else:
            query = (self.ops.mindist_table_cached(A, str(w.device)),
                     lo.query_offsets(qword, A))
        return lambda: (lo._word(prune, w, *query, n, A, alive, res, qres,
                                 eps, out, kind), out)[1]


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


def level_cases(torch, cs, engine, make_queries, make_wafer_like):
    """(label, kind, wrapper arguments) at phase 12's and 13's inputs."""
    db = make_wafer_like(cs.N_SERVE, 128, seed=0)
    index = engine.build_device_index(db, (8, 16), 10)
    queries = make_queries(db, 64, seed=1)
    del db
    x, n, A, dev = index.series, index.n, index.alphabet, index.device
    qr = engine.represent_queries(
        torch.as_tensor(queries[:1], dtype=torch.float32, device=dev),
        index.levels, A)
    ones = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    eps = 2.0
    out, alive = [], ones
    for li, N in enumerate(index.levels):
        qword = qr.words[li][0].cpu().numpy()
        qres = float(qr.residuals[li][0])
        w, r = index.words[li], index.residuals[li]
        out += [(f"8 linfit_residual_sq f32 N={N}", "linfit", (x, N)),
                (f"10 mindist_sq N={N}", "mindist", (w, qword, n, A)),
                (f"12 prune_level N={N} all alive", "prune",
                 (ones, r, w, qword, qres, eps, n, A))]
        if li:
            out.append((f"12 prune_level N={N} after N={index.levels[li - 1]}"
                        f" ({int(alive.sum())} alive)", "prune",
                        (alive, r, w, qword, qres, eps, n, A)))
        alive = ref_prune(torch, index, li, alive, qword, qres, eps)
    out.append((f"8 linfit_residual_sq bf16 N={index.levels[-1]}", "linfit",
                (x.to(torch.bfloat16), index.levels[-1])))
    # Kernel 11 at phase 12's 2^20 rows and at phase 13's survivor count
    # (the first rows of the series, one query), f32 and bf16; kernel 9,
    # which shares the segment body, at both levels.
    q = qr.q[0].contiguous()
    for rows in (x.shape[0], SURVIVORS):
        xs = x[:rows].contiguous()
        for dt in (torch.float32, torch.bfloat16):
            name = "f32" if dt == torch.float32 else "bf16"
            out.append((f"11 sqdist {name} B={rows}", "sqdist",
                        (xs.to(dt), q.to(dt))))
    for N in index.levels:
        out.append((f"9 paa f32 N={N}", "paa", (x, N)))
    return out


def ref_prune(torch, index, li, alive, qword, qres, eps):
    """The level's survivors by the change's plain version."""
    from repro_torch.kernels import level_ops, ref
    tq = level_ops.query_table(qword, index.alphabet, index.device)
    return ref.prune_level_ref(alive, index.residuals[li], index.words[li],
                               tq, float(np.float32(qres)),
                               float(np.float32(eps)), index.n)


def split_of(torch, cs, lib, fn, phases, timer=None) -> dict:
    """Run ``fn`` (launching through the stamped ``lib``) 20 times, timed
    by ``timer`` (default ``cs.device_ms``), and read each phase's share
    of the warps' summed clock64() time."""
    fn()
    torch.cuda.synchronize()
    lib.split_reset()
    t = (timer or cs.device_ms)(torch, fn, 20)
    buf = (ctypes.c_ulonglong * 8)()
    lib.split_read(buf)
    total = sum(buf[:len(phases)])
    return {"ms_instrumented": t, "cycles_per_warp": total / max(1, buf[7]),
            **{p: buf[i] / max(1, total) for i, p in enumerate(phases)}}


def run_level(torch, cs, sides, libs, opts, engine, make_queries,
              make_wafer_like, report) -> None:
    """Kernels 8-12 on both sides: outputs bit for bit, the kernel alone
    (warm and L2-cold) and the wrapper's call timed in turns, the split."""
    order = ("base", "change", "change", "base")
    # Back-to-back launches find a 32 MB input (the N = 8 words) in the
    # 50 MB L2; the "cold" turns overwrite 128 MB before each launch and
    # take that write's own time off.
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    flush_ms = cs.device_ms(torch, flush.zero_, 20)
    for label, kind, args in level_cases(torch, cs, engine, make_queries,
                                         make_wafer_like):
        for n, s in sides.items():
            s.use(libs[n], "level_ops")
        calls = {n: s.level_call(kind, args) for n, s in sides.items()}
        kerns = {n: s.level_kernel(torch, kind, args)
                 for n, s in sides.items()}
        outs = {n: [bits(torch, [calls[n]()])[0],
                    bits(torch, [kerns[n]()])[0].clone()] for n in sides}
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a in outs["base"] + outs["change"]
                   for b in outs["base"][:1])
        del outs
        turns = [(n, cs.device_ms(torch, kerns[n], 20)) for n in order]
        cold_turns = [(n, cs.device_ms(
            torch, lambda f=kerns[n]: (flush.zero_(), f()), 20) - flush_ms)
            for n in order]
        call_turns = [(n, cs.cuda_ms(torch, calls[n], 20)) for n in order]
        ms, cold_ms, call_ms = ({n: sum(t for m, t in tt if m == n) / 2
                                 for n in sides}
                                for tt in (turns, cold_turns, call_turns))
        row = {"bit_identical": same, "turns_ms": turns,
               "cold_turns_ms": cold_turns, "call_turns_ms": call_turns,
               "flush_ms": flush_ms, "base_ms": ms["base"],
               "change_ms": ms["change"], "base_cold_ms": cold_ms["base"],
               "change_cold_ms": cold_ms["change"],
               "base_call_ms": call_ms["base"],
               "change_call_ms": call_ms["change"]}
        if opts.split:
            body = SPLIT_BODY.get(kind)
            for n, s in sides.items() if body else ():
                lib = libs[f"{n}_split"]
                s.use(lib, "level_ops")
                phases = LEVEL_SPLITS[body][s.versions[body]][0]
                row[f"{n}_split"] = split_of(torch, cs, lib, kerns[n],
                                             phases)
                s.use(libs[n], "level_ops")
        report["kernels"][label] = row
        split = "".join(
            f"; {n} split " + ", ".join(
                f"{p} {100 * v:.1f}%" for p, v in row[f"{n}_split"].items()
                if p not in ("ms_instrumented", "cycles_per_warp"))
            for n in sides if f"{n}_split" in row)
        print(f"[ab] {label}: kernel base {ms['base']:.4f} ms, change "
              f"{ms['change']:.4f} ms (turns "
              + ", ".join(f"{n} {t:.4f}" for n, t in turns)
              + f"); L2 cold base {cold_ms['base']:.4f} ms, change "
              f"{cold_ms['change']:.4f} ms (turns "
              + ", ".join(f"{n} {t:.4f}" for n, t in cold_turns)
              + f"); call base {call_ms['base']:.4f} ms, change "
              f"{call_ms['change']:.4f} ms (turns "
              + ", ".join(f"{n} {t:.4f}" for n, t in call_turns)
              + f"); bit-identical {same}{split}", flush=True)
        if not same:
            raise RuntimeError(f"{label}: the outputs differ")
        if kind == "sqdist" and "change_lane0" in libs:
            row["lane0_write"] = lane0_turns(torch, cs, sides["change"], libs,
                                             kind, args, flush, flush_ms,
                                             label)


def lane0_turns(torch, cs, side, libs, kind, args, flush, flush_ms,
                label) -> dict:
    """The change's sqdist register body against its copy that writes
    each row from lane 0 of its lanes (``lane0_write``): outputs bit for
    bit, the kernel alone warm and L2-cold in turns (run, lane 0, lane 0,
    run)."""
    kerns = {}
    for arm, key in (("run", "change"), ("lane0", "change_lane0")):
        side.use(libs[key], "level_ops")
        kerns[arm] = side.level_kernel(torch, kind, args)
    outs = {}
    for arm, key in (("run", "change"), ("lane0", "change_lane0")):
        side.use(libs[key], "level_ops")
        outs[arm] = bits(torch, [kerns[arm]()])[0].clone()
    torch.cuda.synchronize()
    order = (("run", "change"), ("lane0", "change_lane0"),
             ("lane0", "change_lane0"), ("run", "change"))

    def turns(cold):
        out = []
        for arm, key in order:
            side.use(libs[key], "level_ops")
            f = kerns[arm]
            out.append((arm, cs.device_ms(torch, lambda: (flush.zero_(), f())
                                          if cold else f(), 20)
                        - (flush_ms if cold else 0.0)))
        return out
    warm, cold = turns(False), turns(True)
    side.use(libs["change"], "level_ops")
    same = torch.equal(outs["run"], outs["lane0"])
    row = {"bit_identical": same, "turns_ms": warm, "cold_turns_ms": cold,
           **{f"{a}_ms": sum(t for m, t in warm if m == a) / 2
              for a in ("run", "lane0")},
           **{f"{a}_cold_ms": sum(t for m, t in cold if m == a) / 2
              for a in ("run", "lane0")}}
    print(f"[ab] {label}, the change's write: by hand-off "
          f"{row['run_ms']:.4f} ms (cold "
          f"{row['run_cold_ms']:.4f}), by lane 0 {row['lane0_ms']:.4f} ms "
          f"(cold {row['lane0_cold_ms']:.4f}); bit-identical {same}",
          flush=True)
    if not same:
        raise RuntimeError("the lane-0 write differs")
    return row


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
    ap.add_argument("--level", action="store_true",
                    help="the per-level kernels 8-12 "
                         "(csrc/level_ops.cu) instead of the fused ones")
    opts = ap.parse_args()
    source = "level_ops" if opts.level else "fused_query"
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
            name, lambda b=b: (b.build([source]), b.load(source))[1])))
        if opts.split:
            jobs.append(threading.Thread(target=job, args=(
                f"{name}_split", lambda n=name, s=side: build_split(
                    n, s.pkg, source))))
        if (opts.level and name == "change"
                and side.versions["sqdist"] == "registers"):
            jobs.append(threading.Thread(target=job, args=(
                f"{name}_lane0", lambda n=name, s=side: build_split(
                    n, s.pkg, source, lane0_write, "lane0"))))
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
              "ptxas": {n: s.pkg.kernels.build.BUILD_INFO[source]["log"]
                        for n, s in sides.items()}}
    summary = cs.level_ptxas_summary if opts.level else cs.ptxas_summary
    for name, side in sides.items():
        for line in summary(report["ptxas"][name]):
            print(f"[ptxas] {name}: {line}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    if opts.level:
        try:
            run_level(torch, cs, sides, libs, opts, engine, make_queries,
                      make_wafer_like, report)
        finally:
            (out / "kernel_ab_level.json").write_text(
                json.dumps(report, indent=1))
        return 0

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
                sp = split_of(torch, cs, lib, fns[n], s.fused_phases,
                              cs.cuda_ms)
                if "stage" not in sp:
                    sp["stage"] = sp["wait"] + sp["issue"] + sp["z build"]
                row[f"{n}_split"] = sp
                s.use(libs[n])
        report["kernels"][label] = row
        split = "".join(
            f"; {n} split " + ", ".join(
                f"{p} {100 * v:.1f}%" for p, v in row[f"{n}_split"].items()
                if p not in ("ms_instrumented", "cycles_per_warp"))
            for n in sides if opts.split)
        print(f"[ab] {label}: base {ms['base']:.4f} ms, change "
              f"{ms['change']:.4f} ms (turns "
              + ", ".join(f"{n} {t:.4f}" for n, t in turns)
              + f"); bit-identical {same}{split}", flush=True)
        if not same:
            raise RuntimeError(f"{label}: the outputs differ")
    name = f"kernel_ab_{opts.rows}.json" if opts.rows else "kernel_ab.json"
    (out / name).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
