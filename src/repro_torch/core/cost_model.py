"""Cost models: the paper's latency-time op counts, and the H100 device
model of the fused kernels.

Counterpart of ``repro/core/cost_model.py``.

**Latency time** (paper §4, after Schulte et al. 2005): the paper compares
SAX and FAST_SAX by weighting every arithmetic operation by its hardware
latency and summing.  The paper does not print its weight table, so the
reference makes its own explicit, and the port keeps it:

    CMP / ADD / SUB / ABS / LOOKUP : 1
    MUL                            : 1   (fused multiply-add era)
    DIV                            : 4
    SQRT                           : 8

:class:`OpCounter` accumulates the integer counts the host engines of
``core/search.py`` charge, from the closed-form per-operation costs below,
so the port's counts and latencies equal the reference's exactly.

**The device model**: the fused-pass and streaming-subsequence-pass
latency estimates the tile choosers (``kernels/ops.py``) rank shapes
with, and the top-k demotion rule.  Its constants are the H100 SXM data
sheet's: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor
cores (the verify is plain f32 FMAs), 132 SMs.  The model only has to
order tile shapes; the pass reads far fewer bytes per FLOP than the
card's ridge point, so the memory term and the wave quantisation of
thread blocks over the SMs decide it.
"""
from __future__ import annotations

import dataclasses
import math

_OPS = ("cmp", "add", "sub", "abs", "mul", "div", "sqrt", "lookup")


@dataclasses.dataclass(frozen=True)
class OpWeights:
    cmp: float = 1.0
    add: float = 1.0
    sub: float = 1.0
    abs: float = 1.0
    mul: float = 1.0
    div: float = 4.0
    sqrt: float = 8.0
    lookup: float = 1.0


DEFAULT_WEIGHTS = OpWeights()


@dataclasses.dataclass
class OpCounter:
    """Accumulates raw op counts; ``latency()`` applies the weight table."""

    weights: OpWeights = DEFAULT_WEIGHTS
    cmp: int = 0
    add: int = 0
    sub: int = 0
    abs: int = 0
    mul: int = 0
    div: int = 0
    sqrt: int = 0
    lookup: int = 0

    def count(self, **ops: int) -> None:
        for name, k in ops.items():
            setattr(self, name, getattr(self, name) + int(k))

    def latency(self) -> float:
        # The reference's summation order, so the float is the same.
        w = self.weights
        return (
            self.cmp * w.cmp
            + self.add * w.add
            + self.sub * w.sub
            + self.abs * w.abs
            + self.mul * w.mul
            + self.div * w.div
            + self.sqrt * w.sqrt
            + self.lookup * w.lookup
        )

    def total_ops(self) -> int:
        return sum(getattr(self, f) for f in _OPS)

    def merge(self, other: "OpCounter") -> None:
        for f in _OPS:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in _OPS}


# Closed-form op counts of the primitive computations both host engines
# charge (``core/search.py``).


def euclidean_cost(n: int) -> dict:
    """Full Euclidean distance between two length-n series + threshold test."""
    return dict(sub=n, mul=n, add=n - 1, sqrt=1, cmp=1)


def mindist_cost(N: int) -> dict:
    """MINDIST between two N-symbol words + threshold test (eq. 3): per
    symbol pair one lookup and one square; then N−1 adds, the sqrt(n/N)
    scale (one mul after a cached sqrt), one sqrt, one compare."""
    return dict(lookup=N, mul=N + 1, add=N - 1, sqrt=1, cmp=1)


def c9_cost() -> dict:
    """FAST_SAX's first exclusion condition |d(u,ū) − d(q,q̄)| > ε (eq. 9)."""
    return dict(sub=1, abs=1, cmp=1)


def paa_cost(n: int, N: int) -> dict:
    """PAA of a length-n series into N segments (query side, online)."""
    return dict(add=n - N, mul=N)  # segment sums + scale by 1/L


def discretize_cost(N: int, alphabet: int) -> dict:
    """Binary-search discretisation of N PAA values over α−1 breakpoints."""
    return dict(cmp=N * max(1, math.ceil(math.log2(max(2, alphabet)))))


def residual_gap_cost() -> dict:
    """|d(u,ū) − d(q,q̄)| as a lower bound, without the threshold test
    (what the k-NN seed phase computes per series)."""
    return dict(sub=1, abs=1)


def heap_push_cost(k: int) -> dict:
    """One sift of a size-k binary heap (the k-NN best-so-far)."""
    return dict(cmp=max(1, math.ceil(math.log2(max(2, k + 1)))))


def select_cost(m: int, k: int) -> dict:
    """Heap-select the k smallest of m values: one compare per value plus
    a sift charged for all m (the accounting must never undercount)."""
    lg = max(1, math.ceil(math.log2(max(2, k + 1))))
    return dict(cmp=m + m * lg)


def sort_cost(m: int) -> dict:
    """Comparison sort of m keys (candidate ordering before verification)."""
    if m <= 1:
        return dict(cmp=0)
    return dict(cmp=m * max(1, math.ceil(math.log2(m))))


def linfit_residual_cost(n: int, N: int) -> dict:
    """Closed-form per-segment first-degree LS residual of the query: per
    segment Σy, Σxc·y, Σy², then the constant combination."""
    return dict(add=3 * n, mul=2 * n + 6 * N, div=N, sqrt=1)


def latency_of(cost: dict, weights: OpWeights = DEFAULT_WEIGHTS) -> float:
    """Weighted latency time of one closed-form op-count dict."""
    return float(sum(int(k) * getattr(weights, name)
                     for name, k in cost.items()))


def c10_skip_advised(kill_frac: float, n: int, N: int,
                     weights: OpWeights = DEFAULT_WEIGHTS) -> bool:
    """True when a level's MINDIST test is expected to cost more than the
    verifications its exclusions would save: per C9 survivor it costs
    ``mindist_cost(N)`` and an exclusion saves ``euclidean_cost(n)``;
    skip when ``kill_frac · gain < cost``.  Skipping is always sound."""
    gain = float(kill_frac) * latency_of(euclidean_cost(n), weights)
    return gain < latency_of(mindist_cost(N), weights)


def level_enable_advised(kill_frac: float, n: int, exclude_cost: dict,
                         weights: OpWeights = DEFAULT_WEIGHTS) -> bool:
    """Should a registered extra representation level be enabled?  It
    costs ``exclude_cost`` per surviving candidate and saves one
    ``euclidean_cost(n)`` per exclusion: enable when ``kill_frac · gain >
    cost``.  Either answer is sound."""
    gain = float(kill_frac) * latency_of(euclidean_cost(n), weights)
    return gain > latency_of(exclude_cost, weights)


# ---------------------------------------------------------------------------
# The H100 device model.
# ---------------------------------------------------------------------------

HBM_GBPS = 3350.0         # H100 SXM HBM3 bandwidth
F32_TFLOPS = 67.0         # H100 SXM float32, non-tensor
N_SMS = 132               # H100 SXM streaming multiprocessors
SMEM_PER_SM = 232448      # shared memory a block may use (227 KB)
MAX_BLOCKS_PER_SM = 8     # 2048 resident threads / 256-thread blocks
# The fused kernels are compiled for two resident blocks per SM
# (``__launch_bounds__(256, 2)``: up to 128 registers a thread), so a
# smaller layout (the quantized ring, a streaming range tile) buys no
# third block.
FUSED_MAX_BLOCKS_PER_SM = 2

# The reference demotes a fused k-NN whose in-kernel selection would keep
# more than this many slots (k + guard) to the dense engine, because its
# Pallas selection unrolls one sweep per slot.  The CUDA selection has no
# unroll: one warp per query merges each 64-row sub-tile's candidates into
# the query's sorted list in shared memory by rank (a binary search and
# one warp broadcast per candidate), so its cost follows the candidates,
# not k_sel; its limit is the lists' shared memory,
# ``kernels.fused_query.KSEL_MAX`` slots.  The rule is kept so that
# serving takes the same engine as the reference at every k.
TOPK_DEMOTE_KSEL = 100


def topk_demote_advised(k_sel: int) -> bool:
    """True when a fused k-NN keeping ``k_sel`` slots per block should run
    on the torch engine instead.  Demotion never changes answers."""
    return int(k_sel) > TOPK_DEMOTE_KSEL


def blocks_per_sm(smem_bytes: int) -> int:
    """Resident thread blocks per SM for a block using ``smem_bytes``
    (1 KB per block is reserved by the hardware)."""
    return max(1, min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem_bytes + 1024)))


def fused_blocks_per_sm(smem_bytes: int) -> int:
    """Resident thread blocks per SM of a fused kernel using
    ``smem_bytes``: :func:`blocks_per_sm`, at most the two its launch
    bounds give."""
    return min(FUSED_MAX_BLOCKS_PER_SM, blocks_per_sm(smem_bytes))


def fused_pass_estimate(Q: int, B: int, n: int, levels, alphabet: int,
                        block_q: int = 32, block_b: int = 1024, k: int = 0,
                        smem_bytes: int = 96 * 1024) -> dict:
    """Bytes / FLOPs / latency estimate of one fused pass.

    The database (series, norms, words and residuals of every level) is
    charged one HBM read; the query side (each query's row, ε, residuals
    and words, and the α × α MINDIST table) is re-read from L2 by every
    thread block (charged as HBM, conservatively); the outputs are the
    (Q, B) mask and d² (range form) or the (Q, nb·k) partials plus the
    engine's re-verify gather of (Q, nb·k, n) rows (top-k form).  The
    memory time is divided by the wave efficiency of ``nb`` blocks over
    the SMs.  Returns ``dict(bytes_hbm, flops, t_mem_s, t_compute_s,
    t_est_s)``.
    """
    levels = tuple(int(N) for N in levels)
    nb = math.ceil(B / max(1, block_b))
    row_bytes = (n + 1 + sum(levels) + len(levels)) * 4
    q_row_bytes = (n + 2 + len(levels) + sum(levels)) * 4
    bytes_hbm = B * row_bytes + nb * (Q * q_row_bytes + alphabet ** 2 * 4)
    if k:
        bytes_hbm += Q * nb * k * (8 + 2 * n * 4)
    else:
        bytes_hbm += Q * B * 5
    flops = 2.0 * Q * B * n + float(Q * B) * (sum(levels) * 2 + 8)
    slots = N_SMS * fused_blocks_per_sm(smem_bytes)
    waves = math.ceil(nb / slots)
    wave_eff = nb / (waves * slots)
    t_mem = bytes_hbm / (HBM_GBPS * 1e9) / wave_eff
    t_compute = flops / (F32_TFLOPS * 1e12) / wave_eff
    return dict(bytes_hbm=float(bytes_hbm), flops=flops, t_mem_s=t_mem,
                t_compute_s=t_compute, t_est_s=max(t_mem, t_compute))


def subseq_pass_estimate(Q: int, n_windows: int, window: int, stride: int,
                         levels, alphabet: int, block_q: int = 32,
                         block_w: int = 1024, k: int = 0,
                         smem_bytes: int = 96 * 1024) -> dict:
    """Bytes / FLOPs / latency estimate of one streaming subsequence pass
    (``kernels/fused_query.fused_subseq_range`` / ``_topk``).

    The database side of each thread block is its stream range of
    ``(block_w − 1)·stride + window`` samples plus the per-window
    metadata (μ, σ, norms, words, residuals) — not the ``block_w ×
    window`` materialised windows, which exist only in shared memory.
    The rest is charged as in :func:`fused_pass_estimate` (the top-k
    form's re-verify gather reads materialised rows).  Returns the keys
    of :func:`fused_pass_estimate`."""
    levels = tuple(int(N) for N in levels)
    nb = math.ceil(n_windows / max(1, block_w))
    seg_len = (block_w - 1) * stride + window
    meta_row = (3 + sum(levels) + len(levels)) * 4
    q_row_bytes = (window + 2 + len(levels) + sum(levels)) * 4
    rest = nb * (Q * q_row_bytes + alphabet ** 2 * 4)
    if k:
        rest += Q * nb * k * (8 + 2 * window * 4)
    else:
        rest += Q * n_windows * 5
    bytes_hbm = nb * seg_len * 4 + n_windows * meta_row + rest
    flops = 2.0 * Q * n_windows * window + float(Q * n_windows) * (
        sum(levels) * 2 + 8) + 2.0 * n_windows * window
    slots = N_SMS * fused_blocks_per_sm(smem_bytes)
    waves = math.ceil(nb / slots)
    wave_eff = nb / (waves * slots)
    t_mem = bytes_hbm / (HBM_GBPS * 1e9) / wave_eff
    t_compute = flops / (F32_TFLOPS * 1e12) / wave_eff
    return dict(bytes_hbm=float(bytes_hbm), flops=flops, t_mem_s=t_mem,
                t_compute_s=t_compute, t_est_s=max(t_mem, t_compute))


def compact_step_bytes(tile_counts, B: int, tile: int, C: int) -> int:
    """The least bytes the compaction of a dense (Q, B) answer pair moves
    (``compact_count`` then ``compact_write``, ``kernels/csrc/
    fused_query.cu``), from the count's (Q, ⌈B/tile⌉) ``tile_counts`` on
    the host: the mask read once; the tiles' counts written, then read
    back; the row counts read to the host; the tiles that hold answers
    read again, with the d² at each answer; Q·C ids and d² written."""
    rows = [list(map(int, r)) for r in tile_counts]
    Q, T = len(rows), len(rows[0]) if rows else 0
    last = B - (T - 1) * tile
    reread = sum((last if t == T - 1 else tile)
                 for r in rows for t, c in enumerate(r) if c)
    answers = sum(map(sum, rows))
    return Q * B + 2 * Q * T * 4 + Q * 4 + reread + answers * 4 + Q * C * 8
