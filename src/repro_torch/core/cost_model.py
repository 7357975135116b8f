"""Device cost model of the fused kernels on an NVIDIA H100.

Counterpart of the device half of ``repro/core/cost_model.py``: the
fused-pass and streaming-subsequence-pass latency estimates the tile
choosers (``kernels/ops.py``) rank shapes with, and the top-k demotion
rule.  The reference's paper
op-count model (``OpCounter`` and the per-operation costs) is not ported
yet (ROADMAP.md, queue 1).

The constants are the H100 SXM data sheet's: 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores (the verify is plain f32
FMAs), 132 SMs.  The model only has to order tile shapes; the pass reads
far fewer bytes per FLOP than the card's ridge point, so the memory term
and the wave quantisation of thread blocks over the SMs decide it.
"""
from __future__ import annotations

import math

HBM_GBPS = 3350.0         # H100 SXM HBM3 bandwidth
F32_TFLOPS = 67.0         # H100 SXM float32, non-tensor
N_SMS = 132               # H100 SXM streaming multiprocessors
SMEM_PER_SM = 232448      # shared memory a block may use (227 KB)
MAX_BLOCKS_PER_SM = 8     # 2048 resident threads / 256-thread blocks

# The reference demotes a fused k-NN whose in-kernel selection would keep
# more than this many slots (k + guard) to the dense engine, because its
# Pallas selection unrolls one sweep per slot.  The CUDA selection keeps
# each query's sorted list in shared memory and has no unroll; its own
# limit is ``kernels.fused_query.KSEL_MAX``.  The rule is kept so that
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


def fused_pass_estimate(Q: int, B: int, n: int, levels, alphabet: int,
                        block_q: int = 32, block_b: int = 1024, k: int = 0,
                        smem_bytes: int = 96 * 1024) -> dict:
    """Bytes / FLOPs / latency estimate of one fused pass.

    The database (series, norms, words and residuals of every level) is
    charged one HBM read; the query side is re-read from L2 by every
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
    q_row_bytes = (n + 2 + len(levels) + alphabet * sum(levels)) * 4
    bytes_hbm = B * row_bytes + nb * Q * q_row_bytes
    if k:
        bytes_hbm += Q * nb * k * (8 + 2 * n * 4)
    else:
        bytes_hbm += Q * B * 5
    flops = 2.0 * Q * B * n + float(Q * B) * (sum(levels) * 2 + 8)
    slots = N_SMS * blocks_per_sm(smem_bytes)
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
    q_row_bytes = (window + 2 + len(levels) + alphabet * sum(levels)) * 4
    rest = nb * Q * q_row_bytes
    if k:
        rest += Q * nb * k * (8 + 2 * window * 4)
    else:
        rest += Q * n_windows * 5
    bytes_hbm = nb * seg_len * 4 + n_windows * meta_row + rest
    flops = 2.0 * Q * n_windows * window + float(Q * n_windows) * (
        sum(levels) * 2 + 8) + 2.0 * n_windows * window
    slots = N_SMS * blocks_per_sm(smem_bytes)
    waves = math.ceil(nb / slots)
    wave_eff = nb / (waves * slots)
    t_mem = bytes_hbm / (HBM_GBPS * 1e9) / wave_eff
    t_compute = flops / (F32_TFLOPS * 1e12) / wave_eff
    return dict(bytes_hbm=float(bytes_hbm), flops=flops, t_mem_s=t_mem,
                t_compute_s=t_compute, t_est_s=max(t_mem, t_compute))
