"""Support for the fused kernels: the MINDIST panels and the tile chooser.

Counterpart of ``repro/kernels/ops.py``.  The reference sized its blocks
against 16 MiB of TPU VMEM; here the budget is the 227 KB of shared
memory a Hopper thread block may use, and the layout whose size is
reckoned is the one ``csrc/fused_query.cu`` stages (``Layout`` there —
:func:`fused_smem_bytes` and :func:`subseq_smem_bytes` mirror its
arithmetic).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import cost_model
from ..core.sax import mindist_table

SMEM_BYTES = cost_model.SMEM_PER_SM
ROW_TILE = 64                       # rows a kernel sub-tile stages
SEG_MAX = 8192                      # longest staged stream range (floats)
# block_b: rows per thread block, and the top-k partial-list granularity
# (the (Q, nb·k_sel) output layout the engine's certificate reads).
FUSED_BLOCK_B = (4096, 2048, 1024, 512, 256, 128, 64)
# block_q: queries staged in shared memory at a time.
FUSED_BLOCK_Q = (32, 16)


@functools.lru_cache(maxsize=None)
def _mindist_table_np(alphabet: int) -> np.ndarray:
    return np.ascontiguousarray(mindist_table(alphabet), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def mindist_table_cached(alphabet: int, device: str) -> torch.Tensor:
    """(α, α) float32 MINDIST cell table, one tensor per (alphabet,
    device).  Callers must not modify it."""
    return torch.as_tensor(_mindist_table_np(alphabet), device=device)


def query_panels(qwords: torch.Tensor, alphabet: int) -> torch.Tensor:
    """(Q, N) query words -> (Q, α, N) panels, ``panels[q, a, i] =
    tab[a, qwords[q, i]]``."""
    tab = mindist_table_cached(alphabet, str(qwords.device))
    return tab[:, qwords.long()].permute(1, 0, 2).contiguous()


def _r4(x: int) -> int:
    return (x + 3) // 4 * 4


def _smem_bytes(block_q: int, n: int, levels, alphabet: int, Q: int,
                k_sel: int, qseries: bool, qmeta: bool, seg_cap: int) -> int:
    """The arithmetic of the kernel's ``Layout`` (``csrc/fused_query.cu``)."""
    levels = tuple(int(N) for N in levels)
    L, T = len(levels), ROW_TILE
    words = _r4(T * (n | 1)) + _r4(T) + _r4(L * T)
    if qseries:
        words += _r4(T)
    if qmeta:
        words += _r4(L * T)
    words += sum(_r4(T * (N | 1)) for N in levels)
    words += _r4(n * block_q) + 3 * _r4(block_q) + _r4(L * block_q)
    words += sum(_r4(block_q * N * alphabet) for N in levels)
    if k_sel:
        words += _r4(block_q * T) + 2 * _r4(Q * k_sel)
    if seg_cap:
        # The streaming loader's sections share the top-k candidates'
        # space when they fit.
        need = 3 * _r4(T) + _r4(seg_cap)
        if not (k_sel and need <= _r4(block_q * T)):
            words += need
    return 4 * words


def fused_smem_bytes(block_q: int, n: int, levels, alphabet: int,
                     Q: int = 0, k_sel: int = 0, quant: bool = False) -> int:
    """Dynamic shared memory of one thread block of the fused kernel
    (``k_sel > 0``: the top-k form, whose per-query lists for all Q
    queries of the launch stay resident; ``quant``: the quantized tier's
    form, which also stages each row's series error and each level's
    residual error beside the dequantized f32 tile)."""
    return _smem_bytes(block_q, n, levels, alphabet, Q, k_sel, quant, quant,
                       0)


def subseq_seg_cap(window: int, stride: int) -> int:
    """Longest stream range (floats) the streaming loader stages for a
    64-window sub-tile: one stream boundary's worth, ``63·stride + 2·w``,
    capped at ``SEG_MAX`` (csrc ``subseq_seg_cap``)."""
    return min((ROW_TILE - 1) * int(stride) + 2 * int(window), SEG_MAX)


def subseq_smem_bytes(block_q: int, window: int, stride: int, levels,
                      alphabet: int, Q: int = 0, k_sel: int = 0,
                      quant: bool = False) -> int:
    """Dynamic shared memory of one thread block of the streaming
    subsequence kernel: the fused layout over rows of length ``window``
    (``quant``: quantized screen columns, whose residual errors are
    staged; the series is raw) plus each sub-tile's window starts, μ, σ
    and staged stream range."""
    return _smem_bytes(block_q, window, levels, alphabet, Q, k_sel, False,
                       quant, subseq_seg_cap(window, stride))


def choose_fused_blocks(Q: int, B: int, n: int, levels, alphabet: int,
                        k_sel: int = 0, smem: int = SMEM_BYTES,
                        quant: bool = False):
    """Pick ``(block_q, block_b)`` for a fused pass (``quant``: over the
    quantized tier).

    Feasible shapes fit ``smem``; among them the cheapest under
    ``core/cost_model.fused_pass_estimate`` wins (its memory term, the
    top-k re-verify gather that grows with the number of blocks, and the
    wave efficiency of the blocks over the SMs).  The estimate charges the
    full-precision row bytes, an upper bound on the quantized tier's, as
    the reference's chooser does.  Raises if nothing fits.
    """
    best = None
    for bq in FUSED_BLOCK_Q:
        for bb in FUSED_BLOCK_B:
            if k_sel > bb:
                continue
            need = fused_smem_bytes(bq, n, levels, alphabet, Q, k_sel, quant)
            if need > smem:
                continue
            est = cost_model.fused_pass_estimate(
                Q, B, n, levels, alphabet, block_q=bq, block_b=bb, k=k_sel,
                smem_bytes=need)
            if best is None or est["t_est_s"] < best[0]:
                best = (est["t_est_s"], bq, bb)
    if best is None:
        raise ValueError(
            f"no fused tile fits {smem} bytes of shared memory for n={n}, "
            f"levels={tuple(levels)}, alphabet={alphabet}, Q={Q}, "
            f"k_sel={k_sel}")
    return best[1], best[2]


def choose_subseq_blocks(Q: int, n_windows: int, window: int, stride: int,
                         levels, alphabet: int, k: int = 0,
                         smem: int = SMEM_BYTES, quant: bool = False):
    """Pick ``(block_q, block_w)`` for a streaming subsequence pass
    (``block_w``: windows per thread block and the top-k partial-list
    granularity, ``k``: the top-k form's k_sel): the feasible shape the
    cheapest under ``core/cost_model.subseq_pass_estimate``.  Raises if
    nothing fits."""
    best = None
    for bq in FUSED_BLOCK_Q:
        need = subseq_smem_bytes(bq, window, stride, levels, alphabet, Q, k,
                                 quant)
        if need > smem:
            continue
        for bw in FUSED_BLOCK_B:
            if k > bw:
                continue
            est = cost_model.subseq_pass_estimate(
                Q, n_windows, window, stride, levels, alphabet, block_q=bq,
                block_w=bw, k=k, smem_bytes=need)
            if best is None or est["t_est_s"] < best[0]:
                best = (est["t_est_s"], bq, bw)
    if best is None:
        raise ValueError(
            f"no subseq tile fits {smem} bytes of shared memory for "
            f"window={window}, stride={stride}, levels={tuple(levels)}, "
            f"alphabet={alphabet}, Q={Q}, k_sel={k}")
    return best[1], best[2]
