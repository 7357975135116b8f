"""Support for the fused kernels: the MINDIST panels and the tile chooser.

Counterpart of ``repro/kernels/ops.py``.  The reference sized its blocks
against 16 MiB of TPU VMEM; here the budget is the 227 KB of shared
memory a Hopper thread block may use, and the layout whose size is
reckoned is the one ``csrc/fused_query.cu`` stages (``Layout`` there —
:func:`fused_smem_bytes` mirrors its arithmetic).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import cost_model
from ..core.sax import mindist_table

SMEM_BYTES = cost_model.SMEM_PER_SM
ROW_TILE = 64                       # rows a kernel sub-tile stages
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


def fused_smem_bytes(block_q: int, n: int, levels, alphabet: int,
                     Q: int = 0, k_sel: int = 0) -> int:
    """Dynamic shared memory of one thread block of the fused kernel
    (``k_sel > 0``: the top-k form, whose per-query lists for all Q
    queries of the launch stay resident)."""
    levels = tuple(int(N) for N in levels)
    L, T = len(levels), ROW_TILE
    words = _r4(T * (n | 1)) + _r4(T) + _r4(L * T)
    words += sum(_r4(T * (N | 1)) for N in levels)
    words += _r4(n * block_q) + 3 * _r4(block_q) + _r4(L * block_q)
    words += sum(_r4(block_q * N * alphabet) for N in levels)
    if k_sel:
        words += _r4(block_q * T) + 2 * _r4(Q * k_sel)
    return 4 * words


def choose_fused_blocks(Q: int, B: int, n: int, levels, alphabet: int,
                        k_sel: int = 0, smem: int = SMEM_BYTES):
    """Pick ``(block_q, block_b)`` for a fused pass.

    Feasible shapes fit ``smem``; among them the cheapest under
    ``core/cost_model.fused_pass_estimate`` wins (its memory term, the
    top-k re-verify gather that grows with the number of blocks, and the
    wave efficiency of the blocks over the SMs).  Raises if nothing fits.
    """
    best = None
    for bq in FUSED_BLOCK_Q:
        for bb in FUSED_BLOCK_B:
            if k_sel > bb:
                continue
            need = fused_smem_bytes(bq, n, levels, alphabet, Q, k_sel)
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
