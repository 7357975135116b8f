"""Support for the fused kernels: the MINDIST table and panels, the shared
memory layout and the tile chooser.

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
    tab[a, qwords[q, i]]``.  The plain versions take the panels; the CUDA
    kernels stage the (α, α) table and the query words instead and read
    this cell as ``tabT[qwords[q, i]·α + a]`` of the transposed table."""
    tab = mindist_table_cached(alphabet, str(qwords.device))
    return tab[:, qwords.long()].permute(1, 0, 2).contiguous()


def _al16(x: int) -> int:
    return (x + 15) // 16 * 16


def _al128(x: int) -> int:
    return (x + 127) // 128 * 128


# Bytes per element the kernel stages per quantized mode (None: full
# precision): the series codes and the residual codes.
_ELEM_BYTES = {None: 4, "int8": 1, "bf16": 2}


def _smem_bytes(block_q: int, n: int, levels, alphabet: int, Q: int,
                k_sel: int, quant, stream: bool, seg_cap: int,
                stages: int) -> int:
    """The arithmetic of the kernel's ``Layout`` (``csrc/fused_query.cu``),
    in bytes: ``stages`` ring stages of one sub-tile's columns as stored
    (``stream``: with μ, σ, the window starts and ``seg_cap`` floats of
    stream range in place of the rows, and the f32 z tile after the
    ring), then the query side and the top-k lists.  ``quant``: None (or
    False) for full precision, else the tier's mode."""
    mode = quant or None
    if mode not in _ELEM_BYTES:
        raise ValueError(f"quant must be None, 'int8' or 'bf16', got "
                         f"{quant!r}")
    levels = tuple(int(N) for N in levels)
    L, T = len(levels), ROW_TILE
    elem = _ELEM_BYTES[mode]
    word = 4 if mode is None else 1
    stage = T * 4                                   # norms
    if mode is not None and not stream:
        stage += T * 4                              # series errors
        if mode == "int8":
            stage += 2 * T * 4                      # scales and zeros
    stage += L * _al128(T * elem)                   # residuals
    stage += sum(_al128(T * N * word) for N in levels)
    tile = _al128(T * n * (4 if stream else elem))
    if stream:
        stage += 3 * T * 4 + _al128(seg_cap * 4)    # μ, σ, starts, range
        total = stages * stage + tile               # one z tile per block
    else:
        total = stages * (stage + tile)
    total += _al16(n * block_q * 4) + 3 * _al16(block_q * 4)
    total += _al16(L * block_q * 4) + _al16(alphabet * alphabet * 4)
    total += _al16(sum(levels) * block_q * 2)       # query words, 16 bit
    if k_sel:
        total += _al16(block_q * T * 4) + 2 * _al16(Q * k_sel * 4)
    return total


def _blocks_per_sm(smem: int) -> int:
    """Resident blocks per SM by shared memory, at most the two the
    kernels' launch bounds give."""
    return min(2, SMEM_BYTES // (smem + 1024))


def ring_stages(block_q: int, n: int, levels, alphabet: int, Q: int = 0,
                k_sel: int = 0, quant=None, seg_cap: int = 0) -> int:
    """The ring stages the kernel's launcher chooses (csrc
    ``ring_stages``): two where they keep the blocks per SM that one
    stage gives, else one (``seg_cap`` > 0: the streaming loader's
    layout, rows of length n = window)."""
    one, two = (_smem_bytes(block_q, n, levels, alphabet, Q, k_sel, quant,
                            bool(seg_cap), seg_cap, s) for s in (1, 2))
    return 2 if two <= SMEM_BYTES and \
        _blocks_per_sm(two) >= _blocks_per_sm(one) else 1


def fused_smem_bytes(block_q: int, n: int, levels, alphabet: int,
                     Q: int = 0, k_sel: int = 0, quant=None,
                     stages: int | None = None) -> int:
    """Dynamic shared memory of one thread block of the fused kernel
    (``k_sel > 0``: the top-k form, whose per-query lists for all Q
    queries of the launch stay resident; ``quant``: the quantized tier's
    mode, "int8" or "bf16", whose ring holds the codes with each row's
    series error (and int8 scale and zero)).  ``stages``: the ring's
    stages, by default :func:`ring_stages`' choice."""
    if stages is None:
        stages = ring_stages(block_q, n, levels, alphabet, Q, k_sel, quant)
    return _smem_bytes(block_q, n, levels, alphabet, Q, k_sel, quant, False,
                       0, stages)


def subseq_seg_cap(window: int, stride: int) -> int:
    """Longest stream range (floats) the streaming loader stages for a
    64-window sub-tile: one stream boundary's worth, ``63·stride + 2·w``,
    and the 3 floats of rounding its start down to 16 bytes, capped at
    ``SEG_MAX`` (csrc ``subseq_seg_cap``)."""
    return min((ROW_TILE - 1) * int(stride) + 2 * int(window) + 3, SEG_MAX)


def subseq_smem_bytes(block_q: int, window: int, stride: int, levels,
                      alphabet: int, Q: int = 0, k_sel: int = 0,
                      quant=None, stages: int | None = None) -> int:
    """Dynamic shared memory of one thread block of the streaming
    subsequence kernel: ``stages`` ring stages of a sub-tile's screen
    columns (``quant``: their quantized mode), μ, σ, window starts and
    stream range, then the f32 z tile of rows of length ``window`` and
    the query side.  ``stages``: by default :func:`ring_stages`'
    choice."""
    seg_cap = subseq_seg_cap(window, stride)
    if stages is None:
        stages = ring_stages(block_q, window, levels, alphabet, Q, k_sel,
                             quant, seg_cap)
    return _smem_bytes(block_q, window, levels, alphabet, Q, k_sel, quant,
                       True, seg_cap, stages)


def choose_fused_blocks(Q: int, B: int, n: int, levels, alphabet: int,
                        k_sel: int = 0, smem: int = SMEM_BYTES, quant=None):
    """Pick ``(block_q, block_b)`` for a fused pass (``quant``: over the
    quantized tier of that mode).

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
                         smem: int = SMEM_BYTES, quant=None):
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
