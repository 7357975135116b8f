"""Plain PyTorch versions of every CUDA kernel and of the top-k merge.

Counterpart of ``repro/kernels/ref.py``: the fused whole-series,
quantized and streaming subsequence forms and the compaction of a dense
answer (``csrc/fused_query.cu``) and the per-level operations
(``csrc/level_ops.cu``: ``paa_ref``,
``linfit_residual_sq_ref``, ``mindist_sq_level_ref``, ``sqdist_ref``,
``prune_level_ref``).  Each function computes what its kernel computes:
the wrappers in ``fused_query.py`` and ``level_ops.py`` run these on CPU
tensors, and ``chip_smoke.py`` holds the kernels against them on the card.
The per-level forms sum in ``core/paa.row_sum``'s fixed order, as the
engine's device build does, so their kernels equal them bit for bit.
They spend memory freely — the (Q, B, N) MINDIST gather and a dense
(Q, B) verify — which is fine for tests and checks, not for serving.

The quantized forms are the reference's XLA oracle of the tiered screen
(``repro/core/engine.py::quantized_cascade_mask`` and
``quantized_screen``); the port's engine uses them as its own oracle.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.paa import paa, row_sum
from ..core.polyfit import linfit_residual_sq
from ..index.quantized import PAD_RESIDUAL, RESID_BLOCK, SENTINEL_CODE

INT32_MAX = 2 ** 31 - 1
# f32 slack on the widened series screen's radius: d(û, q) is taken in
# f32 while the stored error e_u was computed against the f64 source.
# Widening only adds survivors.  The CUDA kernel uses the same constants.
QUANT_SCREEN_REL = 1e-6
QUANT_SCREEN_ABS = 1e-6


def mindist_sq_ref(words, q_panels, N: int, n: int) -> torch.Tensor:
    """(Q, B) C10 bound ``(n/N)·Σᵢ panel[q, wᵢ, i]²`` by gather from the
    (Q, α, N) panels; ``words`` (B, N) of any integer type."""
    Q, A, _ = q_panels.shape
    B = words.shape[0]
    flat = words.long() * N + torch.arange(N, device=words.device)[None, :]
    cell = torch.gather(q_panels.reshape(Q, A * N), 1,
                        flat.reshape(1, B * N).expand(Q, B * N))
    cell = cell.reshape(Q, B, N)
    return float(n // N) * torch.sum(cell * cell, dim=-1)


def cascade_alive_ref(words, residuals, q_panels, q_residuals, eps, levels,
                      n: int) -> torch.Tensor:
    """(Q, B) alive mask of the exclusion cascade: at every level C9
    ``|res − qres| ≤ ε`` and C10 ``(n/N)·Σᵢ panel[q, wᵢ, i]² ≤ ε²``.
    ``eps`` is (Q,) float32; ε² is taken in float32."""
    eps_c = eps.reshape(-1, 1)
    eps2 = eps_c * eps_c
    alive = None
    for li, N in enumerate(levels):
        gap = torch.abs(residuals[li][None, :] - q_residuals[li][:, None])
        ok = gap <= eps_c
        alive = ok if alive is None else alive & ok
        alive &= mindist_sq_ref(words[li], q_panels[li], N, n) <= eps2
    return alive


def cross_rows(q, series) -> torch.Tensor:
    """(Q, B) dot products q·u, one matrix-vector product per query: a
    matrix product would let the library pick its summation order by Q,
    and a query served in a batch must get the distances it gets alone."""
    return torch.stack([series @ qi for qi in q])


def verify_d2_ref(q, series, norms_sq) -> torch.Tensor:
    """(Q, B) squared distances in the engine's matmul form,
    max(‖q‖² − 2·q·u + ‖u‖², 0)."""
    qn = torch.sum(q * q, dim=-1)
    cross = cross_rows(q, series)
    return torch.clamp(qn[:, None] - 2.0 * cross + norms_sq[None, :], min=0.0)


def fused_range_ref(series, norms_sq, words, residuals, q, q_panels,
                    q_residuals, eps, levels, n: int):
    """(answers (Q, B) bool, d2 (Q, B) float32, +inf off the answers)."""
    alive = cascade_alive_ref(words, residuals, q_panels, q_residuals, eps,
                              levels, n)
    d2 = verify_d2_ref(q, series, norms_sq)
    eps_c = eps.reshape(-1, 1)
    ans = alive & (d2 <= eps_c * eps_c)
    return ans, torch.where(ans, d2, torch.full_like(d2, math.inf))


def fused_topk_ref(series, norms_sq, words, residuals, q, q_panels,
                   q_residuals, eps, levels, n: int, k: int, block_b: int):
    """Block-local top-k partials: ``(idx (Q, nb·k) int32, d2 (Q, nb·k))``.

    For every block of ``block_b`` rows, the k smallest d² among the
    cascade survivors (no ε² filter), ascending with ties to the lower
    row, +inf / −1 on empty slots."""
    alive = cascade_alive_ref(words, residuals, q_panels, q_residuals, eps,
                              levels, n)
    d2 = verify_d2_ref(q, series, norms_sq)
    return block_topk(torch.where(alive, d2, torch.full_like(d2, math.inf)),
                      k, block_b)


def block_topk(d2m, k: int, block_b: int):
    """Per block of ``block_b`` columns of (Q, B) values (+inf = not a
    candidate), the k smallest, ascending with ties to the lower column:
    ``(idx (Q, nb·k) int32, d2 (Q, nb·k))``, +inf / −1 on empty slots."""
    Q, B = d2m.shape
    nb = -(-B // block_b)
    if nb * block_b != B:
        pad = torch.full((Q, nb * block_b - B), math.inf, dtype=d2m.dtype,
                         device=d2m.device)
        d2m = torch.cat([d2m, pad], dim=1)
    vals, pos = torch.sort(d2m.reshape(Q, nb, block_b), dim=-1, stable=True)
    vals, pos = vals[..., :k], pos[..., :k]
    base = torch.arange(nb, device=d2m.device)[None, :, None] * block_b
    idx = torch.where(torch.isfinite(vals), base + pos, torch.full_like(pos, -1))
    return (idx.reshape(Q, nb * k).to(torch.int32),
            vals.reshape(Q, nb * k).contiguous())


# ---------------------------------------------------------------------------
# The quantized resident tier.  ``qdev`` is an ``engine.
# QuantizedDeviceIndex`` (any object with its fields).
# ---------------------------------------------------------------------------


def expand_block_col(col, B: int) -> torch.Tensor:
    """(nb,) per scale block of ``RESID_BLOCK`` consecutive rows -> (B,)
    per row."""
    return col.repeat_interleave(RESID_BLOCK)[:B]


def dequant_residuals(codes, scale, zero) -> torch.Tensor:
    """(B,) residuals of one level: bf16 widened, or int8 ``zero + scale ·
    code`` with its block's scale and zero; code ``SENTINEL_CODE``
    decodes to ``PAD_RESIDUAL`` whatever the scale."""
    if codes.dtype == torch.bfloat16:
        return codes.float()
    B = codes.shape[0]
    deq = expand_block_col(zero, B) + expand_block_col(scale, B) * codes.float()
    return torch.where(codes == SENTINEL_CODE,
                       torch.full_like(deq, PAD_RESIDUAL), deq)


def dequant_series(codes, scale, zero) -> torch.Tensor:
    """(B, n) dequantized rows û: bf16 widened, or int8 ``zero + scale ·
    code`` with the row's scale and zero."""
    if codes.dtype == torch.bfloat16:
        return codes.float()
    return zero[:, None] + scale[:, None] * codes.float()


def quant_meta_alive_ref(words, residuals, resid_scale, resid_zero,
                         resid_err, q_panels, q_residuals, eps, levels,
                         n: int) -> torch.Tensor:
    """(Q, B) alive mask of the widened cascade over quantized screen
    columns (per level: int8 ``words``, residual codes with their
    per-block ``resid_scale``/``resid_zero``/``resid_err``): C9 ``|r̂ −
    r(q)| ≤ ε + e_blk`` on the dequantized residuals, C10 unwidened on
    the int8 words."""
    eps_c = eps.reshape(-1, 1)
    eps2 = eps_c * eps_c
    B = words[0].shape[0]
    alive = None
    for li, N in enumerate(levels):
        res = dequant_residuals(residuals[li], resid_scale[li],
                                resid_zero[li])
        err = expand_block_col(resid_err[li], B)
        gap = torch.abs(res[None, :] - q_residuals[li][:, None])
        ok = gap <= eps_c + err[None, :]
        alive = ok if alive is None else alive & ok
        alive &= mindist_sq_ref(words[li], q_panels[li], N, n) <= eps2
    return alive


def quant_cascade_alive_ref(qdev, q_panels, q_residuals, eps) -> torch.Tensor:
    """:func:`quant_meta_alive_ref` over a quantized index's columns."""
    return quant_meta_alive_ref(qdev.words, qdev.residuals, qdev.resid_scale,
                                qdev.resid_zero, qdev.resid_err, q_panels,
                                q_residuals, eps, qdev.levels, qdev.n)


def screen_limit_sq(eps, series_err) -> torch.Tensor:
    """(Q, B) squared radius of the widened series screen,
    ``((ε + e_u)·(1 + QUANT_SCREEN_REL) + QUANT_SCREEN_ABS)²``."""
    thresh = (eps.reshape(-1, 1) + series_err[None, :]) * \
        (1.0 + QUANT_SCREEN_REL) + QUANT_SCREEN_ABS
    return thresh * thresh


def fused_quant_range_ref(qdev, q, q_panels, q_residuals, eps):
    """The quantized screen: ``(keep (Q, B) bool, d̂² (Q, B))`` with +inf
    off the kept rows.  d̂² is the matmul form against the dequantized
    rows and their stored norms ‖û‖²."""
    alive = quant_cascade_alive_ref(qdev, q_panels, q_residuals, eps)
    u = dequant_series(qdev.series, qdev.series_scale, qdev.series_zero)
    d2 = verify_d2_ref(q, u, qdev.norms_sq)
    keep = alive & (d2 <= screen_limit_sq(eps, qdev.series_err))
    return keep, torch.where(keep, d2, torch.full_like(d2, math.inf))


def fused_quant_topk_ref(qdev, q, q_panels, q_residuals, eps, k: int,
                         block_b: int):
    """Block-local top-k partials of d̂² among the rows the quantized
    screen keeps, in the layout of :func:`fused_topk_ref`."""
    _, d2m = fused_quant_range_ref(qdev, q, q_panels, q_residuals, eps)
    return block_topk(d2m, k, block_b)


# ---------------------------------------------------------------------------
# Subsequence search: the rows are the z-normalised length-w windows of
# raw streams, numbered stream-major (``core/subseq.py``).
# ---------------------------------------------------------------------------


def device_windows(streams, window: int, stride: int, mu, sd, wid=None):
    """(W, window) z-normalised windows in f32 — the one expression every
    path shares: the torch engine's rows, the kernels' window tiles and
    any candidate re-gather all evaluate ``(x[a:a+w] − μ)/σ`` (subtract,
    then divide, each rounded) on the same f32 inputs.  ``wid`` selects
    windows (default: all W, in canonical order)."""
    S, n = streams.shape
    W_s = (n - window) // stride + 1
    if wid is None:
        wid = torch.arange(S * W_s, device=streams.device)
    wid = wid.long()
    start = (wid // W_s) * n + (wid % W_s) * stride
    cols = torch.arange(window, device=streams.device)
    win = streams.reshape(-1)[start[:, None] + cols[None, :]]
    return (win - mu[wid][:, None]) / sd[wid][:, None]


def fused_subseq_range_ref(streams, mu, sd, norms_sq, words, residuals, q,
                           q_panels, q_residuals, eps, levels, window: int,
                           stride: int):
    """:func:`fused_range_ref` over the windows of the streams:
    ``(answers (Q, W) bool, d2 (Q, W))`` in canonical window order."""
    z = device_windows(streams, window, stride, mu, sd)
    return fused_range_ref(z, norms_sq, words, residuals, q, q_panels,
                           q_residuals, eps, levels, window)


def fused_subseq_topk_ref(streams, mu, sd, norms_sq, words, residuals, q,
                          q_panels, q_residuals, eps, levels, window: int,
                          stride: int, k: int, block_b: int):
    """:func:`fused_topk_ref` over the windows of the streams: block-local
    partials with canonical window ids."""
    z = device_windows(streams, window, stride, mu, sd)
    return fused_topk_ref(z, norms_sq, words, residuals, q, q_panels,
                          q_residuals, eps, levels, window, k, block_b)


def fused_quant_subseq_range_ref(streams, mu, sd, norms_sq, qmeta, q,
                                 q_panels, q_residuals, eps, levels,
                                 window: int, stride: int):
    """Range over quantized per-window screen columns (``qmeta``, a
    ``core.subseq.SubseqQuantMeta``): the widened cascade, then the exact
    verify over the windows of the raw streams, cut at ε².  The answers
    are final, set-identical to :func:`fused_subseq_range_ref`'s."""
    alive = quant_meta_alive_ref(qmeta.words, qmeta.residuals, qmeta.scale,
                                 qmeta.zero, qmeta.err, q_panels,
                                 q_residuals, eps, levels, window)
    z = device_windows(streams, window, stride, mu, sd)
    d2 = verify_d2_ref(q, z, norms_sq)
    eps_c = eps.reshape(-1, 1)
    ans = alive & (d2 <= eps_c * eps_c)
    return ans, torch.where(ans, d2, torch.full_like(d2, math.inf))


def merge_topk_partials(idx, d2, k: int):
    """Merge (Q, M) block-local partials into the global top-k, ascending
    by (d², index); empty slots (+inf, −1) sort last and come back as −1.
    Two stable sorts, by index and then by d², give the lexicographic
    order of the reference's ``lax.sort`` on (d², index)."""
    idx_i = torch.where(idx < 0, torch.full_like(idx, INT32_MAX), idx)
    o1 = torch.sort(idx_i, dim=-1, stable=True).indices
    d2a = torch.gather(d2, -1, o1)
    ia = torch.gather(idx_i, -1, o1)
    o2 = torch.sort(d2a, dim=-1, stable=True).indices
    d2s = torch.gather(d2a, -1, o2)
    idxs = torch.gather(ia, -1, o2)
    k = min(int(k), d2.shape[-1])
    out = torch.where(torch.isfinite(d2s[:, :k]), idxs[:, :k],
                      torch.full_like(idxs[:, :k], -1))
    return out, d2s[:, :k]


def compact_count_ref(answer, tile: int):
    """A dense (Q, B) answer mask's answers per tile of ``tile`` slots and
    per row: ``(tile_counts (Q, ⌈B/tile⌉) int32, count (Q,) int32)``."""
    Q, B = answer.shape
    T = -(-B // tile)
    flat = torch.zeros((Q, T * tile), dtype=torch.int32, device=answer.device)
    flat[:, :B] = answer != 0
    tiles = flat.reshape(Q, T, tile).sum(dim=-1, dtype=torch.int32)
    return tiles, tiles.sum(dim=-1, dtype=torch.int32)


def compact_write_ref(answer, d2, C: int):
    """The compact layout of a dense (Q, B) answer pair: ``(idx (Q, C)
    int32, d2 (Q, C) float32)``, row i's answer slots ascending in its
    first count[i] slots with their d², −1 / +inf after (C ≥ the largest
    count)."""
    Q = answer.shape[0]
    rows, slots = torch.nonzero(answer, as_tuple=True)
    pos = torch.cumsum(answer != 0, dim=-1)[rows, slots] - 1
    idx = torch.full((Q, C), -1, dtype=torch.int32, device=answer.device)
    out = torch.full((Q, C), math.inf, dtype=torch.float32,
                     device=answer.device)
    idx[rows, pos] = slots.to(torch.int32)
    out[rows, pos] = d2[rows, slots]
    return idx, out


# ---------------------------------------------------------------------------
# The per-level operations (``csrc/level_ops.cu``), one query at a time.
# ``qres`` and ``eps`` are Python floats already rounded to float32.
# ---------------------------------------------------------------------------

def paa_ref(x, n_segments: int) -> torch.Tensor:
    """(B, n) f32 or bf16 -> (B, N) f32 segment means (``core/paa.paa``)."""
    return paa(x.to(torch.float32), n_segments)


def linfit_residual_sq_ref(x, n_segments: int) -> torch.Tensor:
    """(B, n) f32 or bf16 -> (B,) f32 squared distance to the optimal
    per-segment line (``core/polyfit.linfit_residual_sq``)."""
    return linfit_residual_sq(x.to(torch.float32), n_segments)


def mindist_sq_level_ref(words, tq, n: int) -> torch.Tensor:
    """(B, N) int32 words × one query's (α, N) panel -> (B,) squared
    MINDIST ``(n/N)·Σᵢ tq[wᵢ, i]²`` (the single-query form of
    :func:`mindist_sq_ref`)."""
    N = words.shape[-1]
    cell = tq[words.long(), torch.arange(N, device=words.device)[None, :]]
    return (n / N) * row_sum(cell * cell)


def sqdist_ref(x, q) -> torch.Tensor:
    """(B, n) × (n,) -> (B,) f32 squared Euclidean distances."""
    diff = x.to(torch.float32) - q.to(torch.float32)[None, :]
    return row_sum(diff * diff)


def eps_sq_f32(eps: float) -> float:
    """ε·ε rounded to float32, as the reference's kernel takes it (+inf
    past float32's range)."""
    with np.errstate(over="ignore"):
        return float(np.float32(eps) * np.float32(eps))


def prune_level_ref(alive, residuals, words, tq, qres: float, eps: float,
                    n: int) -> torch.Tensor:
    """One cascade level: ``alive ∧ |res − qres| ≤ ε ∧ MINDIST² ≤ ε·ε``
    with ε·ε rounded to float32 (eq. 9, then eq. 10)."""
    c9 = torch.abs(residuals - qres) <= eps
    c10 = mindist_sq_level_ref(words, tq, n) <= eps_sq_f32(eps)
    return alive & c9 & c10
