"""Plain PyTorch versions of the fused kernels and of the top-k merge.

Counterpart of ``repro/kernels/ref.py`` for the kernels ported so far.
Each function computes what its CUDA kernel computes (``csrc/
fused_query.cu``): the wrappers in ``fused_query.py`` run these on CPU
tensors, and ``chip_smoke.py`` holds the kernels against them on the card.
They spend memory freely — the (Q, B, N) MINDIST gather and a dense
(Q, B) verify — which is fine for tests and checks, not for serving.
"""
from __future__ import annotations

import math

import torch

INT32_MAX = 2 ** 31 - 1


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
        Q, A, _ = q_panels[li].shape
        B = words[li].shape[0]
        flat = (words[li].long() * N
                + torch.arange(N, device=words[li].device)[None, :])
        cell = torch.gather(q_panels[li].reshape(Q, A * N), 1,
                            flat.reshape(1, B * N).expand(Q, B * N))
        cell = cell.reshape(Q, B, N)
        md_sq = float(n // N) * torch.sum(cell * cell, dim=-1)
        alive &= md_sq <= eps2
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
    d2m = torch.where(alive, d2, torch.full_like(d2, math.inf))
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
