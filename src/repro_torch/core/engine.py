"""Vectorised FAST_SAX query engine on PyTorch tensors.

Counterpart of ``repro/core/engine.py`` (its whole-series part, up to the
quantized tier).  The paper's CPU-sequential cascade runs as a masked
dataflow over the whole database:

  * C9 (eq. 9) is a vector compare over the precomputed residuals,
  * C10 (MINDIST, eq. 10) is a table gather under the C9 survivors,
  * the Euclidean verify uses ‖u‖² − 2·u·q + ‖q‖² with the database norms
    precomputed offline.

Two backends answer identically:

  * ``"torch"`` — plain tensor code (the reference's ``"xla"`` engine):
    :func:`range_query`, :func:`knn_query`, :func:`mixed_query` and their
    capacity-escalating ``*_auto`` drivers;
  * ``"cuda"`` — the fused kernels of ``kernels/fused_query.py`` (the
    reference's ``"pallas"`` engine): :func:`range_query_fused`,
    :func:`knn_query_fused`, :func:`mixed_query_fused`.  One kernel pass
    reads the database once per pass and never materialises the (Q, B, N)
    gather.  On CPU tensors the kernel wrappers run their plain versions,
    so the fused engine is testable without a card.

``resolve_backend("auto", device)`` picks ``"cuda"`` for an index on a
CUDA device and ``"torch"`` for one on the CPU.  All device math is
float32, as the reference runs with x64 off; TF32 must stay off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default),
because the top-k certificate's tie window is sized for f32 noise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..kernels import fused_query as _fused
from ..kernels import ops as kernel_ops
from ..kernels import ref as _ref
from . import cost_model as _cost_model
from . import representation as repr_registry
from .fastsax import FastSAXIndex
from .options import SearchOptions, resolve_options
from .paa import paa, znormalize
from .polyfit import linfit_residual
from .representation import DEFAULT_STACK
from .sax import discretize

INF = math.inf


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device; raises when none was given and there is no CUDA
    device (the port does not quietly run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@dataclasses.dataclass
class DeviceIndex:
    """Device-resident FAST_SAX index.

    ``series``: (B, n) f32, ``norms_sq``: (B,) f32 precomputed ‖u‖²,
    ``words[l]``: (B, N_l) int32, ``residuals[l]``: (B,) f32, all on one
    device; ``levels`` in cascade visit order.
    """

    series: torch.Tensor
    norms_sq: torch.Tensor
    words: tuple
    residuals: tuple
    levels: tuple = ()
    alphabet: int = 10
    stack: tuple = DEFAULT_STACK

    @property
    def n(self) -> int:
        return self.series.shape[-1]

    @property
    def size(self) -> int:
        return self.series.shape[0]

    @property
    def device(self) -> torch.device:
        return self.series.device

    @classmethod
    def from_store(cls, path, **kwargs):
        raise NotImplementedError(
            "DeviceIndex.from_store needs the index-lifecycle slice of the "
            "port (ROADMAP.md queue 1)")


def device_index_from_numpy(series, norms_sq, words, residuals, levels,
                            alphabet: int, device=None) -> DeviceIndex:
    """An index from numpy arrays — e.g. the leaves of a reference
    ``DeviceIndex`` — so two engines can be compared on the same index.

    ``series`` (B, n), ``norms_sq`` (B,), per level ``words`` (B, N) and
    ``residuals`` (B,); cast to f32 / int32 and moved to ``device``
    (default: CUDA, see :func:`resolve_device`).  Raises on inconsistent
    shapes or on words outside ``[0, alphabet)``."""
    dev = resolve_device(device)
    series = np.asarray(series)
    if series.ndim != 2:
        raise ValueError(f"series must be (B, n), got {series.shape}")
    B, n = series.shape
    levels = tuple(int(N) for N in levels)
    if len(words) != len(levels) or len(residuals) != len(levels):
        raise ValueError("words and residuals need one entry per level")
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
    w_t = []
    for N, w in zip(levels, words):
        w = np.asarray(w)
        if w.shape != (B, N) or n % N:
            raise ValueError(f"words for level N={N} must be ({B}, {N}) "
                             f"and N must divide n={n}, got {w.shape}")
        if w.size and (w.min() < 0 or w.max() >= alphabet):
            raise ValueError(f"words for level N={N} leave [0, {alphabet})")
        w_t.append(torch.as_tensor(w.astype(np.int32), device=dev))
    r_t = []
    for N, r in zip(levels, residuals):
        if np.shape(r) != (B,):
            raise ValueError(f"residuals for level N={N} must be ({B},)")
        r_t.append(f32(r))
    if np.shape(norms_sq) != (B,):
        raise ValueError(f"norms_sq must be ({B},)")
    return DeviceIndex(series=f32(series).contiguous(), norms_sq=f32(norms_sq),
                       words=tuple(w_t), residuals=tuple(r_t), levels=levels,
                       alphabet=int(alphabet))


def device_index_from_host(index: FastSAXIndex, device=None) -> DeviceIndex:
    """Upload a host-built index (f64 columns cast to f32)."""
    dev = resolve_device(device)
    series = torch.as_tensor(index.series, dtype=torch.float32, device=dev)
    return DeviceIndex(
        series=series,
        norms_sq=torch.sum(series * series, dim=-1),
        words=tuple(torch.as_tensor(lv.words, dtype=torch.int32, device=dev)
                    for lv in index.levels),
        residuals=tuple(torch.as_tensor(lv.residuals, dtype=torch.float32,
                                        device=dev) for lv in index.levels),
        levels=tuple(lv.n_segments for lv in index.levels),
        alphabet=index.config.alphabet,
        stack=tuple(index.config.stack))


def build_device_index(series, levels: Sequence[int], alphabet: int,
                       normalize: bool = True, stack: tuple = DEFAULT_STACK,
                       device=None) -> DeviceIndex:
    """Offline phase on the device: z-normalise (optionally) and compute
    every level's words and residuals in f32.  ``series`` is a (B, n)
    array or tensor; a tensor stays on its device unless ``device`` is
    given."""
    if device is None and isinstance(series, torch.Tensor):
        device = series.device
    dev = resolve_device(device)
    x = torch.as_tensor(series, device=dev).to(torch.float32)
    if normalize:
        x = znormalize(x)
    x = x.contiguous()
    stack = repr_registry.validate_stack(stack)
    return DeviceIndex(
        series=x,
        norms_sq=torch.sum(x * x, dim=-1),
        words=tuple(discretize(paa(x, N), alphabet) for N in levels),
        residuals=tuple(linfit_residual(x, N).to(torch.float32)
                        for N in levels),
        levels=tuple(int(N) for N in levels),
        alphabet=int(alphabet),
        stack=stack)


@dataclasses.dataclass(frozen=True)
class QueryReprDev:
    """Device query representation: ``q`` (Q, n) f32 and, per level,
    ``words`` (Q, N) int32 and ``residuals`` (Q,) f32."""

    q: torch.Tensor
    words: tuple
    residuals: tuple


def represent_queries(q: torch.Tensor, levels: Sequence[int], alphabet: int,
                      normalize: bool = True,
                      stack: tuple = DEFAULT_STACK) -> QueryReprDev:
    """Represent a (Q, n) batch of queries at every level, on its device."""
    repr_registry.validate_stack(stack)
    if normalize:
        q = znormalize(q)
    q = q.to(torch.float32).contiguous()
    return QueryReprDev(
        q=q,
        words=tuple(discretize(paa(q, N), alphabet) for N in levels),
        residuals=tuple(linfit_residual(q, N).to(torch.float32).contiguous()
                        for N in levels))


def _mindist_sq_tab(alphabet: int, device) -> torch.Tensor:
    return kernel_ops.mindist_table_cached(alphabet, str(device))


def _eps_qcol(epsilon, Q: int, device) -> torch.Tensor:
    """Normalise epsilon (scalar or per-query (Q,)) to a (Q, 1) f32 column."""
    eps = torch.as_tensor(epsilon, dtype=torch.float32, device=device)
    if eps.ndim == 0:
        eps = eps.expand(Q)
    return eps.reshape(Q, 1)


def _arange(B: int, device, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(B, dtype=dtype, device=device)


def _top_k(x: torch.Tensor, k: int):
    """Largest k along the last axis, ties to the lowest index (the
    reference's ``lax.top_k`` order; ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _bottom_k(x: torch.Tensor, k: int):
    """Smallest k along the last axis, ascending, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def cascade_mask(index: DeviceIndex, qr: QueryReprDev, epsilon) -> torch.Tensor:
    """(Q, B) alive mask of the exclusion cascade: True = candidate."""
    n, dev = index.n, index.device
    Q = qr.q.shape[0]
    eps = _eps_qcol(epsilon, Q, dev)
    eps2 = eps * eps
    alive = torch.ones((Q, index.size), dtype=torch.bool, device=dev)
    tab = _mindist_sq_tab(index.alphabet, dev)
    for li, N in enumerate(index.levels):
        # C9: |d(u,ū) − d(q,q̄)| > ε  → kill.
        gap = torch.abs(index.residuals[li][None, :] - qr.residuals[li][:, None])
        alive &= gap <= eps
        # C10: MINDIST²(q̃,ũ) > ε² → kill.
        cell = tab[index.words[li].long()[None, :, :],
                   qr.words[li].long()[:, None, :]]
        md_sq = (n / N) * torch.sum(cell * cell, dim=-1)
        alive &= md_sq <= eps2
    return alive


def verify_distances(index: DeviceIndex, qr: QueryReprDev) -> torch.Tensor:
    """(Q, B) squared Euclidean distances via the matmul form
    ‖q‖² − 2·q·u + ‖u‖², clamped at 0; one matrix-vector product per
    query, so a query's distances do not depend on its batch."""
    return _ref.verify_d2_ref(qr.q, index.series, index.norms_sq)


def range_query(index: DeviceIndex, qr: QueryReprDev, epsilon):
    """Full FAST_SAX range query for a batch of queries: ``(answers
    (Q, B) bool, d2 (Q, B))`` with +inf outside the answer set."""
    Q = qr.q.shape[0]
    eps = _eps_qcol(epsilon, Q, index.device)
    alive = cascade_mask(index, qr, eps)
    d2 = verify_distances(index, qr)
    answers = alive & (d2 <= eps * eps)
    return answers, torch.where(answers, d2, INF)


def compact_verify(index: DeviceIndex, qr: QueryReprDev, alive: torch.Tensor,
                   capacity: int, order_key: torch.Tensor | None = None):
    """Compact alive lanes to ``capacity`` slots and verify only those rows
    (diff² form).  Slots fill lowest index first, or by ``order_key``
    (higher first) when given.  Returns ``(idx (Q, C) int32, valid (Q, C),
    d2 (Q, C))`` with +inf on invalid slots."""
    B = alive.shape[-1]
    if order_key is None:
        keys = torch.where(alive, B - _arange(B, alive.device)[None, :], 0)
        top, idx = _top_k(keys, capacity)
        valid = top > 0
    else:
        keys = torch.where(alive, order_key, -INF)
        top, idx = _top_k(keys, capacity)
        valid = top > -INF
    rows = index.series[idx]                                  # (Q, C, n)
    diff = rows - qr.q[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return idx.to(torch.int32), valid, torch.where(valid, d2, INF)


def range_query_compact(index: DeviceIndex, qr: QueryReprDev, epsilon,
                        capacity: int):
    """Two-phase range query: cascade → compact survivors → verify only
    those.  Returns ``(idx, answers, d2, overflow)``; ``overflow`` flags
    rows whose survivors did not fit ``capacity``."""
    Q = qr.q.shape[0]
    eps = _eps_qcol(epsilon, Q, index.device)
    alive = cascade_mask(index, qr, eps)
    capacity = min(int(capacity), alive.shape[-1])
    idx, valid, d2 = compact_verify(index, qr, alive, capacity)
    answers = valid & (d2 <= eps * eps)
    overflow = alive.sum(dim=-1) > capacity
    return idx, answers, torch.where(answers, d2, INF), overflow


def range_query_auto(index: DeviceIndex, qr: QueryReprDev, epsilon,
                     capacity: int):
    """:func:`range_query_compact`, re-answered densely by
    :func:`range_query` when any row overflowed.  Returns ``(idx, answers,
    d2)`` in the compact layout, or the dense (Q, B) layout after a
    fallback."""
    idx, answers, d2, overflow = range_query_compact(index, qr, epsilon,
                                                     capacity)
    if not bool(overflow.any()):
        return idx, answers, d2
    mask, dense_d2 = range_query(index, qr, epsilon)
    all_idx = _arange(index.size, index.device, torch.int32)[None, :]
    return all_idx.expand(mask.shape), mask, dense_d2


# ---------------------------------------------------------------------------
# Exact k-NN: an iteratively tightened per-query radius over the cascade.
# ---------------------------------------------------------------------------

_KNN_SEED_SAMPLE = 64     # minimum strided-sample size for the seed radius
# f32 slack on the cascade radius (relative + absolute): index residuals
# are f64-built then cast while query residuals are f32, so the lower
# bound holds only up to rounding.  Slack only adds survivors.
_KNN_EPS_SLACK = 1e-4
_KNN_EPS_ABS = 1e-3
# Stand-in seed radius for a sample with fewer than k valid rows: it must
# upper-bound any f32 distance (≤ ~2e19) yet stay below the 1e30 sentinel
# residual so the fused kernels' C9 still kills masked rows; its square
# overflows f32 to +inf, which only opens C10.
_SEED_EPS_MAX = 1e28


def _slacked(eps: torch.Tensor) -> torch.Tensor:
    return eps * (1.0 + _KNN_EPS_SLACK) + _KNN_EPS_ABS


def _kth_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th smallest of (Q, M) values as a (Q, 1) column."""
    return torch.topk(d2, k, dim=-1, largest=False).values[:, -1:]


def _seed_eps(index: DeviceIndex, qr: QueryReprDev, k: int, valid_mask):
    """k-NN seed radius from a strided verified row sample (≥ max(k, 64)
    rows): the k-th sampled distance upper-bounds the true k-th distance.
    A non-finite radius becomes ``_SEED_EPS_MAX``."""
    B = index.size
    S = min(B, max(k, _KNN_SEED_SAMPLE))
    sample = (_arange(S, index.device) * B) // S
    rows = index.series[sample]                          # (S, n)
    diff = rows[None, :, :] - qr.q[:, None, :]
    d2s = torch.sum(diff * diff, dim=-1)                 # (Q, S)
    if valid_mask is not None:
        d2s = torch.where(valid_mask[sample][None, :], d2s, INF)
    eps = torch.sqrt(torch.clamp(_kth_smallest(d2s, k), min=0.0))
    return torch.where(torch.isfinite(eps), eps,
                       torch.full_like(eps, _SEED_EPS_MAX))


def _cascade_eps(eps: torch.Tensor, knn_col=None) -> torch.Tensor:
    """Per-row cascade radius: k-NN rows carry the f32 slack, range rows
    use the caller's ε verbatim.  ``knn_col=None``: every row is k-NN."""
    if knn_col is None:
        return _slacked(eps)
    return torch.where(knn_col, _slacked(eps), eps)


def _tighten_eps(index: DeviceIndex, qr: QueryReprDev, eps, k: int,
                 capacity: int, n_iters: int, valid_mask, knn_col=None):
    """The promise-ordered k-NN tightening passes: verify the survivors
    with the smallest level-0 residual gap first and shrink ε to the k-th
    smallest verified distance.  ``knn_col`` selects which rows tighten."""
    gap0 = torch.abs(index.residuals[0][None, :] - qr.residuals[0][:, None])
    for _ in range(max(0, int(n_iters) - 1)):
        alive = cascade_mask(index, qr, _cascade_eps(eps, knn_col))
        if valid_mask is not None:
            alive &= valid_mask[None, :]
        _, _, d2 = compact_verify(index, qr, alive, capacity, order_key=-gap0)
        tight = torch.minimum(eps, torch.sqrt(_kth_smallest(d2, k)))
        eps = tight if knn_col is None else torch.where(knn_col, tight, eps)
    return eps


def knn_query(index: DeviceIndex, qr: QueryReprDev, k: int,
              capacity: int | None = None, n_iters: int = 2,
              valid_mask: torch.Tensor | None = None):
    """Batched exact k-NN over the masked cascade (torch backend).

    Seed ε from a strided verified sample, tighten it ``n_iters − 1``
    times, then take the top-k of a final low-index compaction.  Returns
    ``(nn_idx (Q, k), nn_d2 (Q, k), exact (Q,))``; ``exact`` is True iff
    the final survivors fit ``capacity``, in which case the answer equals
    brute force with ties to the lowest index.  ``valid_mask`` (B,)
    excludes rows from the sample and the answers.
    """
    B = index.size
    k = min(int(k), B)
    capacity = min(B, max(4 * k, 64) if capacity is None else int(capacity))
    capacity = max(capacity, k)
    eps = _seed_eps(index, qr, k, valid_mask)
    eps = _tighten_eps(index, qr, eps, k, capacity, n_iters, valid_mask)
    alive = cascade_mask(index, qr, _cascade_eps(eps))
    if valid_mask is not None:
        alive &= valid_mask[None, :]
    idx, valid, d2 = compact_verify(index, qr, alive, capacity)
    overflow = alive.sum(dim=-1) > capacity
    nn_d2, pos = _bottom_k(d2, k)
    return torch.gather(idx, -1, pos), nn_d2, ~overflow


def knn_query_auto(index: DeviceIndex, qr: QueryReprDev, k: int,
                   capacity: int | None = None, n_iters: int = 2,
                   valid_mask: torch.Tensor | None = None,
                   max_doublings: int = 8):
    """:func:`knn_query`, re-run at 4× the capacity while any row's
    certificate is False (capped at B, where it cannot fail)."""
    B = index.size
    k_eff = min(int(k), B)
    cap = min(B, max(4 * k_eff, 64) if capacity is None else int(capacity))
    cap = max(cap, k_eff)
    for _ in range(max_doublings + 1):
        nn_idx, nn_d2, exact = knn_query(index, qr, k_eff, capacity=cap,
                                         n_iters=n_iters,
                                         valid_mask=valid_mask)
        if cap >= B or bool(exact.all()):
            return nn_idx, nn_d2, exact
        cap = min(B, cap * 4)
    return nn_idx, nn_d2, exact


# ---------------------------------------------------------------------------
# Mixed batches: one pass serving k-NN and range queries.
# ---------------------------------------------------------------------------


def mixed_query(index: DeviceIndex, qr: QueryReprDev, epsilon, is_knn,
                k: int, capacity: int, n_iters: int = 2,
                valid_mask: torch.Tensor | None = None):
    """One pass answering a mixed batch (torch backend).

    Row i is a range query at ``epsilon[i]`` when ``is_knn[i]`` is False,
    else an exact k-NN that seeds and tightens its own radius.  Returns
    ``(idx (Q, C), answer (Q, C), d2 (Q, C), overflow (Q,))``: range rows
    mark their verified in-range slots, k-NN rows their valid candidates
    (take the top-k with :func:`mixed_topk`)."""
    Q, B = qr.q.shape[0], index.size
    k = min(int(k), B)
    capacity = max(min(int(capacity), B), k)
    knn_col = torch.as_tensor(is_knn, dtype=torch.bool,
                              device=index.device).reshape(Q, 1)
    eps_req = _eps_qcol(epsilon, Q, index.device)
    eps = torch.where(knn_col, _seed_eps(index, qr, k, valid_mask), eps_req)
    eps = _tighten_eps(index, qr, eps, k, capacity, n_iters, valid_mask,
                       knn_col=knn_col)
    alive = cascade_mask(index, qr, _cascade_eps(eps, knn_col))
    if valid_mask is not None:
        alive &= valid_mask[None, :]
    idx, valid, d2 = compact_verify(index, qr, alive, capacity)
    overflow = alive.sum(dim=-1) > capacity
    answer = torch.where(knn_col, valid, valid & (d2 <= eps_req * eps_req))
    return idx, answer, torch.where(answer, d2, INF), overflow


def mixed_query_dense(index: DeviceIndex, qr: QueryReprDev, epsilon, is_knn,
                      k: int, valid_mask: torch.Tensor | None = None):
    """Dense-verify form of :func:`mixed_query`: range rows follow
    :func:`range_query`, k-NN rows are answered over the dense distances.
    Cannot overflow; same return convention with C = B."""
    del k
    Q, B = qr.q.shape[0], index.size
    dev = index.device
    knn_col = torch.as_tensor(is_knn, dtype=torch.bool, device=dev).reshape(Q, 1)
    eps = _eps_qcol(epsilon, Q, dev)
    alive = cascade_mask(index, qr, eps)
    d2 = verify_distances(index, qr)
    valid = torch.ones((Q, B), dtype=torch.bool, device=dev)
    if valid_mask is not None:
        alive &= valid_mask[None, :]
        valid &= valid_mask[None, :]
    in_range = alive & (d2 <= eps * eps)
    answer = torch.where(knn_col, valid, in_range)
    idx = _arange(B, dev, torch.int32)[None, :].expand(Q, B)
    overflow = torch.zeros((Q,), dtype=torch.bool, device=dev)
    return idx, answer, torch.where(answer, d2, INF), overflow


def mixed_topk(idx: torch.Tensor, d2: torch.Tensor, k: int):
    """Per-row ascending top-k of a candidate buffer, ties to the lowest
    slot (slots are low-index compacted, so to the lowest row)."""
    vals, pos = _bottom_k(d2, min(int(k), d2.shape[-1]))
    return torch.gather(idx, -1, pos), vals


def mixed_query_auto(index: DeviceIndex, qr: QueryReprDev, epsilon, is_knn,
                     k: int, capacity: int | None = None, n_iters: int = 2,
                     valid_mask: torch.Tensor | None = None,
                     max_doublings: int = 8):
    """:func:`mixed_query`, re-run at 4× the capacity while any row
    overflowed (capped at B)."""
    B = index.size
    k_eff = min(int(k), B)
    cap = min(B, max(4 * k_eff, 64) if capacity is None else int(capacity))
    cap = max(cap, k_eff)
    for _ in range(max_doublings + 1):
        idx, answer, d2, overflow = mixed_query(
            index, qr, epsilon, is_knn, k_eff, capacity=cap,
            n_iters=n_iters, valid_mask=valid_mask)
        if cap >= B or not bool(overflow.any()):
            return idx, answer, d2, overflow
        cap = min(B, cap * 4)
    return idx, answer, d2, overflow


# ---------------------------------------------------------------------------
# Backend dispatch: the fused CUDA kernels vs the torch engine.
# ---------------------------------------------------------------------------


def resolve_backend(backend: str, device) -> str:
    """Map ``auto | torch | cuda`` to the engine for an index on
    ``device``: ``auto`` is ``cuda`` on a CUDA device, else ``torch``."""
    if backend not in ("auto", "torch", "cuda"):
        raise ValueError(
            f"backend must be 'auto', 'torch' or 'cuda', got {backend!r}")
    if backend == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    return backend


def resolve_knn_backend(backend: str, k: int, device) -> str:
    """:func:`resolve_backend` plus the top-k demotion rule: a fused k-NN
    keeping more than ``cost_model.TOPK_DEMOTE_KSEL`` slots per block runs
    on the torch engine, as the reference demotes its Pallas selection.
    Demotion never changes answers."""
    be = resolve_backend(backend, device)
    if be == "cuda" and _cost_model.topk_demote_advised(int(k) + _TOPK_GUARD):
        return "torch"
    return be


def _fused_blocks(index: DeviceIndex, Q: int, k_sel: int = 0,
                  block_q: int | None = None, block_b: int | None = None):
    if block_q is None or block_b is None:
        bq, bb = kernel_ops.choose_fused_blocks(
            Q, index.size, index.n, index.levels, index.alphabet, k_sel=k_sel)
        block_q, block_b = block_q or bq, block_b or bb
    if int(block_q) not in kernel_ops.FUSED_BLOCK_Q or int(block_b) % 64:
        raise ValueError(f"block_q must be one of {kernel_ops.FUSED_BLOCK_Q} "
                         f"and block_b a multiple of 64, got {block_q}, "
                         f"{block_b}")
    need = kernel_ops.fused_smem_bytes(int(block_q), index.n, index.levels,
                                       index.alphabet, Q, k_sel)
    if need > kernel_ops.SMEM_BYTES:
        raise ValueError(f"fused tile block_q={block_q} needs {need} bytes "
                         f"of shared memory (> {kernel_ops.SMEM_BYTES})")
    return int(block_q), int(block_b)


def _masked_residuals(index: DeviceIndex, valid_mask) -> tuple:
    """Fold a row-validity mask into the level-0 residuals as the C9
    sentinel ``PAD_RESIDUAL``: the fused kernel then kills invalid rows."""
    if valid_mask is None:
        return index.residuals
    res0 = torch.where(valid_mask, index.residuals[0],
                       torch.full_like(index.residuals[0], _fused.PAD_RESIDUAL))
    return (res0,) + tuple(index.residuals[1:])


def _query_panels(qr: QueryReprDev, alphabet: int) -> tuple:
    return tuple(kernel_ops.query_panels(w, alphabet) for w in qr.words)


def _reverify_rows(index: DeviceIndex, qr: QueryReprDev, idx: torch.Tensor,
                   valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Exact diff²-form distances of candidate rows (the expression of
    :func:`compact_verify`); indices outside ``[0, B)`` (−1 = empty slot)
    and rows excluded by ``valid_mask`` re-verify to +inf.  Gathers a
    (Q, C, n) block of rows."""
    B = index.size
    safe = idx.long().clamp(0, B - 1)
    rows = index.series[safe]                             # (Q, C, n)
    diff = rows - qr.q[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    ok = (idx >= 0) & (idx < B)
    if valid_mask is not None:
        ok &= valid_mask[safe]
    return torch.where(ok, d2, INF)


def _mask_dense(ans: torch.Tensor, d2: torch.Tensor, valid_mask):
    """Exclude masked rows from a dense answer pair whatever the radius."""
    if valid_mask is None:
        return ans, d2
    ans = ans & valid_mask[None, :]
    return ans, torch.where(ans, d2, INF)


def _fused_inputs(index: DeviceIndex, qr: QueryReprDev, residuals, panels,
                  eps_col: torch.Tensor) -> dict:
    return dict(series=index.series, norms_sq=index.norms_sq,
                words=index.words, residuals=residuals, q=qr.q,
                q_panels=panels, q_residuals=qr.residuals,
                eps=eps_col.reshape(-1).contiguous(), levels=index.levels,
                alphabet=index.alphabet, n=index.n)


def range_query_fused(index: DeviceIndex, qr: QueryReprDev, epsilon,
                      valid_mask: torch.Tensor | None = None,
                      block_q: int | None = None, block_b: int | None = None):
    """One-pass fused range query (the reference's ``range_query_pallas``):
    same return convention as :func:`range_query`."""
    Q = qr.q.shape[0]
    block_q, block_b = _fused_blocks(index, Q, 0, block_q, block_b)
    ans, d2 = _fused.fused_range(
        **_fused_inputs(index, qr, _masked_residuals(index, valid_mask),
                        _query_panels(qr, index.alphabet),
                        _eps_qcol(epsilon, Q, index.device)),
        block_q=block_q, block_b=block_b)
    return _mask_dense(ans, d2, valid_mask)


# Extra block-local top-k slots beyond k: the kernel ranks by the matmul
# form of d², the merge by the re-verified diff² form, and the two can
# swap near-ties at a block's boundary.  The certificate below detects
# the only loss this leaves.
_TOPK_GUARD = 4
# Near-tie window of that certificate, sized for f32 noise (TF32 would
# exceed it).
_TOPK_TIE_REL = 1e-4
_TOPK_TIE_ABS = 1e-3


def _fused_tighten_eps(index, qr, eps, k, k_sel, n_iters, valid_mask,
                       residuals, panels, block_q, block_b, knn_col=None):
    """Fused twin of :func:`_tighten_eps`: each pass is one
    ``fused_topk`` read whose re-verified partials shrink the k-NN rows'
    radius (the reference's ``_fused_tighten_eps``)."""
    for _ in range(max(0, int(n_iters) - 1)):
        idxp, _ = _fused.fused_topk(
            **_fused_inputs(index, qr, residuals, panels,
                            _cascade_eps(eps, knn_col)),
            k=k_sel, block_q=block_q, block_b=block_b)
        d2v = _reverify_rows(index, qr, idxp, valid_mask)
        tight = torch.minimum(eps, torch.sqrt(_kth_smallest(d2v, k)))
        eps = tight if knn_col is None else torch.where(knn_col, tight, eps)
    return eps


def _topk_exact_certificate(d2v: torch.Tensor, nn_d2: torch.Tensor, k: int,
                            k_sel: int, block_b: int) -> torch.Tensor:
    """Exactness certificate of a merged block-local top-k: a row can only
    be lost when cut from a FULL partial list by a near-tie, so every full
    block's worst re-verified partial must clear the merged k-th distance
    by the tie window.  With ``k_sel == block_b`` nothing can be cut."""
    Q = d2v.shape[0]
    if k_sel >= block_b:
        return torch.ones((Q,), dtype=torch.bool, device=d2v.device)
    blk_worst = torch.amax(d2v.reshape(Q, -1, k_sel), dim=-1)  # (Q, nb)
    kth = nn_d2[:, k - 1:k]
    at_risk = torch.isfinite(blk_worst) & (
        blk_worst <= kth * (1.0 + _TOPK_TIE_REL) + _TOPK_TIE_ABS)
    return ~torch.any(at_risk, dim=-1)


def knn_query_fused(index: DeviceIndex, qr: QueryReprDev, k: int,
                    n_iters: int = 2, valid_mask: torch.Tensor | None = None,
                    block_q: int | None = None, block_b: int | None = None):
    """Fused exact k-NN (the reference's ``knn_query_pallas``): the same
    tightening schedule as :func:`knn_query`, each pass one database read
    emitting block-local top-k partials, merged and re-verified in the
    diff² form.  Returns ``(nn_idx, nn_d2, exact)`` with ``exact`` from
    :func:`_topk_exact_certificate`."""
    Q, B = qr.q.shape[0], index.size
    k = min(int(k), B)
    block_q, block_b = _fused_blocks(index, Q, k + _TOPK_GUARD, block_q,
                                     block_b)
    k_sel = min(k + _TOPK_GUARD, block_b)
    panels = _query_panels(qr, index.alphabet)
    residuals = _masked_residuals(index, valid_mask)
    eps = _seed_eps(index, qr, k, valid_mask)
    eps = _fused_tighten_eps(index, qr, eps, k, k_sel, n_iters, valid_mask,
                             residuals, panels, block_q, block_b)
    idxp, _ = _fused.fused_topk(
        **_fused_inputs(index, qr, residuals, panels, _cascade_eps(eps)),
        k=k_sel, block_q=block_q, block_b=block_b)
    d2v = _reverify_rows(index, qr, idxp, valid_mask)
    nn_idx, nn_d2 = _fused.merge_topk_partials(idxp, d2v, k)
    exact = _topk_exact_certificate(d2v, nn_d2, k, k_sel, block_b)
    return nn_idx, nn_d2, exact


def mixed_query_fused(index: DeviceIndex, qr: QueryReprDev, epsilon, is_knn,
                      k: int, n_iters: int = 2,
                      valid_mask: torch.Tensor | None = None,
                      block_q: int | None = None, block_b: int | None = None):
    """Fused mixed batch in the :func:`mixed_query_dense` layout (the
    reference's ``mixed_query_pallas``).

    k-NN rows tighten through ``n_iters − 1`` fused top-k passes; the
    final pass is the dense fused range form at each row's radius (the
    caller's ε for range rows, the slacked k-NN radius otherwise), so the
    k-NN rows' answer masks are supersets of their exact top-k.  Returns
    ``(idx (Q, B), answer (Q, B), d2 (Q, B), overflow (Q,))`` with
    ``overflow`` all False.
    """
    Q, B = qr.q.shape[0], index.size
    dev = index.device
    k = min(int(k), B)
    knn_col = torch.as_tensor(is_knn, dtype=torch.bool, device=dev).reshape(Q, 1)
    eps_req = _eps_qcol(epsilon, Q, dev)
    panels = _query_panels(qr, index.alphabet)
    residuals = _masked_residuals(index, valid_mask)
    eps = torch.where(knn_col, _seed_eps(index, qr, k, valid_mask), eps_req)
    tq, tb = _fused_blocks(index, Q, k + _TOPK_GUARD, block_q, block_b)
    eps = _fused_tighten_eps(index, qr, eps, k, min(k + _TOPK_GUARD, tb),
                             n_iters, valid_mask, residuals, panels, tq, tb,
                             knn_col=knn_col)
    rq, rb = _fused_blocks(index, Q, 0, block_q, block_b)
    ans, d2 = _fused.fused_range(
        **_fused_inputs(index, qr, residuals, panels,
                        _cascade_eps(eps, knn_col)),
        block_q=rq, block_b=rb)
    ans, d2 = _mask_dense(ans, d2, valid_mask)
    idx = _arange(B, dev, torch.int32)[None, :].expand(Q, B)
    overflow = torch.zeros((Q,), dtype=torch.bool, device=dev)
    return idx, ans, d2, overflow


def compact_answers(answer: torch.Tensor, d2: torch.Tensor, capacity: int):
    """Compact a dense (Q, B) answer mask into ``capacity`` low-index
    slots: ``(idx (Q, C), valid (Q, C), d2 (Q, C), overflow (Q,))``."""
    B = answer.shape[-1]
    capacity = min(int(capacity), B)
    keys = torch.where(answer, B - _arange(B, answer.device)[None, :], 0)
    top, idx = _top_k(keys, capacity)
    valid = top > 0
    d2c = torch.where(valid, torch.gather(d2, -1, idx), INF)
    return idx.to(torch.int32), valid, d2c, answer.sum(dim=-1) > capacity


def range_query_backend(index: DeviceIndex, qr: QueryReprDev, epsilon,
                        options: SearchOptions | None = None, **legacy):
    """Backend-dispatched dense range query: ``(answers, d2)``.  Keywords
    other than the legacy option names pass to the fused engine (tile
    overrides)."""
    opts, fused_kw = resolve_options(options, legacy, "range_query_backend")
    if resolve_backend(opts.backend, index.device) == "cuda":
        return range_query_fused(index, qr, epsilon, **fused_kw)
    return range_query(index, qr, epsilon)


def knn_query_backend(index: DeviceIndex, qr: QueryReprDev, k: int,
                      options: SearchOptions | None = None,
                      valid_mask: torch.Tensor | None = None, **legacy):
    """Backend-dispatched exact k-NN: ``(nn_idx, nn_d2, exact)``.  The
    torch engine escalates capacity until exact; the fused engine computes
    its certificate (on a rare False, re-issue with backend="torch")."""
    opts, fused_kw = resolve_options(options, legacy, "knn_query_backend")
    if resolve_knn_backend(opts.backend, k, index.device) == "cuda":
        return knn_query_fused(index, qr, k, n_iters=opts.n_iters,
                               valid_mask=valid_mask, **fused_kw)
    return knn_query_auto(index, qr, k, capacity=opts.capacity,
                          n_iters=opts.n_iters, valid_mask=valid_mask,
                          max_doublings=opts.max_doublings)


def mixed_query_backend(index: DeviceIndex, qr: QueryReprDev, epsilon, is_knn,
                        k: int, options: SearchOptions | None = None,
                        valid_mask: torch.Tensor | None = None, **legacy):
    """Backend-dispatched mixed batch: ``(idx, answer, d2, overflow)`` in
    the compact layout (torch) or the dense one (cuda)."""
    opts, fused_kw = resolve_options(options, legacy, "mixed_query_backend")
    if resolve_knn_backend(opts.backend, k, index.device) == "cuda":
        return mixed_query_fused(index, qr, epsilon, is_knn, k,
                                 n_iters=opts.n_iters, valid_mask=valid_mask,
                                 **fused_kw)
    return mixed_query_auto(index, qr, epsilon, is_knn, k,
                            capacity=opts.capacity, n_iters=opts.n_iters,
                            valid_mask=valid_mask,
                            max_doublings=opts.max_doublings)
