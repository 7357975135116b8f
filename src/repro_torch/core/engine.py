"""Vectorised FAST_SAX query engine on PyTorch tensors.

Counterpart of ``repro/core/engine.py`` (its whole-series part and the
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

The tiered section at the end serves the same queries from the quantized
resident tier (:class:`TieredIndex`, the ``quantized_*`` engines): the
screen is the CUDA kernel ``fused_quant_range`` on the ``cuda`` backend.

``resolve_backend("auto", device)`` picks ``"cuda"`` for an index on a
CUDA device and ``"torch"`` for one on the CPU.  All device math is
float32, as the reference runs with x64 off; TF32 must stay off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default),
because the top-k certificate's tie window is sized for f32 noise.
"""
from __future__ import annotations

import concurrent.futures as _futures
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..index import quantized as _quant
from ..index import store as _store
from ..kernels import fused_query as _fused
from ..kernels import ops as kernel_ops
from ..kernels import ref as _ref
from . import cost_model as _cost_model
from . import representation as repr_registry
from .fastsax import FastSAXIndex
from .options import SearchOptions, resolve_options
from .paa import paa, row_sum, znormalize
from .polyfit import linfit_residual
from .representation import DEFAULT_STACK
from .sax import discretize

INF = math.inf

#: The ROADMAP.md queue 1 item that extends the device engines to stacks
#: beyond the paper pair.
EXTENDED_STACK_ITEM = 12


def extended_stack_error(what: str, stack) -> NotImplementedError:
    """The refusal of a device path given a stack beyond the paper pair:
    it builds only words and residuals and would drop the extra columns
    without a word.  The host engines of ``core/search.py`` take any
    stack."""
    return NotImplementedError(
        f"{what} with the stack {tuple(stack)}: extended stacks on the "
        f"device engines are not ported (ROADMAP.md queue 1 item "
        f"{EXTENDED_STACK_ITEM}); core/search.py's host engines take it")


def check_device_stack(stack, what: str) -> tuple:
    """Validate ``stack`` and refuse one beyond the paper pair."""
    stack = repr_registry.validate_stack(stack)
    if repr_registry.extra_names(stack):
        raise extended_stack_error(what, stack)
    return stack


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
    def from_store(cls, path, with_ids: bool = False, device=None):
        """Warm start from a committed store directory on ``device``
        (default: CUDA, see :func:`resolve_device`).

        ``path`` is a single-index store (``index.store.save_index``) or a
        ``MutableIndex`` root, which loads through its live view:
        tombstoned rows take no slot, so even a k-NN with k ≥ the live
        count never surfaces a deleted row.  The columns are mmap-opened
        and uploaded by :func:`device_index_from_host`, never rebuilt, so
        the index on the card is bit-identical to the same host index
        uploaded directly.

        The engines answer in row positions.  For a root whose positions
        are not its external ids (rows were deleted), ``with_ids=True``
        returns ``(DeviceIndex, ids)`` with ``ids[pos]`` the external id
        of each row; without it such a store raises rather than let
        positions pass for ids.
        """
        import pathlib

        from ..index import mutable as _mutable

        path = pathlib.Path(path)
        if (path / _mutable.CURRENT).exists():
            host, ids = _mutable.MutableIndex.open(path).live_index()
            ids = np.asarray(ids)
            _check_ids_are_positions(path, ids, with_ids)
        else:
            host = _store.load_index(path, mmap=True)
            ids = np.arange(host.size)
        dev = device_index_from_host(host, device)
        return (dev, ids) if with_ids else dev


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


#: Bytes of one staging chunk of :func:`upload_host_array`.
_UPLOAD_CHUNK_BYTES = 32 << 20

_NUMPY_OF = {torch.float32: np.float32, torch.int32: np.int32,
             torch.int16: np.int16, torch.int8: np.int8}


def upload_host_array(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device``, cast row chunk
    by row chunk.

    ``a`` may be a read-only ``np.memmap`` of a store column (the f64
    series of a 2^20-row store is 1.07 GB): the rows are read once, cast
    into one of two pinned staging buffers and copied to the card with
    ``non_blocking`` copies on the current stream, so neither a second
    full host copy nor a full-size f64 device buffer is made.  The cast
    is numpy's (round to nearest even), the same as ``torch``'s.  On the
    CPU the result is one cast copy.
    """
    a = np.asarray(a)
    np_dtype = _NUMPY_OF[dtype]
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.from_numpy(np.array(a, dtype=np_dtype, copy=True))
    out = torch.empty(a.shape, dtype=dtype, device=dev)
    if a.size == 0:
        return out
    rows = a.shape[0]
    row_bytes = max(1, a[:1].size * np.dtype(np_dtype).itemsize)
    step = max(1, min(rows, _UPLOAD_CHUNK_BYTES // row_bytes))
    stage = [torch.empty((step,) + a.shape[1:], dtype=dtype,
                         pin_memory=True) for _ in range(2)]
    done = [None, None]
    stream = torch.cuda.current_stream(dev)
    for j, lo in enumerate(range(0, rows, step)):
        hi = min(rows, lo + step)
        buf = stage[j % 2]
        if done[j % 2] is not None:
            done[j % 2].synchronize()     # its last copy has left the buffer
        np.copyto(buf.numpy()[:hi - lo], a[lo:hi], casting="same_kind")
        out[lo:hi].copy_(buf[:hi - lo], non_blocking=True)
        done[j % 2] = torch.cuda.Event()
        done[j % 2].record(stream)
    for ev in done:
        if ev is not None:
            ev.synchronize()
    return out


def device_index_from_host(index: FastSAXIndex, device=None) -> DeviceIndex:
    """Upload a host-built index (f64 columns cast to f32 by
    :func:`upload_host_array`, so a store's mmap columns upload without a
    second host copy); the paper stack only."""
    stack = check_device_stack(index.config.stack, "device_index_from_host")
    dev = resolve_device(device)
    series = upload_host_array(index.series, torch.float32, dev)
    return DeviceIndex(
        series=series,
        norms_sq=torch.sum(series * series, dim=-1),
        words=tuple(upload_host_array(lv.words, torch.int32, dev)
                    for lv in index.levels),
        residuals=tuple(upload_host_array(lv.residuals, torch.float32, dev)
                        for lv in index.levels),
        levels=tuple(lv.n_segments for lv in index.levels),
        alphabet=index.config.alphabet,
        stack=stack)


def _check_ids_are_positions(path, ids: np.ndarray, with_ids: bool) -> None:
    """Refuse a ``MutableIndex`` root whose row positions are not its
    external ids (rows were deleted) unless the caller takes the ids."""
    if not with_ids and not np.array_equal(ids, np.arange(ids.size)):
        raise ValueError(
            f"{path}: external ids differ from row positions (rows were "
            "deleted) — call from_store(..., with_ids=True) and map "
            "answers through the returned ids array")


def build_device_index(series, levels: Sequence[int], alphabet: int,
                       normalize: bool = True, stack: tuple = DEFAULT_STACK,
                       device=None) -> DeviceIndex:
    """Offline phase on the device: z-normalise (optionally) and compute
    every level's words and residuals in f32.  ``series`` is a (B, n)
    array or tensor; a tensor stays on its device unless ``device`` is
    given.  The paper stack only."""
    stack = check_device_stack(stack, "build_device_index")
    if device is None and isinstance(series, torch.Tensor):
        device = series.device
    dev = resolve_device(device)
    x = torch.as_tensor(series, device=dev).to(torch.float32)
    if normalize:
        x = znormalize(x)
    x = x.contiguous()
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
    """Represent a (Q, n) batch of queries at every level, on its device
    (the paper stack only)."""
    check_device_stack(stack, "represent_queries")
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


def _fused_blocks(index, Q: int, k_sel: int = 0, block_q: int | None = None,
                  block_b: int | None = None, quant: bool = False):
    """Tiles of a fused pass over ``index`` (a :class:`DeviceIndex`, or a
    :class:`QuantizedDeviceIndex` with ``quant``)."""
    mode = index.mode if quant else None
    if block_q is None or block_b is None:
        bq, bb = kernel_ops.choose_fused_blocks(
            Q, index.size, index.n, index.levels, index.alphabet, k_sel=k_sel,
            quant=mode)
        block_q, block_b = block_q or bq, block_b or bb
    if int(block_q) not in kernel_ops.FUSED_BLOCK_Q or int(block_b) % 64:
        raise ValueError(f"block_q must be one of {kernel_ops.FUSED_BLOCK_Q} "
                         f"and block_b a multiple of 64, got {block_q}, "
                         f"{block_b}")
    need = kernel_ops.fused_smem_bytes(int(block_q), index.n, index.levels,
                                       index.alphabet, Q, k_sel, mode)
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
    """Per level the (Q, α, N) MINDIST panels the plain versions take (the
    kernels take the query words)."""
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


def _fused_inputs(index: DeviceIndex, qr: QueryReprDev, residuals,
                  eps_col: torch.Tensor) -> dict:
    return dict(series=index.series, norms_sq=index.norms_sq,
                words=index.words, residuals=residuals, q=qr.q,
                q_words=qr.words, q_residuals=qr.residuals,
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
                       residuals, block_q, block_b, knn_col=None):
    """Fused twin of :func:`_tighten_eps`: each pass is one
    ``fused_topk`` read whose re-verified partials shrink the k-NN rows'
    radius (the reference's ``_fused_tighten_eps``)."""
    for _ in range(max(0, int(n_iters) - 1)):
        idxp, _ = _fused.fused_topk(
            **_fused_inputs(index, qr, residuals,
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
    residuals = _masked_residuals(index, valid_mask)
    eps = _seed_eps(index, qr, k, valid_mask)
    eps = _fused_tighten_eps(index, qr, eps, k, k_sel, n_iters, valid_mask,
                             residuals, block_q, block_b)
    idxp, _ = _fused.fused_topk(
        **_fused_inputs(index, qr, residuals, _cascade_eps(eps)),
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
    residuals = _masked_residuals(index, valid_mask)
    eps = torch.where(knn_col, _seed_eps(index, qr, k, valid_mask), eps_req)
    tq, tb = _fused_blocks(index, Q, k + _TOPK_GUARD, block_q, block_b)
    eps = _fused_tighten_eps(index, qr, eps, k, min(k + _TOPK_GUARD, tb),
                             n_iters, valid_mask, residuals, tq, tb,
                             knn_col=knn_col)
    rq, rb = _fused_blocks(index, Q, 0, block_q, block_b)
    ans, d2 = _fused.fused_range(
        **_fused_inputs(index, qr, residuals, _cascade_eps(eps, knn_col)),
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


# ---------------------------------------------------------------------------
# The quantized resident tier (``index/quantized.py``): the screen columns
# stay on the device as int8 or bf16 with widened bounds, the raw rows
# stay in host memory, and only the screen's survivors are fetched and
# exactly verified, so the answers are set-identical to the
# full-precision engine.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedDeviceIndex:
    """The resident tier's columns on one device.

    ``series``: (B, n) int8 codes or bf16; ``series_scale`` /
    ``series_zero``: (B,) f32 per-row affine (int8 only, else None);
    ``series_err``: (B,) f32 ‖u − û‖₂ bound; ``norms_sq``: (B,) f32 ‖û‖²
    of the dequantized rows; per level ``words``: (B, N_l) int8,
    ``residuals``: (B,) int8 codes or bf16, ``resid_scale`` /
    ``resid_zero`` (int8 only, else None) and ``resid_err``: (nb,) f32
    per block of ``index.quantized.RESID_BLOCK`` rows.
    """

    series: torch.Tensor
    series_scale: torch.Tensor | None
    series_zero: torch.Tensor | None
    series_err: torch.Tensor
    norms_sq: torch.Tensor
    words: tuple
    residuals: tuple
    resid_scale: tuple
    resid_zero: tuple
    resid_err: tuple
    levels: tuple = ()
    alphabet: int = 10
    mode: str = "int8"
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


def _upload_codes(codes, dev) -> torch.Tensor:
    """A host quantized column on the device: uint16 bf16 bit patterns
    become ``torch.bfloat16`` by a view (no rounding), int8 codes upload
    as they are (a store's mmap column too, by
    :func:`upload_host_array`)."""
    codes = np.asarray(codes)
    if codes.dtype == np.uint16:
        return upload_host_array(codes.view(np.int16), torch.int16,
                                 dev).view(torch.bfloat16)
    if codes.dtype != np.int8:
        raise _quant.QuantizationError(
            f"quantized codes must be int8 or uint16 (bf16 bits), got "
            f"{codes.dtype}")
    return upload_host_array(codes, torch.int8, dev)


def quantized_device_index(qhost, device=None) -> QuantizedDeviceIndex:
    """Carry a resident tier to the device (default: CUDA, see
    :func:`resolve_device`).  ``qhost`` is any object with the numpy
    fields of ``index.quantized.QuantizedHostIndex`` — the port's, or the
    reference's handed over as it is.  Per-block and per-row columns
    become (m,) f32."""
    dev = resolve_device(device)
    int8 = _quant.check_mode(qhost.mode) == "int8"
    stack = check_device_stack(getattr(qhost, "stack", DEFAULT_STACK),
                               "quantized_device_index")
    extras = sorted({name for lv in qhost.levels
                     for name in getattr(lv, "extra", {})})
    if extras:
        raise extended_stack_error("quantized_device_index",
                                   stack + tuple(extras))

    def col(a):
        return upload_host_array(np.asarray(a).reshape(-1), torch.float32,
                                 dev)

    return QuantizedDeviceIndex(
        series=_upload_codes(qhost.series, dev),
        series_scale=col(qhost.series_scale) if int8 else None,
        series_zero=col(qhost.series_zero) if int8 else None,
        series_err=col(qhost.series_err),
        norms_sq=col(qhost.norms_sq),
        words=tuple(_upload_codes(np.asarray(lv.words, np.int8), dev)
                    for lv in qhost.levels),
        residuals=tuple(_upload_codes(lv.residuals, dev)
                        for lv in qhost.levels),
        resid_scale=tuple(col(lv.scale) if int8 else None
                          for lv in qhost.levels),
        resid_zero=tuple(col(lv.zero) if int8 else None
                         for lv in qhost.levels),
        resid_err=tuple(col(lv.err) for lv in qhost.levels),
        levels=tuple(int(lv.n_segments) for lv in qhost.levels),
        alphabet=int(qhost.alphabet),
        mode=qhost.mode,
        stack=stack)


#: (nb,) per scale block -> (B,) per row.
_expand_block_col = _ref.expand_block_col


def _dequant_residuals_dev(qindex: QuantizedDeviceIndex, li: int):
    """(B,) dequantized residuals of level ``li`` (``zero + scale · code``;
    the sentinel code decodes to PAD_RESIDUAL)."""
    return _ref.dequant_residuals(qindex.residuals[li],
                                  qindex.resid_scale[li],
                                  qindex.resid_zero[li])


def _dequant_series_dev(qindex: QuantizedDeviceIndex) -> torch.Tensor:
    """(B, n) dequantized rows û (f32)."""
    return _ref.dequant_series(qindex.series, qindex.series_scale,
                               qindex.series_zero)


def _eps_vec(epsilon, Q: int, device) -> torch.Tensor:
    return _eps_qcol(epsilon, Q, device).reshape(-1).contiguous()


def quantized_cascade_mask(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                           epsilon) -> torch.Tensor:
    """(Q, B) widened cascade over the quantized columns: C9 ``|r̂(u) −
    r(q)| ≤ ε + e_blk``, C10 unwidened on the lossless int8 words."""
    Q = qr.q.shape[0]
    return _ref.quant_cascade_alive_ref(
        qindex, _query_panels(qr, qindex.alphabet), qr.residuals,
        _eps_vec(epsilon, Q, qindex.device))


def quantized_screen(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                     epsilon):
    """The whole quantized screen in plain tensor code: ``(keep (Q, B),
    d̂² (Q, B))``.  ``keep`` marks rows that may be answers — a row with
    d(û, q) > ε + e_u has d(u, q) > ε — and the caller verifies them
    exactly against the raw tier.  The oracle the CUDA kernel
    ``fused_quant_range`` is held against."""
    Q = qr.q.shape[0]
    return _ref.fused_quant_range_ref(
        qindex, qr.q, _query_panels(qr, qindex.alphabet), qr.residuals,
        _eps_vec(epsilon, Q, qindex.device))


def _compact_mask(keep: torch.Tensor, capacity: int):
    """Low-index compaction of a dense keep mask: ``(idx (Q, C) int32,
    valid (Q, C), overflow (Q,))``.  Slot j of a row holds its j-th kept
    row, so slot order is row order; dead slots hold row 0."""
    Q, B = keep.shape
    capacity = min(int(capacity), B)
    count = keep.sum(dim=-1)
    pos = torch.cumsum(keep, dim=-1) - 1
    qi, bi = torch.nonzero(keep & (pos < capacity), as_tuple=True)
    idx = torch.zeros((Q, capacity), dtype=torch.int32, device=keep.device)
    idx[qi, pos[qi, bi]] = bi.to(torch.int32)
    valid = _arange(capacity, keep.device)[None, :] < count[:, None]
    return idx, valid, count > capacity


def _compact_escalated(keep: torch.Tensor, capacity: int,
                       max_doublings: int):
    """:func:`_compact_mask` at the first capacity of ``capacity``,
    4·capacity, … (capped at B) that no row overflows, or after
    ``max_doublings`` escalations."""
    B = keep.shape[-1]
    most = int(keep.sum(dim=-1).max())
    cap = min(B, int(capacity))
    for _ in range(max_doublings):
        if cap >= B or most <= cap:
            break
        cap = min(B, cap * 4)
    return _compact_mask(keep, cap)


@dataclasses.dataclass
class TieredIndex:
    """Two-tier serving index: the quantized screen on the device
    (``dev``), the (B, n) full-precision rows in host memory (``raw``:
    float32, or a store's float64 mmap), read only for the rows the
    screen could not exclude (as float32).
    ``ids`` (optional) maps row positions to external ids."""

    dev: QuantizedDeviceIndex
    raw: np.ndarray
    ids: np.ndarray | None = None

    @property
    def size(self) -> int:
        return self.dev.size

    @property
    def mode(self) -> str:
        return self.dev.mode

    @classmethod
    def from_host(cls, index: FastSAXIndex, mode: str,
                  ids: np.ndarray | None = None,
                  device=None) -> "TieredIndex":
        """Quantize a built host index into the tiered layout: the
        resident tier on ``device`` (default: CUDA), the raw tier as one
        f32 array."""
        qhost = _quant.quantize_host_index(index, mode)
        return cls(dev=quantized_device_index(qhost, device),
                   raw=np.asarray(index.series, np.float32), ids=ids)

    @classmethod
    def from_store(cls, path, quantization: str | None = None,
                   with_ids: bool = False, device=None):
        """Warm start the tiered layout from a committed store directory:
        the resident tier on ``device`` (default: CUDA), the raw tier the
        store's mmap f64 series.

        A plain store saved with a matching ``quantization`` serves its
        stored quantized columns as they are (no requantization); a store
        without a tier, or with another mode, is quantized in memory from
        its full-precision columns.  A ``MutableIndex`` root defaults to
        its epoch's mode (else int8); a compacted root serves its base
        segment's stored tier the same way, while a root with deltas or
        tombstones quantizes its live view in memory (a scale block of
        live rows straddles segments).  ``quantization=None`` takes the
        stored mode, else int8.  ``with_ids`` as in
        :meth:`DeviceIndex.from_store`.
        """
        import pathlib

        from ..index import mutable as _mutable

        path = pathlib.Path(path)
        if (path / _mutable.CURRENT).exists():
            mut = _mutable.MutableIndex.open(path)
            mode = quantization or (
                mut.quantization if mut.quantization != "none" else "int8")
            host, ids = mut.live_index()
            ids = np.asarray(ids)
            _check_ids_are_positions(path, ids, with_ids)
            keep = ids if with_ids else None
            if mut.compacted and mut.quantization == mode:
                tiered = cls._from_stored_tier(mut.base_dir, mode, keep,
                                               device)
            else:
                tiered = cls.from_host(host, mode, ids=keep, device=device)
            return (tiered, ids) if with_ids else tiered
        manifest = _store.read_manifest(path)
        stored = _store.quantized_mode(manifest)
        mode = quantization or (stored if stored != "none" else "int8")
        if stored == mode:
            tiered = cls._from_stored_tier(path, mode, None, device)
        else:
            tiered = cls.from_host(_store.load_index(path, mmap=True), mode,
                                   device=device)
        ids = np.arange(tiered.size)
        return (tiered, ids) if with_ids else tiered

    @classmethod
    def _from_stored_tier(cls, path, mode: str, ids,
                          device) -> "TieredIndex":
        """A store's own quantized columns on the device and its series as
        the raw tier, both from the mmap."""
        qhost = _store.load_quantized(path, mmap=True, mode=mode)
        raw = _store.read_array(path, "series", mmap=True)
        return cls(dev=quantized_device_index(qhost, device), raw=raw,
                   ids=ids)


def _quantized_screen_backend(tindex: TieredIndex, qr: QueryReprDev,
                              eps_col, backend: str):
    """The dense quantized screen: the CUDA kernel ``fused_quant_range``
    on the ``cuda`` backend (on a CUDA index it launches or raises), the
    plain oracle :func:`quantized_screen` on ``torch``."""
    qdev = tindex.dev
    if resolve_backend(backend, qdev.device) == "torch":
        return quantized_screen(qdev, qr, eps_col)
    Q = qr.q.shape[0]
    block_q, block_b = _fused_blocks(qdev, Q, quant=True)
    return _fused.fused_quant_range(
        qdev, qr.q, qr.words, qr.residuals,
        _eps_vec(eps_col, Q, qdev.device), block_q=block_q, block_b=block_b)


def _raw_rows(raw, ids: torch.Tensor, device) -> torch.Tensor:
    """Raw-tier rows of the (M,) row ids, uploaded as f32 — the only touch
    of full-precision data on the query path."""
    return torch.as_tensor(_store.gather_rows(raw, ids.cpu().numpy()),
                           device=device)


def _verify_gathered(rows: torch.Tensor, q_rows: torch.Tensor) -> torch.Tensor:
    """Exact diff²-form distances of gathered raw rows against their
    queries, (M,).  Summed with :func:`paa.row_sum`, so a row's distance
    does not depend on how many rows were gathered with it (a request
    served alone verifies a smaller capacity than in its batch)."""
    diff = rows - q_rows
    return row_sum(diff * diff)


#: Chunks of the prefetched verify: chunk j+1's host gather runs on the
#: worker thread while chunk j uploads and verifies on the device.
_PREFETCH_CHUNKS = 2


def _verify_prefetched(raw, ids: torch.Tensor, q: torch.Tensor,
                       qi: torch.Tensor) -> torch.Tensor:
    """Double-buffered raw-tier verify of the (M,) row ids against their
    queries ``q[qi]``.

    The ids split into :data:`_PREFETCH_CHUNKS` spans.  One worker thread
    gathers span j+1 from the raw tier into a staging buffer (pinned on a
    CUDA device) while span j uploads with a ``non_blocking`` copy on the
    current stream and verifies.  The verify is row-local, so the result
    is the synchronous path's, bit for bit.  A fault in the worker
    re-raises here.
    """
    M, n = int(ids.shape[0]), int(raw.shape[1])
    dev = q.device
    if M == 0:
        return torch.empty((0,), dtype=torch.float32, device=dev)
    nchunks = max(1, min(_PREFETCH_CHUNKS, M))
    bounds = [(M * i) // nchunks for i in range(nchunks + 1)]
    spans = [(lo, hi) for lo, hi in zip(bounds, bounds[1:]) if hi > lo]
    ids_np = ids.cpu().numpy()
    pin = dev.type == "cuda"

    def fetch(lo: int, hi: int) -> torch.Tensor:
        buf = torch.empty((hi - lo, n), dtype=torch.float32, pin_memory=pin)
        _store.gather_rows(raw, ids_np[lo:hi], out=buf.numpy())
        return buf

    parts = []
    with _futures.ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(fetch, *spans[0])
        for j, (lo, hi) in enumerate(spans):
            buf = fut.result()
            if j + 1 < len(spans):
                fut = pool.submit(fetch, *spans[j + 1])
            rows = buf.to(dev, non_blocking=True)
            parts.append(_verify_gathered(rows, q[qi[lo:hi]]))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _verify_tier(raw, idx: torch.Tensor, q: torch.Tensor, valid: torch.Tensor,
                 opts: SearchOptions) -> torch.Tensor:
    """The raw-tier exact verify behind every tiered engine: (Q, C) d²,
    +inf on dead slots.  Only the valid slots' rows are fetched — the
    reference gathers all Q·C slots — synchronously, or double-buffered
    when ``opts.verify_prefetch`` (the same d², bit for bit)."""
    qi, si = torch.nonzero(valid, as_tuple=True)
    ids = idx[qi, si]
    if opts.verify_prefetch:
        d2v = _verify_prefetched(raw, ids, q, qi)
    else:
        d2v = _verify_gathered(_raw_rows(raw, ids, q.device), q[qi])
    d2 = torch.full(valid.shape, INF, dtype=torch.float32, device=q.device)
    d2[qi, si] = d2v
    return d2


def _quant_options(options, legacy: dict, caller: str) -> SearchOptions:
    """The options of a ``quantized_*`` entry point; a legacy positional
    ``capacity`` (int) in the ``options`` slot goes through the
    deprecation shim, and unknown keywords raise."""
    if isinstance(options, int):
        legacy["capacity"], options = options, None
    opts, rest = resolve_options(options, legacy, caller)
    if rest:
        raise TypeError(f"{caller}: unexpected kwargs {sorted(rest)}")
    return opts


def quantized_range_query(tindex: TieredIndex, qr: QueryReprDev, epsilon,
                          options: SearchOptions | None = None, **legacy):
    """Exact range query over the tiered index.

    Screens the resident tier (widened bounds: no true answer is
    excluded), compacts the survivors, fetches only their rows from the
    raw tier and verifies them exactly in the diff² form.  Capacity
    escalates 4× on overflow up to B, so the certificate is True on
    return.  Returns ``(idx (Q, C), answer (Q, C), d2 (Q, C), exact
    (Q,))``, set-identical to :func:`range_query_compact`.
    """
    opts = _quant_options(options, legacy, "quantized_range_query")
    Q, dev = qr.q.shape[0], tindex.dev.device
    eps = _eps_qcol(epsilon, Q, dev)
    keep, _ = _quantized_screen_backend(tindex, qr, eps, opts.backend)
    cap = 64 if opts.capacity is None else max(1, int(opts.capacity))
    idx, valid, overflow = _compact_escalated(keep, cap, opts.max_doublings)
    d2 = _verify_tier(tindex.raw, idx, qr.q, valid, opts)
    answer = valid & (d2 <= eps * eps)
    return idx, answer, torch.where(answer, d2, INF), ~overflow


def _sample_eps(rows: torch.Tensor, q: torch.Tensor, k: int) -> torch.Tensor:
    """Seed radius from verified sample rows: the (Q, 1) k-th sampled
    distance, an upper bound of the true k-th distance.  A non-finite
    radius becomes ``_SEED_EPS_MAX``."""
    diff = rows[None, :, :] - q[:, None, :]
    d2s = row_sum(diff * diff)                           # (Q, S)
    eps = torch.sqrt(torch.clamp(_kth_smallest(d2s, k), min=0.0))
    return torch.where(torch.isfinite(eps), eps,
                       torch.full_like(eps, _SEED_EPS_MAX))


def _tiered_seed_eps(tindex: TieredIndex, qr: QueryReprDev,
                     k: int) -> torch.Tensor:
    """k-NN seed radius of the tiered engine, from a strided sample of the
    RAW tier (the positions of :func:`_seed_eps`).  The sample strides
    over the raw tier's own row count: a screen tier padded beyond it
    would otherwise sample a pad row and shrink the radius below the true
    k-th distance."""
    R = int(tindex.raw.shape[0])
    dev = tindex.dev.device
    if R == 0:
        return torch.zeros((qr.q.shape[0], 1), dtype=torch.float32,
                           device=dev)
    S = min(R, max(k, _KNN_SEED_SAMPLE))
    sample = (np.arange(S) * R) // S
    rows = torch.as_tensor(np.asarray(tindex.raw[sample], np.float32),
                           device=dev)
    return _sample_eps(rows, qr.q, k)


def quantized_knn_query(tindex: TieredIndex, qr: QueryReprDev, k: int,
                        options: SearchOptions | None = None, **legacy):
    """Exact k-NN over the tiered index: ``(nn_idx, nn_d2, exact)``.

    Seeds each query's radius from a verified raw-tier sample, screens
    the resident tier at the slacked radius (every true neighbour has
    d ≤ ε and the widened screen never kills such a row), verifies the
    survivors against the raw tier and takes their k smallest, ties to
    the lowest row.  Capacity escalates up to B, so ``exact`` is True on
    return.
    """
    opts = _quant_options(options, legacy, "quantized_knn_query")
    B = tindex.size
    k_eff = min(int(k), B)
    eps = _tiered_seed_eps(tindex, qr, k_eff)
    keep, _ = _quantized_screen_backend(tindex, qr, _slacked(eps),
                                        opts.backend)
    cap = max(4 * k_eff, 64) if opts.capacity is None else int(opts.capacity)
    cap = max(min(B, cap), k_eff)
    idx, valid, overflow = _compact_escalated(keep, cap, opts.max_doublings)
    d2 = _verify_tier(tindex.raw, idx, qr.q, valid, opts)
    nn_d2, pos = _bottom_k(d2, k_eff)
    nn_idx = torch.gather(idx, -1, pos)
    nn_idx = torch.where(torch.isfinite(nn_d2), nn_idx,
                         torch.full_like(nn_idx, -1))
    return nn_idx, nn_d2, ~overflow


def quantized_mixed_query(tindex: TieredIndex, qr: QueryReprDev, epsilon,
                          is_knn, k: int,
                          options: SearchOptions | None = None, **legacy):
    """Mixed range / k-NN batch over the tiered index, in the serving
    layout of :func:`mixed_query`.

    Range rows screen at the caller's ε (the widening is the screen's),
    k-NN rows at their slacked seeded radius; one compaction and one
    raw-tier verify serve both.  Returns ``(idx, answer, d2, overflow)``
    with ``overflow`` all False after escalation; a k-NN row's ``answer``
    marks its valid candidates, a verified superset of its top-k
    (:func:`mixed_topk`).
    """
    opts = _quant_options(options, legacy, "quantized_mixed_query")
    Q, B, dev = qr.q.shape[0], tindex.size, tindex.dev.device
    k_eff = min(int(k), B)
    knn_col = torch.as_tensor(is_knn, dtype=torch.bool,
                              device=dev).reshape(Q, 1)
    eps_req = _eps_qcol(epsilon, Q, dev)
    eps = torch.where(knn_col,
                      _slacked(_tiered_seed_eps(tindex, qr, k_eff)), eps_req)
    keep, _ = _quantized_screen_backend(tindex, qr, eps, opts.backend)
    cap = max(4 * k_eff, 64) if opts.capacity is None else int(opts.capacity)
    cap = max(min(B, cap), k_eff)
    idx, valid, overflow = _compact_escalated(keep, cap, opts.max_doublings)
    d2 = _verify_tier(tindex.raw, idx, qr.q, valid, opts)
    answer = torch.where(knn_col, valid, valid & (d2 <= eps_req * eps_req))
    return idx, answer, torch.where(answer, d2, INF), overflow
