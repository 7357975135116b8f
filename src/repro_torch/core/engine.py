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
CUDA device and ``"torch"`` for one on the CPU.  An index built with a
stack beyond the paper pair (``core/representation.py``, e.g. with
``trend_slope``) carries the extra columns in ``extra``.  The torch
engine's cascade applies them (:func:`cascade_mask`); the fused kernels
run the paper pair's cascade and verify its survivors exactly, so they
return the same answers (an extra only prunes rows a lower bound already
places beyond ε) and stay on the path for any stack.  The extras' kills
show in the counting pass of the traced twins, and the tier's screen
applies them to kernel 5's kept rows.  All device math is
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
from ..obs.trace import QueryTrace, screen_row_bytes, tier_bytes
from . import cost_model as _cost_model
from . import representation as repr_registry
from .fastsax import FastSAXIndex
from .options import SearchOptions, resolve_options
from .paa import paa, row_sum, znormalize
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
    device; ``levels`` in cascade visit order.  ``extra[l]`` holds the
    columns of the stack's representations beyond the paper pair, one
    ``{name: column}`` dict per level (word-kind (B, N_l) int32, gap-kind
    (B,) f32); the paper stack leaves it ``()``.
    """

    series: torch.Tensor
    norms_sq: torch.Tensor
    words: tuple
    residuals: tuple
    extra: tuple = ()
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


def _extra_dtype(name: str) -> torch.dtype:
    """Device dtype of an extra column: int32 symbols (word-kind), f32
    values (gap-kind)."""
    return (torch.int32 if repr_registry.get(name).kind == "word"
            else torch.float32)


def _dev_extra_levels(x: torch.Tensor, levels, alphabet: int,
                      stack: tuple) -> tuple:
    """Per level, the ``{name: column}`` dict of the stack's extra
    representations of a (B, n) or (Q, n) tensor, symbolized on its
    device by each one's ``symbolize_dev``; ``()`` for the paper stack."""
    extras = repr_registry.extra_names(stack)
    if not extras:
        return ()
    return tuple(
        {name: repr_registry.get(name).symbolize_dev(x, int(N), alphabet)
         .to(_extra_dtype(name)).contiguous() for name in extras}
        for N in levels)


def device_index_from_host(index: FastSAXIndex, device=None) -> DeviceIndex:
    """Upload a host-built index (f64 columns cast to f32 by
    :func:`upload_host_array`, so a store's mmap columns upload without a
    second host copy), the stack's extra columns with it."""
    stack = repr_registry.validate_stack(index.config.stack)
    dev = resolve_device(device)
    series = upload_host_array(index.series, torch.float32, dev)
    extras = repr_registry.extra_names(stack)
    return DeviceIndex(
        series=series,
        norms_sq=torch.sum(series * series, dim=-1),
        words=tuple(upload_host_array(lv.words, torch.int32, dev)
                    for lv in index.levels),
        residuals=tuple(upload_host_array(lv.residuals, torch.float32, dev)
                        for lv in index.levels),
        extra=tuple({name: upload_host_array(lv.extra[name],
                                             _extra_dtype(name), dev)
                     for name in extras}
                    for lv in index.levels) if extras else (),
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
    every level's words, residuals and the stack's extra columns in f32.
    ``series`` is a (B, n) array or tensor; a tensor stays on its device
    unless ``device`` is given."""
    stack = repr_registry.validate_stack(stack)
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
        extra=_dev_extra_levels(x, levels, alphabet, stack),
        levels=tuple(int(N) for N in levels),
        alphabet=int(alphabet),
        stack=stack)


@dataclasses.dataclass(frozen=True)
class QueryReprDev:
    """Device query representation: ``q`` (Q, n) f32 and, per level,
    ``words`` (Q, N) int32 and ``residuals`` (Q,) f32; ``extra`` mirrors
    :attr:`DeviceIndex.extra` (``()`` for the paper stack)."""

    q: torch.Tensor
    words: tuple
    residuals: tuple
    extra: tuple = ()


def represent_queries(q: torch.Tensor, levels: Sequence[int], alphabet: int,
                      normalize: bool = True,
                      stack: tuple = DEFAULT_STACK) -> QueryReprDev:
    """Represent a (Q, n) batch of queries at every level, on its device.
    ``stack`` must be the index's: its extras are represented too."""
    stack = repr_registry.validate_stack(stack)
    if normalize:
        q = znormalize(q)
    q = q.to(torch.float32).contiguous()
    return QueryReprDev(
        q=q,
        words=tuple(discretize(paa(q, N), alphabet) for N in levels),
        residuals=tuple(linfit_residual(q, N).to(torch.float32).contiguous()
                        for N in levels),
        extra=_dev_extra_levels(q, levels, alphabet, stack))


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


def _extra_reps(index) -> tuple:
    """The index stack's extra representations, split ``(gap, word)``."""
    reps = [repr_registry.get(name) for name in
            repr_registry.extra_names(getattr(index, "stack", DEFAULT_STACK))]
    return ([r for r in reps if r.kind == "gap"],
            [r for r in reps if r.kind == "word"])


def _extra_gap_ok(rep, index, qr: QueryReprDev, li: int, eps,
                  rows=slice(None)) -> torch.Tensor:
    """(Q, rows) gap-kind extra test ``gap ≤ ε`` of level ``li``."""
    return rep.dev_gap(index.extra[li][rep.name][rows],
                       qr.extra[li][rep.name]) <= eps


def _extra_word_ok(rep, index, qr: QueryReprDev, li: int, eps2, tab,
                   rows=slice(None)) -> torch.Tensor:
    """(Q, rows) word-kind extra test ``bound² ≤ ε²`` of level ``li``
    (``tab`` the MINDIST table; int8 tier columns widen in the gather)."""
    return rep.dev_bound_sq(index.extra[li][rep.name][rows],
                            qr.extra[li][rep.name], n=index.n,
                            N=index.levels[li], tab=tab) <= eps2


def cascade_mask(index: DeviceIndex, qr: QueryReprDev, epsilon) -> torch.Tensor:
    """(Q, B) alive mask of the exclusion cascade: True = candidate.  Per
    level, the stack's gap-kind extras run after C9 and its word-kind
    extras after C10."""
    n, dev = index.n, index.device
    Q = qr.q.shape[0]
    eps = _eps_qcol(epsilon, Q, dev)
    eps2 = eps * eps
    alive = torch.ones((Q, index.size), dtype=torch.bool, device=dev)
    tab = _mindist_sq_tab(index.alphabet, dev)
    gap_extras, word_extras = _extra_reps(index)
    for li, N in enumerate(index.levels):
        # C9: |d(u,ū) − d(q,q̄)| > ε  → kill.
        gap = torch.abs(index.residuals[li][None, :] - qr.residuals[li][:, None])
        alive &= gap <= eps
        for rep in gap_extras:
            alive &= _extra_gap_ok(rep, index, qr, li, eps)
        # C10: MINDIST²(q̃,ũ) > ε² → kill.
        cell = tab[index.words[li].long()[None, :, :],
                   qr.words[li].long()[:, None, :]]
        md_sq = (n / N) * torch.sum(cell * cell, dim=-1)
        alive &= md_sq <= eps2
        for rep in word_extras:
            alive &= _extra_word_ok(rep, index, qr, li, eps2, tab)
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
    (diff² form, summed with ``paa.row_sum``, so a row's distance does not
    depend on the capacity or on :func:`dense_diff_sq`'s chunks).  Slots
    fill lowest index first, or by ``order_key`` (higher first) when
    given.  Returns ``(idx (Q, C) int32, valid (Q, C), d2 (Q, C))`` with
    +inf on invalid slots."""
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
    d2 = row_sum(diff * diff)
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


#: Elements of one (Q, rows, n) difference chunk of :func:`dense_diff_sq`
#: (1 GiB of f32).
_DENSE_CHUNK_ELEMS = 1 << 28


def dense_diff_sq(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(Q, R) d² of every (R, n) row against every (Q, n) query in
    :func:`compact_verify`'s diff² form (``paa.row_sum``), over row chunks
    of bounded memory: a row's distance is the one the compacting path
    verifies it with, whatever the layout or the chunk."""
    Q, n = q.shape
    step = max(1, _DENSE_CHUNK_ELEMS // max(1, Q * n))
    parts = []
    for lo in range(0, rows.shape[0], step):
        diff = rows[None, lo:lo + step, :] - q[:, None, :]
        parts.append(row_sum(diff * diff))
    return torch.cat(parts, dim=-1) if parts else \
        torch.zeros((Q, 0), dtype=torch.float32, device=q.device)


def mixed_query_dense(index: DeviceIndex, qr: QueryReprDev, epsilon, is_knn,
                      k: int, valid_mask: torch.Tensor | None = None):
    """Dense-verify form of :func:`mixed_query`: range rows are the
    cascade's survivors within ε, k-NN rows are answered over every valid
    row.  The distances are :func:`compact_verify`'s diff² form, so a
    request gets the same ids and distances in either layout (the
    service's dense switch keeps replays exact).  Cannot overflow; same
    return convention with C = B."""
    del k
    Q, B = qr.q.shape[0], index.size
    dev = index.device
    knn_col = torch.as_tensor(is_knn, dtype=torch.bool, device=dev).reshape(Q, 1)
    eps = _eps_qcol(epsilon, Q, dev)
    alive = cascade_mask(index, qr, eps)
    d2 = dense_diff_sq(qr.q, index.series)
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
    d2 = row_sum(diff * diff)
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
    per block of ``index.quantized.RESID_BLOCK`` rows; ``extra``: per
    level ``{name: (B, N_l) int8}`` symbols of the stack's word-kind
    extras (lossless; the host tier refuses gap-kind extras).
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
    extra: tuple = ()
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
    become (m,) f32; the word-kind extras' int8 symbols upload as they
    are."""
    dev = resolve_device(device)
    int8 = _quant.check_mode(qhost.mode) == "int8"
    stack = repr_registry.validate_stack(getattr(qhost, "stack",
                                                 DEFAULT_STACK))
    extras = repr_registry.extra_names(stack)
    for lv in qhost.levels:
        stray = sorted(set(getattr(lv, "extra", {})) - set(extras))
        if stray:
            raise ValueError(
                f"quantized level N={lv.n_segments} carries the columns "
                f"{stray}, which the stack {stack} does not name")

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
        extra=tuple({name: _upload_codes(np.asarray(lv.extra[name], np.int8),
                                         dev)
                     for name in extras}
                    for lv in qhost.levels) if extras else (),
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


def _quant_extras_ok(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                     eps) -> torch.Tensor | None:
    """(Q, B) AND over the levels of the stack's word-kind extra tests on
    the int8 symbols, unwidened (they are lossless); None for the paper
    stack."""
    _, word_extras = _extra_reps(qindex)
    if not word_extras:
        return None
    eps2 = eps * eps
    tab = _mindist_sq_tab(qindex.alphabet, qindex.device)
    ok = None
    for li in range(len(qindex.levels)):
        for rep in word_extras:
            t = _extra_word_ok(rep, qindex, qr, li, eps2, tab)
            ok = t if ok is None else ok & t
    return ok


def quantized_cascade_mask(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                           epsilon) -> torch.Tensor:
    """(Q, B) widened cascade over the quantized columns: C9 ``|r̂(u) −
    r(q)| ≤ ε + e_blk``, C10 and the stack's word-kind extras unwidened
    on the lossless int8 symbols."""
    Q = qr.q.shape[0]
    eps = _eps_qcol(epsilon, Q, qindex.device)
    alive = _ref.quant_cascade_alive_ref(
        qindex, _query_panels(qr, qindex.alphabet), qr.residuals,
        eps.reshape(-1).contiguous())
    ok = _quant_extras_ok(qindex, qr, eps)
    return alive if ok is None else alive & ok


def quantized_screen(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                     epsilon):
    """The whole quantized screen in plain tensor code: ``(keep (Q, B),
    d̂² (Q, B))``.  ``keep`` marks rows that may be answers — a row with
    d(û, q) > ε + e_u has d(u, q) > ε — and the caller verifies them
    exactly against the raw tier.  The oracle the CUDA kernel
    ``fused_quant_range`` is held against; an extended stack's word-kind
    extras screen too (:func:`quantized_cascade_mask`)."""
    Q = qr.q.shape[0]
    eps = _eps_qcol(epsilon, Q, qindex.device)
    keep, d2 = _ref.fused_quant_range_ref(
        qindex, qr.q, _query_panels(qr, qindex.alphabet), qr.residuals,
        eps.reshape(-1).contiguous())
    ok = _quant_extras_ok(qindex, qr, eps)
    if ok is None:
        return keep, d2
    keep = keep & ok
    return keep, torch.where(keep, d2, INF)


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


def _screen_kept_extras(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                        eps, keep: torch.Tensor, d2: torch.Tensor):
    """Kernel 5's ``(keep, d̂²)`` with the stack's word-kind extra tests
    of :func:`quantized_screen` applied to the kept rows only: each kept
    (query, row) pair gathers its int8 symbols, so the extras cost the
    survivors and not B.  Each bound is the representation's
    ``dev_bound_sq`` of that pair (a query of one row), summed with
    ``paa.row_sum``: pair for pair the dense screen's.  The paper stack
    passes through."""
    _, word_extras = _extra_reps(qindex)
    if not word_extras:
        return keep, d2
    qi, bi = torch.nonzero(keep, as_tuple=True)
    eps = _eps_qcol(eps, keep.shape[0], keep.device)
    eps2 = (eps * eps)[qi, 0]
    tab = _mindist_sq_tab(qindex.alphabet, keep.device)
    ok = torch.ones_like(qi, dtype=torch.bool)
    for li, N in enumerate(qindex.levels):
        for rep in word_extras:
            bound = rep.dev_bound_sq(
                qindex.extra[li][rep.name][bi][:, None, :],
                qr.extra[li][rep.name][qi], n=qindex.n, N=N, tab=tab)
            ok &= bound[:, 0] <= eps2
    kept = torch.zeros_like(keep)
    kept[qi[ok], bi[ok]] = True
    return kept, torch.where(kept, d2, INF)


def _kernel5_screen(qindex: QuantizedDeviceIndex, qr: QueryReprDev, eps):
    """The screen of the ``cuda`` backend: the CUDA kernel
    ``fused_quant_range`` (its plain version on a CPU index), then the
    stack's extras on its kept rows (:func:`_screen_kept_extras`)."""
    Q = qr.q.shape[0]
    block_q, block_b = _fused_blocks(qindex, Q, quant=True)
    keep, d2 = _fused.fused_quant_range(
        qindex, qr.q, qr.words, qr.residuals,
        _eps_vec(eps, Q, qindex.device), block_q=block_q, block_b=block_b)
    return _screen_kept_extras(qindex, qr, eps, keep, d2)


def _quantized_screen_backend(tindex: TieredIndex, qr: QueryReprDev,
                              eps_col, backend: str):
    """The dense quantized screen: :func:`_kernel5_screen` on the ``cuda``
    backend (on a CUDA index kernel 5 launches or raises), the plain
    oracle :func:`quantized_screen` on ``torch``."""
    qdev = tindex.dev
    if resolve_backend(backend, qdev.device) == "torch":
        return quantized_screen(qdev, qr, eps_col)
    return _kernel5_screen(qdev, qr, eps_col)


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


# ---------------------------------------------------------------------------
# Observability: traced twins of the query entry points.
#
# Tracing never touches the untraced functions.  Each twin runs the
# UNCHANGED call for its answers (on a CUDA index: the same kernels), then
# a separate counting pass whose per-level expressions are those of
# :func:`cascade_mask` (:func:`quantized_cascade_mask` on the tier), term
# for term, in C9-then-C10 order over one running alive set.  So tracing
# off is the old call path, and tracing on cannot change an answer.  The
# counting pass is torch glue over the screen columns (words and
# residuals, never the series), in row chunks: the full (Q, B, N) MINDIST
# gather would be 2 GiB at Q = 32, B = 2^20, N = 16.
# ---------------------------------------------------------------------------

#: Bytes of one row chunk's (Q, chunk, N) MINDIST cells in a counting pass:
#: few chunks (eight at Q = 32, N = 16, B = 2^20), each of bounded memory.
_COUNT_CHUNK_BYTES = 256 << 20


def _count_alive(mask: torch.Tensor) -> torch.Tensor:
    """(…, B) bool -> (…,) int32 survivor count."""
    return torch.sum(mask, dim=-1, dtype=torch.int32)


def _count_chunks(B: int, Q: int, levels) -> range:
    """Row starts of the counting pass's chunks."""
    per_row = max(1, Q * max(levels, default=1) * 4)
    return range(0, B, max(1, min(B, _COUNT_CHUNK_BYTES // per_row)))


def _level_counts(alive0: torch.Tensor, c9_ok, c10_ok, L: int):
    """Run the per-level tests ``c9_ok(li)`` / ``c10_ok(li)`` (bool
    masks of the chunk) over the running alive set ``alive0``; returns
    the chunk's ``(after_c9, after_c10)``, (Q, L) int64 each."""
    alive = alive0
    a9, a10 = [], []
    for li in range(L):
        alive = alive & c9_ok(li)
        a9.append(alive.sum(dim=-1))
        alive = alive & c10_ok(li)
        a10.append(alive.sum(dim=-1))
    return torch.stack(a9, dim=-1), torch.stack(a10, dim=-1)


def _c10_sq(words: torch.Tensor, q_words: torch.Tensor, tab_sq: torch.Tensor,
            n: int, N: int) -> torch.Tensor:
    """(Q, chunk) MINDIST² of :func:`cascade_mask`'s C10 for int64
    ``words`` (chunk, N) and ``q_words`` (Q, N), gathered from the
    squared table ``tab_sq = tab · tab``: squaring before the gather gives
    the same f32 cells as squaring after it, in one pass less."""
    cell_sq = tab_sq[words[None, :, :], q_words[:, None, :]]
    return (n / N) * torch.sum(cell_sq, dim=-1)


def _cascade_counting(index: DeviceIndex, qr: QueryReprDev, eps,
                      valid_mask: torch.Tensor | None):
    """:func:`cascade_mask`, chunk by chunk, counting per level:
    ``(after_c9, after_c10)``, (Q, L) int32, the stack's gap-kind extras'
    kills under ``after_c9`` and its word-kind extras' under
    ``after_c10``.  ``eps`` is a scalar, (Q,) or (Q, 1); ``valid_mask`` is
    folded into the first alive set, so masked rows never count as C9
    kills."""
    n, dev, B = index.n, index.device, index.size
    Q, L = qr.q.shape[0], len(index.levels)
    eps = _eps_qcol(eps, Q, dev)
    eps2 = eps * eps
    tab = _mindist_sq_tab(index.alphabet, dev)
    tab_sq = tab * tab
    words = [w.long() for w in index.words]
    q_words = [w.long() for w in qr.words]
    gap_extras, word_extras = _extra_reps(index)
    a9 = torch.zeros((Q, L), dtype=torch.int64, device=dev)
    a10 = torch.zeros_like(a9)
    chunks = _count_chunks(B, Q, index.levels)
    for lo in chunks:
        hi = min(B, lo + chunks.step)
        rows = slice(lo, hi)
        alive0 = torch.ones((Q, hi - lo), dtype=torch.bool, device=dev)
        if valid_mask is not None:
            alive0 = alive0 & valid_mask[None, lo:hi]

        def c9_ok(li):
            ok = torch.abs(index.residuals[li][None, lo:hi]
                           - qr.residuals[li][:, None]) <= eps
            for rep in gap_extras:
                ok = ok & _extra_gap_ok(rep, index, qr, li, eps, rows)
            return ok

        def c10_ok(li):
            ok = _c10_sq(words[li][lo:hi], q_words[li], tab_sq, n,
                         index.levels[li]) <= eps2
            for rep in word_extras:
                ok = ok & _extra_word_ok(rep, index, qr, li, eps2, tab, rows)
            return ok

        c9, c10 = _level_counts(alive0, c9_ok, c10_ok, L)
        a9 += c9
        a10 += c10
    return a9.to(torch.int32), a10.to(torch.int32)


def _trace_of(a9: torch.Tensor, a10: torch.Tensor, answers=None,
              screened=None) -> QueryTrace:
    """A trace whose verify touches the cascade's candidates (or the
    ``screened`` rows of a series screen); ``answers`` default 0."""
    cand = a10[:, -1] if screened is None else screened
    return QueryTrace(after_c9=a9, after_c10=a10, screen_survivors=cand,
                      verified=cand,
                      answers=torch.zeros_like(cand) if answers is None
                      else answers)


def _final_radius(nn_d2: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, 1) radius of the k-th verified distance; +inf (fewer than k
    finite) becomes ``_SEED_EPS_MAX``."""
    eps = torch.sqrt(torch.clamp(nn_d2[:, k - 1:k], min=0.0))
    return torch.where(torch.isfinite(eps), eps,
                       torch.full_like(eps, _SEED_EPS_MAX))


def _mixed_radius(epsilon, is_knn, k: int, answer, d2):
    """Per-row final radius of a served mixed batch: range rows at the
    request ε, k-NN rows at their k-th answer distance, recovered from
    the returned buffers (compact or dense: non-answer slots are +inf).
    Returns ``(eps (Q, 1), knn_col, k_eff, n_ans)``."""
    Q, dev = answer.shape[0], answer.device
    knn_col = torch.as_tensor(is_knn, dtype=torch.bool,
                              device=dev).reshape(Q, 1)
    d2a = torch.where(answer, d2, INF)
    k_eff = max(1, min(int(k), d2a.shape[-1]))
    eps = torch.where(knn_col, _final_radius(_kth_smallest(d2a, k_eff), 1),
                      _eps_qcol(epsilon, Q, dev))
    return eps, knn_col, k_eff, _count_alive(torch.isfinite(d2a))


def _mixed_answers(knn_col, k_eff: int, n_ans) -> torch.Tensor:
    """Answer-set sizes: k-NN rows report at most k."""
    return torch.where(knn_col[:, 0], torch.clamp(n_ans, max=k_eff), n_ans)


def cascade_trace(index: DeviceIndex, qr: QueryReprDev, epsilon,
                  valid_mask: torch.Tensor | None = None) -> QueryTrace:
    """:class:`QueryTrace` of the cascade at radius ``epsilon``: the
    verify touches the candidates (the full-precision path has no series
    screen); ``answers`` is zero until a caller sets it."""
    a9, a10 = _cascade_counting(index, qr, epsilon, valid_mask)
    return _trace_of(a9, a10)


def range_query_traced(index: DeviceIndex, qr: QueryReprDev, epsilon,
                       backend: str = "auto",
                       valid_mask: torch.Tensor | None = None, **fused_kw):
    """Range query and its trace: ``(answers, d2, trace)``.  The answers
    are the untraced backend call's (on ``cuda``: kernel 1,
    :func:`range_query_fused`); the counters come from the counting pass
    at the same radius, the stack's extras included."""
    if resolve_backend(backend, index.device) == "cuda":
        ans, d2 = range_query_fused(index, qr, epsilon,
                                    valid_mask=valid_mask, **fused_kw)
    else:
        ans, d2 = _mask_dense(*range_query(index, qr, epsilon), valid_mask)
    trace = cascade_trace(index, qr, epsilon, valid_mask)
    return ans, d2, dataclasses.replace(trace, answers=_count_alive(ans))


def knn_radius_trace(index: DeviceIndex, qr: QueryReprDev, nn_d2, k: int,
                     valid_mask: torch.Tensor | None = None) -> QueryTrace:
    """Cascade counters at the final verified k-NN radius d_k.

    The k-NN engines tighten their radius pass by pass, so their internal
    counts do not compare across engines; the counters at d_k do: they
    equal the host ``fastsax_range_query`` accounting at ε = d_k (the
    k-th neighbour's own bounds lie inside its distance, so it survives
    on both engines)."""
    a9, a10 = _cascade_counting(index, qr, _final_radius(nn_d2, k),
                                valid_mask)
    return _trace_of(a9, a10, answers=_count_alive(
        torch.isfinite(nn_d2[:, :k])))


def knn_query_traced(index: DeviceIndex, qr: QueryReprDev, k: int,
                     backend: str = "auto", capacity: int | None = None,
                     n_iters: int = 2, valid_mask: torch.Tensor | None = None,
                     **fused_kw):
    """Exact k-NN and its trace at the final verified radius: ``(nn_idx,
    nn_d2, exact, trace)``, the first three the untraced backend call's
    (on ``cuda``: kernel 2, :func:`knn_query_fused`)."""
    if resolve_knn_backend(backend, k, index.device) == "cuda":
        nn_idx, nn_d2, exact = knn_query_fused(
            index, qr, k, n_iters=n_iters, valid_mask=valid_mask, **fused_kw)
    else:
        nn_idx, nn_d2, exact = knn_query_auto(
            index, qr, k, capacity=capacity, n_iters=n_iters,
            valid_mask=valid_mask)
    trace = knn_radius_trace(index, qr, nn_d2, min(int(k), index.size),
                             valid_mask)
    return nn_idx, nn_d2, exact, trace


def mixed_trace(index: DeviceIndex, qr: QueryReprDev, epsilon, is_knn,
                k: int, answer, d2,
                valid_mask: torch.Tensor | None = None) -> QueryTrace:
    """Trace of a served mixed batch at each row's FINAL radius (range
    rows at ε, k-NN rows at the k-th answer distance of the returned
    buffers, compact or dense); ``answers``: in-range rows, or min(k,
    finite candidates) for k-NN rows."""
    eps, knn_col, k_eff, n_ans = _mixed_radius(epsilon, is_knn, k, answer,
                                               d2)
    a9, a10 = _cascade_counting(index, qr, eps, valid_mask)
    return _trace_of(a9, a10, answers=_mixed_answers(knn_col, k_eff, n_ans))


def mixed_query_and_trace(index: DeviceIndex, qr: QueryReprDev, epsilon,
                          is_knn, k: int, capacity: int, n_iters: int = 2,
                          valid_mask: torch.Tensor | None = None):
    """:func:`mixed_query` and :func:`mixed_trace` of its buffers:
    ``(idx, answer, d2, overflow, trace)``."""
    out = mixed_query(index, qr, epsilon, is_knn, k, capacity, n_iters,
                      valid_mask)
    return (*out, mixed_trace(index, qr, epsilon, is_knn, k, out[1], out[2],
                              valid_mask))


def mixed_query_dense_and_trace(index: DeviceIndex, qr: QueryReprDev,
                                epsilon, is_knn, k: int,
                                valid_mask: torch.Tensor | None = None):
    """:func:`mixed_query_dense` and its trace: ``(idx, answer, d2,
    overflow, trace)``.

    The counters describe the work the dense path does: range rows count
    the cascade at ε, but k-NN rows are answered by brute force over
    every valid row, so they report ``after_c9 = after_c10 = verified =``
    the valid row count and ``answers = min(k, valid)``.  (The
    compacting twin counts k-NN rows at their k-th radius, because it
    runs another strategy.)"""
    out = mixed_query_dense(index, qr, epsilon, is_knn, k, valid_mask)
    Q, B, dev = qr.q.shape[0], index.size, index.device
    knn_col = torch.as_tensor(is_knn, dtype=torch.bool,
                              device=dev).reshape(Q, 1)
    a9, a10 = _cascade_counting(index, qr, epsilon, valid_mask)
    n_valid = torch.full((Q, 1), B, dtype=torch.int32, device=dev) \
        if valid_mask is None else _count_alive(valid_mask).reshape(1, 1)
    a9 = torch.where(knn_col, n_valid, a9)
    a10 = torch.where(knn_col, n_valid, a10)
    answers = _mixed_answers(knn_col, max(1, min(int(k), B)),
                             _count_alive(out[1]))
    return (*out, _trace_of(a9, a10, answers=answers))


def _quant_cascade_counting(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                            eps):
    """:func:`quantized_cascade_mask`, chunk by chunk, counting per level:
    the widened C9 ``|r̂(u) − r(q)| ≤ ε + e_blk`` on the dequantized
    residuals, C10 unwidened on the int8 words (the expressions of
    ``kernels/ref.py::quant_meta_alive_ref``), then the stack's word-kind
    extras on their int8 symbols, counted under ``after_c10``."""
    n, dev, B = qindex.n, qindex.device, qindex.size
    Q, L = qr.q.shape[0], len(qindex.levels)
    eps = _eps_qcol(eps, Q, dev)
    eps2 = eps * eps
    tab = _mindist_sq_tab(qindex.alphabet, dev)
    tab_sq = tab * tab
    words = [w.long() for w in qindex.words]
    q_words = [w.long() for w in qr.words]
    res = [_dequant_residuals_dev(qindex, li) for li in range(L)]
    err = [_expand_block_col(qindex.resid_err[li], B) for li in range(L)]
    _, word_extras = _extra_reps(qindex)
    a9 = torch.zeros((Q, L), dtype=torch.int64, device=dev)
    a10 = torch.zeros_like(a9)
    chunks = _count_chunks(B, Q, qindex.levels)
    for lo in chunks:
        hi = min(B, lo + chunks.step)
        rows = slice(lo, hi)

        def c10_ok(li):
            ok = _c10_sq(words[li][lo:hi], q_words[li], tab_sq, n,
                         qindex.levels[li]) <= eps2
            for rep in word_extras:
                ok = ok & _extra_word_ok(rep, qindex, qr, li, eps2, tab,
                                         rows)
            return ok

        c9, c10 = _level_counts(
            torch.ones((Q, hi - lo), dtype=torch.bool, device=dev),
            lambda li: torch.abs(res[li][None, lo:hi]
                                 - qr.residuals[li][:, None])
            <= eps + err[li][None, lo:hi],
            c10_ok, L)
        a9 += c9
        a10 += c10
    return a9.to(torch.int32), a10.to(torch.int32)


def quantized_cascade_trace(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                            epsilon) -> QueryTrace:
    """Trace of the quantized screen at radius ``epsilon``.

    Per level the widened-C9 and C10 survivors (the widened host oracle
    ``search.quantized_fastsax_range_query`` counts the same); then the
    series screen's survivors, the tier's own pruning figure with no
    host counterpart: the keep count of :func:`_kernel5_screen` (kernel 5
    on a CUDA index, its plain version on the CPU, then the stack's
    extras on its kept rows).  ``verified`` is the screen's survivors:
    the rows the raw tier is read for."""
    a9, a10 = _quant_cascade_counting(qindex, qr, epsilon)
    keep, _ = _kernel5_screen(qindex, qr, epsilon)
    return _trace_of(a9, a10, screened=_count_alive(keep))


def quantized_mixed_trace(qindex: QuantizedDeviceIndex, qr: QueryReprDev,
                          epsilon, is_knn, k: int, answer,
                          d2) -> QueryTrace:
    """:func:`mixed_trace` for the tiered backend: the same final-radius
    recovery from the returned buffers, counted through the quantized
    screen."""
    eps, knn_col, k_eff, n_ans = _mixed_radius(epsilon, is_knn, k, answer,
                                               d2)
    return dataclasses.replace(quantized_cascade_trace(qindex, qr, eps),
                               answers=_mixed_answers(knn_col, k_eff, n_ans))


def quantized_range_query_traced(tindex: TieredIndex, qr: QueryReprDev,
                                 epsilon, capacity: int | None = None,
                                 backend: str = "auto",
                                 max_doublings: int = 8):
    """:func:`quantized_range_query` and its trace: ``(idx, answer, d2,
    exact, trace)``."""
    idx, answer, d2, exact = quantized_range_query(
        tindex, qr, epsilon,
        options=SearchOptions(capacity=capacity, backend=backend,
                              max_doublings=max_doublings))
    trace = quantized_cascade_trace(tindex.dev, qr, epsilon)
    return idx, answer, d2, exact, dataclasses.replace(
        trace, answers=_count_alive(answer))


def quantized_knn_query_traced(tindex: TieredIndex, qr: QueryReprDev, k: int,
                               capacity: int | None = None,
                               backend: str = "auto",
                               max_doublings: int = 8):
    """:func:`quantized_knn_query` and its trace at the final verified
    radius: ``(nn_idx, nn_d2, exact, trace)``."""
    nn_idx, nn_d2, exact = quantized_knn_query(
        tindex, qr, k,
        options=SearchOptions(capacity=capacity, backend=backend,
                              max_doublings=max_doublings))
    k_eff = min(int(k), tindex.size)
    trace = quantized_cascade_trace(tindex.dev, qr,
                                    _final_radius(nn_d2, k_eff))
    return nn_idx, nn_d2, exact, dataclasses.replace(
        trace, answers=_count_alive(torch.isfinite(nn_d2[:, :k_eff])))


def device_trace_bytes(index: DeviceIndex, trace: QueryTrace) -> dict:
    """Per-tier bytes of a traced pass over a full-precision index: the
    screen tier reads every row's f32 residual and int32 word columns
    once per query; the verify tier is charged the candidate rows (what
    the trace reports is the information cost, not the dense path's
    byte meter)."""
    rb = screen_row_bytes(index.levels, index.alphabet)
    return tier_bytes(trace, index.size, rb, index.n,
                      verify_itemsize=index.series.element_size())


def tiered_trace_bytes(tindex: TieredIndex, trace: QueryTrace) -> dict:
    """Per-tier bytes of a traced quantized pass: the resident screen
    reads the QUANTIZED columns (int8 / bf16) and the quantized series
    row; the verify tier is charged at the raw tier's itemsize for the
    rows the screen kept."""
    qdev = tindex.dev
    rb = screen_row_bytes(qdev.levels, qdev.alphabet,
                          resid_itemsize=qdev.residuals[0].element_size(),
                          word_itemsize=qdev.words[0].element_size())
    rb += qdev.n * qdev.series.element_size()
    return tier_bytes(trace, tindex.size, rb, qdev.n,
                      verify_itemsize=tindex.raw.dtype.itemsize)
