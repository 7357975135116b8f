"""Distributed FAST_SAX: the database sharded over a mesh of devices.

Counterpart of ``repro/core/dist_search.py``.  The reference runs one
controlling process over the devices of a ``jax.sharding.Mesh`` and
``shard_map``s each engine over their rows; the port keeps that model:

  * :class:`ShardMesh` is the mesh: a tuple of ``torch.device`` s, one per
    shard (``make_data_mesh``: one shard per card, or P shards placed
    round robin over the cards, or every shard on the CPU for the tests);
  * :class:`ShardedDeviceIndex` is the sharded index: one
    ``engine.DeviceIndex`` of ``b_loc`` rows per shard, each on its mesh
    device; row ``r`` of shard ``s`` has the global id ``s·b_loc + r``,
    and no global tensor is ever assembled;
  * a ``shard_map`` body becomes a loop over the shards, each shard's
    call issued on its own device's current stream (calls on different
    cards run concurrently); a ``psum`` becomes a sum of the per-shard
    results on the first device, and the output sharding a shard-major
    ``torch.cat`` there.

Each shard runs the single-device engines of ``core/engine.py``: on the
``cuda`` backend the fused kernels (``range_query_fused`` /
``knn_query_fused`` / ``mixed_query_fused``, kernels 1-2), whose dense
answers ``engine.compact_answers`` compacts into the reference's per-shard
candidate buffers, else the torch engine.  The stream-sharded
subsequence form answers through the streaming kernels 3-4
(``subseq.subseq_range_query`` / ``subseq._subseq_knn_fetch``), the
sharded quantized tier screens each shard with kernel 5
(``engine._quantized_screen_backend``), and :class:`FailoverShards`
queries independent shards from a thread pool with timeouts, retries,
down-marking and probes.

Padding rows (added to make B divisible by the shard count) carry the
sentinel residual ``PAD_RESIDUAL = 1e30`` at level 0, so C9 kills them
for any finite ε; the k-NN paths also mask them out of the seed sample.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import statistics
import time
from concurrent import futures as _futures
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..runtime import chaos
from ..runtime.fault_tolerance import StepWatchdog
from . import representation as repr_registry
from .engine import (_KNN_SEED_SAMPLE, _SEED_EPS_MAX, INF,
                     QuantizedDeviceIndex, QueryReprDev, TieredIndex,
                     _compact_mask, _eps_qcol, _quantized_screen_backend,
                     _sample_eps, _slacked, _verify_tier, build_device_index,
                     cascade_mask, cascade_trace, compact_answers,
                     knn_query, knn_query_fused, mixed_query,
                     mixed_query_backend, mixed_query_fused,
                     quantized_mixed_query, range_query_compact,
                     range_query_fused, represent_queries, resolve_backend,
                     resolve_device, resolve_knn_backend)
from .options import SearchOptions, resolve_options
from .representation import DEFAULT_STACK

_PAD_RESIDUAL = 1e30  # sentinel: C9 kills padded rows for any finite epsilon


# ---------------------------------------------------------------------------
# The mesh and the sharded index.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh: one ``torch.device`` per shard.  ``shape[axis]`` is the
    shard count, so the reference's ``mesh.shape["data"]`` call sites read
    the same.  Several shards may share a device (P shards on one card)."""

    devices: tuple
    axis: str = "data"

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_data_mesh(n_devices: int | None = None, axis: str = "data",
                   device=None) -> ShardMesh:
    """A 1-D mesh of ``n_devices`` shards.  By default one shard per
    visible card; with ``n_devices``, shard i on card i mod the card
    count; with ``device`` (e.g. ``"cpu"``, as the tests run), every shard
    on that device (one shard unless ``n_devices`` says more).  Raises
    without a CUDA device unless ``device`` is given."""
    if device is not None:
        dev = torch.device(device)
        return ShardMesh(tuple(dev for _ in range(int(n_devices or 1))),
                         axis)
    resolve_device(None)                      # raises without a card
    count = torch.cuda.device_count()
    n = int(n_devices or count)
    return ShardMesh(tuple(torch.device("cuda", i % count)
                           for i in range(n)), axis)


def _shard_count(mesh, axis: str) -> int:
    return int(mesh.shape[axis])


@dataclasses.dataclass
class ShardedDeviceIndex:
    """The sharded database: ``shards[s]`` is an ``engine.DeviceIndex`` of
    ``b_loc`` rows on mesh device ``s``; row ``r`` of shard ``s`` is
    global row ``s·b_loc + r``.  ``n_valid`` counts the real rows (pads
    sort last and carry the level-0 sentinel)."""

    shards: tuple
    n_valid: int
    _masks: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def levels(self) -> tuple:
        return self.shards[0].levels

    @property
    def alphabet(self) -> int:
        return self.shards[0].alphabet

    @property
    def stack(self) -> tuple:
        return self.shards[0].stack

    @property
    def n(self) -> int:
        return self.shards[0].n

    @property
    def b_loc(self) -> int:
        return self.shards[0].size

    @property
    def size(self) -> int:
        """Rows across the shards, pads included (the reference's
        ``index.series.shape[0]``)."""
        return sum(s.size for s in self.shards)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device


def _check_mesh(index, mesh, axis: str) -> int:
    P_sh = _shard_count(mesh, axis)
    if len(index.shards) != P_sh:
        raise ValueError(f"the index has {len(index.shards)} shard(s) but "
                         f"mesh axis {axis!r} has {P_sh}")
    return P_sh


def _on(dev: torch.device):
    """Issue the calls of a block on ``dev``'s current stream."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _qr_to(qr: QueryReprDev, dev: torch.device) -> QueryReprDev:
    """The query representation on another device (itself if there)."""
    if qr.q.device == dev:
        return qr
    to = lambda t: t.to(dev)
    return QueryReprDev(q=to(qr.q), words=tuple(map(to, qr.words)),
                        residuals=tuple(map(to, qr.residuals)),
                        extra=tuple({k: to(v) for k, v in lvl.items()}
                                    for lvl in qr.extra))


def _queries_qr(index, queries, normalize: bool) -> QueryReprDev:
    """Represent the queries once, on the first shard's device."""
    q = torch.as_tensor(np.asarray(queries) if not isinstance(
        queries, torch.Tensor) else queries, dtype=torch.float32,
        device=index.device)
    return represent_queries(q, index.levels, index.alphabet,
                             normalize=normalize, stack=index.stack)


def _valid_masks(index: ShardedDeviceIndex, n_valid: int) -> list:
    """Per shard the (b_loc,) valid-row mask ``rows < n_valid`` and
    ``residual0 < 0.5·PAD_RESIDUAL`` (the reference's), or None where
    every row is valid; cached on the index per ``n_valid``."""
    key = int(n_valid)
    if key not in index._masks:
        out = []
        for s, sh in enumerate(index.shards):
            rows = s * index.b_loc + torch.arange(sh.size, device=sh.device)
            m = (rows < key) & (sh.residuals[0] < 0.5 * _PAD_RESIDUAL)
            out.append(None if bool(m.all()) else m)
        index._masks[key] = out
    return index._masks[key]


def _gather(parts: list, dev: torch.device) -> torch.Tensor:
    """The output sharding: a shard-major concatenation on ``dev``."""
    return torch.cat([p.to(dev) for p in parts], dim=-1)


def _coerce_dist_options(options, legacy: dict):
    """Legacy positional ``capacity_per_shard`` (int) in the ``options``
    slot routes through the deprecation shim."""
    if isinstance(options, int):
        legacy["capacity_per_shard"] = options
        return None
    return options


def _dist_options(options, legacy: dict, caller: str) -> SearchOptions:
    options = _coerce_dist_options(options, legacy)
    if "capacity_per_shard" in legacy:
        legacy["capacity"] = legacy.pop("capacity_per_shard")
    opts, rest = resolve_options(options, legacy, caller)
    if rest:
        raise TypeError(f"{caller}: unexpected kwargs {sorted(rest)}")
    return opts


# ---------------------------------------------------------------------------
# The whole-series engines.
# ---------------------------------------------------------------------------


def pad_database(series: np.ndarray, shards: int):
    """Pad B up to a multiple of ``shards``.  Returns (padded, n_valid)."""
    B = series.shape[0]
    Bp = (B + shards - 1) // shards * shards
    if Bp == B:
        return series, B
    pad = np.zeros((Bp - B, series.shape[1]), dtype=series.dtype)
    # Any finite content works — the sentinel residual guarantees exclusion.
    pad[:] = np.linspace(-1.0, 1.0, series.shape[1])[None, :]
    return np.concatenate([series, pad], axis=0), B


def distributed_build(series, levels: Sequence[int], alphabet: int,
                      mesh: ShardMesh, axis: str = "data",
                      n_valid: int | None = None,
                      stack: tuple = DEFAULT_STACK) -> ShardedDeviceIndex:
    """Offline phase on the mesh: every shard indexes its own rows on its
    device (``engine.build_device_index``, z-normalising as the reference
    does) and stamps its pad rows' level-0 residual with the sentinel."""
    levels = tuple(int(N) for N in levels)
    stack = repr_registry.validate_stack(stack)
    P_sh = _shard_count(mesh, axis)
    B = series.shape[0]
    if B % P_sh != 0:
        raise ValueError(f"pad first: B={B} not divisible by shards={P_sh}")
    n_valid = B if n_valid is None else int(n_valid)
    b_loc = B // P_sh
    shards = []
    for s, dev in enumerate(mesh.devices):
        part = series[s * b_loc:(s + 1) * b_loc]
        if not isinstance(part, torch.Tensor):
            part = np.asarray(part, np.float32)
        with _on(dev):
            idx = build_device_index(part, levels, alphabet, stack=stack,
                                     device=dev)
            rows = s * b_loc + torch.arange(b_loc, device=dev)
            res0 = torch.where(rows < n_valid, idx.residuals[0],
                               torch.full_like(idx.residuals[0],
                                               _PAD_RESIDUAL))
        shards.append(dataclasses.replace(
            idx, residuals=(res0,) + tuple(idx.residuals[1:])))
    return ShardedDeviceIndex(shards=tuple(shards), n_valid=n_valid)


def _range_shard(lidx, lqr, eps, cap: int, be: str):
    """One shard's range buffer: ``(idx, answer, d2, overflow)``."""
    if be == "cuda":
        dense_ans, dense_d2 = range_query_fused(lidx, lqr, eps)
        return compact_answers(dense_ans, dense_d2, cap)
    return range_query_compact(lidx, lqr, eps, cap)


def distributed_range_query(index: ShardedDeviceIndex, queries, epsilon,
                            mesh: ShardMesh, axis: str = "data",
                            options: SearchOptions | None = None, **legacy):
    """Range query over the sharded database.

    Returns ``(global_idx (Q, P·C), is_answer (Q, P·C), d2 (Q, P·C),
    overflow (Q, P))`` on the first shard's device: every shard
    contributes ``options.capacity`` candidate slots (default 128);
    ``overflow[q, p]`` flags a shard whose survivors did not fit (re-run
    with a larger capacity — soundness is never silently lost).
    ``options.backend`` picks the per-shard engine: kernel 1
    (``range_query_fused``, compacted by ``compact_answers``) on ``cuda``,
    ``range_query_compact`` on ``torch``.
    """
    opts = _dist_options(options, legacy, "distributed_range_query")
    P_sh = _check_mesh(index, mesh, axis)
    cap = 128 if opts.capacity is None else int(opts.capacity)
    be = resolve_backend(opts.backend, index.device)
    qr = _queries_qr(index, queries, opts.normalize_queries)
    out = [[], [], [], []]
    for s in range(P_sh):
        lidx = index.shards[s]
        dev = lidx.device
        with _on(dev):
            idx, ans, d2, ovf = _range_shard(lidx, _qr_to(qr, dev),
                                             _eps_qcol(epsilon, qr.q.shape[0],
                                                       dev), cap, be)
            for acc, t in zip(out, (idx + s * index.b_loc, ans, d2,
                                    ovf[:, None])):
                acc.append(t)
    return tuple(_gather(p, index.device) for p in out)


def distributed_range_query_auto(index: ShardedDeviceIndex, queries, epsilon,
                                 mesh: ShardMesh, axis: str = "data",
                                 options: SearchOptions | None = None,
                                 **legacy):
    """:func:`distributed_range_query` under the capacity auto-escalation
    contract: while any shard overflows, re-run at 4× the per-shard
    capacity, capped at the shard size where compaction cannot overflow."""
    opts = _dist_options(options, legacy, "distributed_range_query_auto")
    b_loc = index.b_loc
    cap = min(128 if opts.capacity is None else int(opts.capacity), b_loc)
    for _ in range(opts.max_doublings + 1):
        gidx, ans, d2, overflow = distributed_range_query(
            index, queries, epsilon, mesh, axis=axis,
            options=dataclasses.replace(opts, capacity=cap))
        if cap >= b_loc or not bool(overflow.any()):
            return gidx, ans, d2, overflow
        cap = min(b_loc, cap * 4)
    return gidx, ans, d2, overflow


def distributed_mixed_query(index: ShardedDeviceIndex, queries, epsilon,
                            is_knn, k: int, mesh: ShardMesh,
                            axis: str = "data",
                            options: SearchOptions | None = None,
                            n_valid: int | None = None, **legacy):
    """Batched mixed-workload dispatch over the sharded database.

    Every shard runs the mixed engine on its rows (range rows prune at the
    caller's ε, k-NN rows self-tighten on shard-local data): kernels 1-2
    (``mixed_query_fused``) compacted into a ``capacity``-slot buffer on
    ``cuda``, ``engine.mixed_query`` on ``torch``.  Returns ``(gidx (Q,
    P·C), answer (Q, P·C), d2 (Q, P·C), overflow (Q, P))``; k-NN rows'
    ``answer`` marks candidate slots — finish with ``engine.mixed_topk``.
    Any True in ``overflow[q]`` means row q's buffer truncated on that
    shard: escalate the capacity and re-dispatch.
    """
    opts = _dist_options(options, legacy, "distributed_mixed_query")
    P_sh = _check_mesh(index, mesh, axis)
    b_loc = index.b_loc
    n_valid = index.n_valid if n_valid is None else int(n_valid)
    k_loc = min(int(k), b_loc)
    cap = min(128 if opts.capacity is None else int(opts.capacity), b_loc)
    be = resolve_knn_backend(opts.backend, k_loc, index.device)
    qr = _queries_qr(index, queries, opts.normalize_queries)
    Q = qr.q.shape[0]
    masks = _valid_masks(index, n_valid)
    out = [[], [], [], []]
    for s in range(P_sh):
        lidx = index.shards[s]
        dev = lidx.device
        with _on(dev):
            lqr = _qr_to(qr, dev)
            eps = _eps_qcol(epsilon, Q, dev)
            knn = torch.as_tensor(np.asarray(is_knn) if not isinstance(
                is_knn, torch.Tensor) else is_knn, dtype=torch.bool,
                device=dev)
            if be == "cuda":
                _, dense_ans, dense_d2, _ = mixed_query_fused(
                    lidx, lqr, eps, knn, k_loc, n_iters=opts.n_iters,
                    valid_mask=masks[s])
                idx, answer, d2, overflow = compact_answers(
                    dense_ans, dense_d2, cap)
            else:
                idx, answer, d2, overflow = mixed_query(
                    lidx, lqr, eps, knn, k_loc, capacity=cap,
                    n_iters=opts.n_iters, valid_mask=masks[s])
            gidx = torch.where(answer, idx + s * b_loc,
                               torch.full_like(idx, -1))
            for acc, t in zip(out, (gidx, answer, d2, overflow[:, None])):
                acc.append(t)
    return tuple(_gather(p, index.device) for p in out)


def distributed_mixed_query_auto(index: ShardedDeviceIndex, queries, epsilon,
                                 is_knn, k: int, mesh: ShardMesh,
                                 axis: str = "data",
                                 options: SearchOptions | None = None,
                                 n_valid: int | None = None, **legacy):
    """:func:`distributed_mixed_query` under the capacity auto-escalation
    contract: 4× the per-shard capacity while any shard overflows, capped
    at the shard size."""
    opts = _dist_options(options, legacy, "distributed_mixed_query_auto")
    b_loc = index.b_loc
    cap = min(128 if opts.capacity is None else int(opts.capacity), b_loc)
    for _ in range(opts.max_doublings + 1):
        out = distributed_mixed_query(
            index, queries, epsilon, is_knn, k, mesh, axis=axis,
            options=dataclasses.replace(opts, capacity=cap), n_valid=n_valid)
        if cap >= b_loc or not bool(out[3].any()):
            return out
        cap = min(b_loc, cap * 4)
    return out


def _merge_topk(gidx: torch.Tensor, d2: torch.Tensor, k: int):
    """Cross-shard merge: a STABLE ascending sort on d² over the
    shard-major concatenation (each shard ascending by (d², index)), so
    equal distances resolve to the lowest global index."""
    order = torch.sort(d2, dim=-1, stable=True).indices[:, :k]
    return torch.gather(gidx, -1, order), torch.gather(d2, -1, order)


def distributed_knn_query(index: ShardedDeviceIndex, queries, k: int,
                          mesh: ShardMesh, axis: str = "data",
                          options: SearchOptions | None = None,
                          n_valid: int | None = None, **legacy):
    """Exact k-NN over the sharded database: local top-k, cross-shard merge.

    Each shard runs the exact k-NN engine over its own rows (kernel 2,
    ``knn_query_fused``, on ``cuda``; ``engine.knn_query`` at the shard
    capacity on ``torch``) and emits its local top-k as (global index, d²)
    pairs; the global top-k is a subset of their union, taken by
    :func:`_merge_topk`.  Pads are masked out of every shard's seed and
    answers.  Returns ``(nn_idx (Q, k'), nn_d2 (Q, k'), exact (Q,))`` with
    ``k' = min(k, P·min(k, b_loc))``; slots past the valid count carry
    d² = +inf and index −1; ``exact`` is the AND of every shard's
    certificate.
    """
    opts = _dist_options(options, legacy, "distributed_knn_query")
    P_sh = _check_mesh(index, mesh, axis)
    b_loc = index.b_loc
    n_valid = index.n_valid if n_valid is None else int(n_valid)
    k_loc = min(int(k), b_loc)
    cap = b_loc if opts.capacity is None else min(int(opts.capacity), b_loc)
    be = resolve_knn_backend(opts.backend, k_loc, index.device)
    qr = _queries_qr(index, queries, opts.normalize_queries)
    masks = _valid_masks(index, n_valid)
    gs, ds, cs = [], [], []
    for s in range(P_sh):
        lidx = index.shards[s]
        dev = lidx.device
        with _on(dev):
            lqr = _qr_to(qr, dev)
            if be == "cuda":
                nn_idx, nn_d2, exact = knn_query_fused(
                    lidx, lqr, k_loc, n_iters=opts.n_iters,
                    valid_mask=masks[s])
            else:
                nn_idx, nn_d2, exact = knn_query(
                    lidx, lqr, k_loc, capacity=cap, n_iters=opts.n_iters,
                    valid_mask=masks[s])
            gs.append(torch.where(torch.isfinite(nn_d2),
                                  nn_idx.to(torch.int64) + s * b_loc,
                                  torch.full_like(nn_idx, -1,
                                                  dtype=torch.int64)))
            ds.append(nn_d2)
            cs.append(exact[:, None])
    gidx, d2 = _gather(gs, index.device), _gather(ds, index.device)
    nn_idx, nn_d2 = _merge_topk(gidx, d2, min(int(k), gidx.shape[-1]))
    return nn_idx, nn_d2, torch.all(_gather(cs, index.device), dim=-1)


def distributed_survivor_count(index: ShardedDeviceIndex, queries, epsilon,
                               mesh: ShardMesh, axis: str = "data",
                               normalize_queries: bool = True):
    """Global cascade-survivor count per query: the sum over shards (the
    reference's ``psum``)."""
    P_sh = _check_mesh(index, mesh, axis)
    qr = _queries_qr(index, queries, normalize_queries)
    total = None
    for s in range(P_sh):
        lidx = index.shards[s]
        with _on(lidx.device):
            c = cascade_mask(lidx, _qr_to(qr, lidx.device),
                             _eps_qcol(epsilon, qr.q.shape[0], lidx.device)
                             ).sum(dim=-1).to(index.device)
        total = c if total is None else total + c
    return total.to(torch.int32)


def distributed_cascade_trace(index: ShardedDeviceIndex, queries, epsilon,
                              mesh: ShardMesh, axis: str = "data",
                              normalize_queries: bool = True,
                              n_valid: int | None = None):
    """Cascade telemetry over the sharded database: every shard runs
    ``engine.cascade_trace`` (the counting pass, in row chunks) on its own
    rows with the pad rows folded out of the initial alive set, and the
    counters are summed over the shards on the first device (the
    reference's ``psum``).  The cascade is row-independent, so the sums
    equal the single-index trace.  ``answers`` comes back zero."""
    P_sh = _check_mesh(index, mesh, axis)
    n_valid = index.n_valid if n_valid is None else int(n_valid)
    qr = _queries_qr(index, queries, normalize_queries)
    masks = _valid_masks(index, n_valid)
    total = None
    for s in range(P_sh):
        lidx = index.shards[s]
        dev = lidx.device
        with _on(dev):
            tr = cascade_trace(lidx, _qr_to(qr, dev),
                               _eps_qcol(epsilon, qr.q.shape[0], dev),
                               masks[s])
        fields = [getattr(tr, f.name).to(index.device)
                  for f in dataclasses.fields(tr)]
        total = fields if total is None else [a + b for a, b in
                                              zip(total, fields)]
    return type(tr)(*total)


def distributed_range_query_traced(index: ShardedDeviceIndex, queries,
                                   epsilon, mesh: ShardMesh,
                                   axis: str = "data",
                                   options: SearchOptions | None = None,
                                   n_valid: int | None = None, **legacy):
    """:func:`distributed_range_query_auto` and the merged trace:
    ``(gidx, ans, d2, overflow, trace)``; the first four are the
    untraced call's."""
    opts = _dist_options(options, legacy, "distributed_range_query_traced")
    gidx, ans, d2, overflow = distributed_range_query_auto(
        index, queries, epsilon, mesh, axis=axis, options=opts)
    trace = distributed_cascade_trace(
        index, queries, epsilon, mesh, axis=axis,
        normalize_queries=opts.normalize_queries, n_valid=n_valid)
    answers = torch.sum(ans, dim=-1, dtype=torch.int32)
    return gidx, ans, d2, overflow, dataclasses.replace(trace,
                                                        answers=answers)


def distributed_knn_query_traced(index: ShardedDeviceIndex, queries, k: int,
                                 mesh: ShardMesh, axis: str = "data",
                                 options: SearchOptions | None = None,
                                 n_valid: int | None = None, **legacy):
    """:func:`distributed_knn_query` and the merged trace at each query's
    final verified radius — the k-th distance of the cross-shard merged
    answer: ``(nn_idx, nn_d2, exact, trace)``."""
    opts = _dist_options(options, legacy, "distributed_knn_query_traced")
    nn_idx, nn_d2, exact = distributed_knn_query(
        index, queries, k, mesh, axis=axis, options=opts, n_valid=n_valid)
    k_eff = min(int(k), nn_d2.shape[-1],
                index.size if n_valid is None else int(n_valid))
    eps = torch.sqrt(torch.clamp(nn_d2[:, k_eff - 1], min=0.0))
    eps = torch.where(torch.isfinite(eps), eps,
                      torch.full_like(eps, _SEED_EPS_MAX))
    trace = distributed_cascade_trace(
        index, queries, eps, mesh, axis=axis,
        normalize_queries=opts.normalize_queries, n_valid=n_valid)
    answers = torch.sum(torch.isfinite(nn_d2[:, :k_eff]), dim=-1,
                        dtype=torch.int32)
    return nn_idx, nn_d2, exact, dataclasses.replace(trace, answers=answers)


# ---------------------------------------------------------------------------
# Stream-sharded subsequence search.
#
# The subsequence workload shards over *streams*: each shard holds a
# ``subseq.SubseqDeviceIndex`` over S/P contiguous streams (padded
# streams' windows carry the level-0 sentinel) and answers through the
# streaming kernels 3-4 on ``cuda``.  Windows are numbered stream-major,
# so shard s's window w is global window ``s·(S/P)·W_s + w``.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistSubseqIndex:
    """The stream-sharded subsequence index: one ``SubseqDeviceIndex``
    per shard and the geometry that maps window ids back to (stream,
    start).  ``n_valid`` counts real windows (padded streams sort last,
    so valid window ids coincide with the single-index layout)."""

    shards: tuple
    window: int
    stride: int
    windows_per_stream: int
    n_valid: int
    _masks: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def index(self) -> ShardedDeviceIndex:
        """The windows-as-rows sharded index (the reference's
        ``dsx.index``): every whole-series engine above consumes it."""
        return ShardedDeviceIndex(shards=tuple(s.index for s in self.shards),
                                  n_valid=self.n_valid, _masks=self._masks)

    @property
    def w_loc(self) -> int:
        return self.shards[0].n_windows

    def window_meta(self, wid):
        """Global window ids -> (stream index, start position) host
        arrays; negative ids (empty k-NN slots) map to (−1, −1)."""
        wid = np.asarray(wid)
        W_s = self.windows_per_stream
        return (np.where(wid >= 0, wid // W_s, -1),
                np.where(wid >= 0, (wid % W_s) * self.stride, -1))

    @property
    def size(self) -> int:
        return self.w_loc * len(self.shards)


def distributed_subseq_index(hidx, mesh: ShardMesh,
                             axis: str = "data") -> DistSubseqIndex:
    """Build the stream-sharded subsequence index from a host
    ``subseq.SubseqHostIndex``: pad the stream batch to a multiple of the
    shard count (padded streams' windows carry the sentinel residual),
    and upload each shard's streams and window features to its device,
    where its z windows are materialised."""
    from .fastsax import LevelData
    from .subseq import SubseqHostIndex, subseq_device_index

    P_sh = _shard_count(mesh, axis)
    S, n_stream = hidx.streams.shape
    W_s = hidx.windows_per_stream
    S_p = (S + P_sh - 1) // P_sh * P_sh
    pad_s = S_p - S
    pad_w = pad_s * W_s
    streams_p = np.concatenate(
        [hidx.streams,
         np.broadcast_to(np.linspace(-1.0, 1.0, n_stream), (pad_s, n_stream))],
        axis=0) if pad_s else hidx.streams
    mu_p = np.concatenate([hidx.mu, np.zeros(pad_w)])
    sd_p = np.concatenate([hidx.sd, np.ones(pad_w)])
    levels_p = []
    for li, lv in enumerate(hidx.levels):
        fill = _PAD_RESIDUAL if li == 0 else 0.0
        # Extra columns pad with zeros — the level-0 sentinel residual
        # kills padded windows before any extra bound is consulted.
        levels_p.append(LevelData(
            n_segments=lv.n_segments,
            words=np.concatenate(
                [lv.words, np.zeros((pad_w, lv.n_segments), np.int32)]),
            residuals=np.concatenate([lv.residuals, np.full(pad_w, fill)]),
            extra={name: np.concatenate(
                [arr, np.zeros((pad_w,) + arr.shape[1:], arr.dtype)])
                for name, arr in getattr(lv, "extra", {}).items()}))
    S_loc = S_p // P_sh
    w_loc = S_loc * W_s
    shards = []
    for s, dev in enumerate(mesh.devices):
        rows = slice(s * w_loc, (s + 1) * w_loc)
        part = SubseqHostIndex(
            config=hidx.config, window=hidx.window, stride=hidx.stride,
            streams=streams_p[s * S_loc:(s + 1) * S_loc],
            mu=mu_p[rows], sd=sd_p[rows],
            levels=[LevelData(n_segments=lv.n_segments, words=lv.words[rows],
                              residuals=lv.residuals[rows],
                              extra={k: v[rows] for k, v in lv.extra.items()})
                    for lv in levels_p])
        with _on(dev):
            shards.append(subseq_device_index(part, dev))
    return DistSubseqIndex(shards=tuple(shards), window=int(hidx.window),
                           stride=int(hidx.stride), windows_per_stream=W_s,
                           n_valid=S * W_s)


def distributed_subseq_range_query(dsx: DistSubseqIndex, queries, epsilon,
                                   mesh: ShardMesh, axis: str = "data",
                                   options: SearchOptions | None = None,
                                   **legacy):
    """Stream-sharded subsequence range query, in the layout of
    :func:`distributed_range_query_auto`: ``(gidx, ans, d2, overflow)``
    with global window ids (map them with ``(wid // windows_per_stream,
    (wid % windows_per_stream) · stride)``).  On ``cuda`` each shard
    answers once through ``subseq.subseq_range_query`` (kernel 3) and the
    dense answers compact at the escalating capacity; on ``torch`` each
    round is ``range_query_compact`` over the shard's windows, as in the
    reference."""
    from .subseq import represent_subseq_queries, subseq_range_query

    opts = _dist_options(options, legacy, "distributed_subseq_range_query")
    _check_mesh(dsx, mesh, axis)
    w_loc = dsx.w_loc
    be = resolve_backend(opts.backend, dsx.shards[0].device)
    qr = represent_subseq_queries(dsx.shards[0], queries,
                                  normalize=opts.normalize_queries)
    Q = qr.q.shape[0]
    dense = []
    if be == "cuda":
        for sh in dsx.shards:
            with _on(sh.device):
                dense.append(subseq_range_query(
                    sh, _qr_to(qr, sh.device),
                    _eps_qcol(epsilon, Q, sh.device),
                    SearchOptions(backend="cuda")))
    cap = min(128 if opts.capacity is None else int(opts.capacity), w_loc)
    for _ in range(opts.max_doublings + 1):
        out = [[], [], [], []]
        for s, sh in enumerate(dsx.shards):
            with _on(sh.device):
                if be == "cuda":
                    parts = compact_answers(*dense[s], cap)
                else:
                    parts = range_query_compact(
                        sh.index, _qr_to(qr, sh.device),
                        _eps_qcol(epsilon, Q, sh.device), cap)
                idx, ans, d2, ovf = parts
                for acc, t in zip(out, (idx + s * w_loc, ans, d2,
                                        ovf[:, None])):
                    acc.append(t)
        gidx, ans, d2, overflow = (_gather(p, dsx.shards[0].device)
                                   for p in out)
        if cap >= w_loc or not bool(overflow.any()):
            break
        cap = min(w_loc, cap * 4)
    return gidx, ans, d2, overflow


def distributed_subseq_knn_query(dsx: DistSubseqIndex, queries, k: int,
                                 mesh: ShardMesh, excl: int | None = None,
                                 axis: str = "data",
                                 options: SearchOptions | None = None,
                                 **legacy):
    """Exact exclusion-zone k-NN over the stream-sharded windows.

    Fetches the provably sufficient ``subseq.knn_fetch_count`` candidates
    per shard through ``subseq._subseq_knn_fetch`` (kernel 4 on ``cuda``,
    the torch engine otherwise; padded windows masked), merges them
    ascending by (d², global window id) with a stable sort, and applies
    ``subseq.suppress_trivial_matches`` on the merged order on the host.
    Returns ``(sel_idx (Q, k), sel_d2 (Q, k), exact (Q,))`` host arrays.
    """
    from .subseq import (_subseq_knn_fetch, _suppress_candidates,
                         knn_fetch_count, represent_subseq_queries)

    opts = _dist_options(options, legacy, "distributed_subseq_knn_query")
    P_sh = _check_mesh(dsx, mesh, axis)
    excl = (dsx.window // 2) if excl is None else int(excl)
    kf = knn_fetch_count(k, excl, dsx.stride, dsx.n_valid)
    w_loc = dsx.w_loc
    k_loc = min(kf, w_loc)
    dev0 = dsx.shards[0].device
    qr = represent_subseq_queries(dsx.shards[0], queries,
                                  normalize=opts.normalize_queries)
    masks = _valid_masks(dsx.index, dsx.n_valid)
    if opts.capacity is None:
        opts = dataclasses.replace(opts, capacity=w_loc)
    gs, ds, cs = [], [], []
    for s in range(P_sh):
        sh = dsx.shards[s]
        with _on(sh.device):
            nn_idx, nn_d2, exact = _subseq_knn_fetch(
                sh, _qr_to(qr, sh.device), k_loc, opts, valid_mask=masks[s])
            gs.append(torch.where(torch.isfinite(nn_d2),
                                  nn_idx.to(torch.int64) + s * w_loc,
                                  torch.full_like(nn_idx, -1,
                                                  dtype=torch.int64)))
            ds.append(nn_d2)
            cs.append(exact[:, None])
    gidx, d2 = _gather(gs, dev0), _gather(ds, dev0)
    nn_idx, nn_d2 = _merge_topk(gidx, d2, min(kf, gidx.shape[-1]))
    exact = torch.all(_gather(cs, dev0), dim=-1)
    sel_idx, sel_d2 = _suppress_candidates(dsx, nn_idx.cpu().numpy(),
                                           nn_d2.cpu().numpy(), int(k), excl)
    return sel_idx, sel_d2, exact.cpu().numpy()


# ---------------------------------------------------------------------------
# Persistence: the sharded index as a long-lived on-disk artifact.
# ---------------------------------------------------------------------------


def store_sharded(index, path, n_valid: int | None = None):
    """Persist the sharded index, one store dir per shard, each written
    from its own shard (``index.sharded.store_sharded``)."""
    from ..index.sharded import store_sharded as _store
    return _store(index, path, n_valid=n_valid)


def load_sharded(path, mesh: ShardMesh, axis: str = "data",
                 verify: bool = False):
    """Warm-start the distributed engine from a sharded store: shard file
    *i* uploads to mesh device *i*.  Returns ``(ShardedDeviceIndex,
    n_valid)``; the stored shard count must match the mesh."""
    from ..index.sharded import load_sharded as _load
    return _load(path, mesh, axis=axis, verify=verify)


# ---------------------------------------------------------------------------
# The distributed quantized screen.
#
# Every shard holds its own slice of the int8 / bf16 screen columns on its
# device and screens it with kernel 5 (``engine._quantized_screen_backend``
# on ``cuda``, the plain oracle on ``torch``), then compacts its survivors
# into a (global id, valid) buffer.  Only those ids cross shards; the raw
# verify tier stays on the host (per-shard mmaps behind
# ``index.sharded.ShardedRaw``) and the exact verify gathers only the
# surviving rows, optionally double-buffered (``verify_prefetch``).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistTieredIndex:
    """Mesh-resident tiered index: one ``engine.QuantizedDeviceIndex`` of
    ``b_loc`` rows per shard (row counts padded to a multiple of ``shards
    × RESID_BLOCK``, so scale blocks never straddle a shard), and the
    host-side full-precision verify tier ``raw`` holding ONLY real rows:
    pad rows carry the level-0 sentinel code, the screen kills them, and
    the verify gather clamps ids."""

    shards: tuple
    raw: object
    n_valid: int

    @property
    def b_loc(self) -> int:
        return self.shards[0].size

    @property
    def size(self) -> int:
        return self.b_loc * len(self.shards)

    @property
    def mode(self) -> str:
        return self.shards[0].mode

    @property
    def n(self) -> int:
        return self.shards[0].n

    @property
    def levels(self) -> tuple:
        return self.shards[0].levels

    @property
    def alphabet(self) -> int:
        return self.shards[0].alphabet

    @property
    def stack(self) -> tuple:
        return self.shards[0].stack

    @property
    def device(self) -> torch.device:
        return self.shards[0].device


def _pad_rows(t: torch.Tensor, rows: int, fill=0) -> torch.Tensor:
    """Pad the leading axis of ``t`` up to ``rows`` with ``fill``."""
    if t.shape[0] >= rows:
        return t
    pad = torch.full((rows - t.shape[0],) + tuple(t.shape[1:]), fill,
                     dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def distributed_tiered_index(tindex: TieredIndex, mesh: ShardMesh,
                             axis: str = "data",
                             n_valid: int | None = None) -> DistTieredIndex:
    """Reshard a single-device ``engine.TieredIndex`` onto a mesh.

    Rows pad to a multiple of ``shards × RESID_BLOCK``; pad rows — and
    rows at or past ``n_valid`` — get the level-0 sentinel code, so C9
    kills them inside the screen at any finite radius.  The raw tier is
    not padded."""
    from ..index import quantized as _q

    qdev = tindex.dev
    int8 = qdev.mode == "int8"
    B = qdev.size
    R = int(tindex.raw.shape[0])
    n_valid = min(B, R) if n_valid is None else int(n_valid)
    P_sh = _shard_count(mesh, axis)
    quantum = P_sh * _q.RESID_BLOCK
    Bp = -(-B // quantum) * quantum
    nbp = Bp // _q.RESID_BLOCK
    b_loc, nb_loc = Bp // P_sh, nbp // P_sh
    res0 = _pad_rows(qdev.residuals[0], Bp).clone()
    live = torch.arange(Bp, device=res0.device) < n_valid
    sentinel = _q.SENTINEL_CODE if int8 else _q.PAD_RESIDUAL
    res0[~live] = torch.tensor(sentinel, dtype=res0.dtype,
                               device=res0.device)
    shards = []
    for s, dev in enumerate(mesh.devices):
        rows = slice(s * b_loc, (s + 1) * b_loc)
        blks = slice(s * nb_loc, (s + 1) * nb_loc)

        def r(t, fill=0):
            return None if t is None else \
                _pad_rows(t, Bp, fill)[rows].to(dev).contiguous()

        def b(t, fill=0):
            return None if t is None else \
                _pad_rows(t, nbp, fill)[blks].to(dev).contiguous()

        shards.append(QuantizedDeviceIndex(
            series=r(qdev.series),
            series_scale=r(qdev.series_scale, 1.0) if int8 else None,
            series_zero=r(qdev.series_zero, 0.0) if int8 else None,
            series_err=r(qdev.series_err), norms_sq=r(qdev.norms_sq),
            words=tuple(r(w) for w in qdev.words),
            residuals=(res0[rows].to(dev).contiguous(),)
            + tuple(r(t) for t in qdev.residuals[1:]),
            resid_scale=tuple(b(t, 1.0) for t in qdev.resid_scale),
            resid_zero=tuple(b(t, 0.0) for t in qdev.resid_zero),
            resid_err=tuple(b(t) for t in qdev.resid_err),
            extra=tuple({name: r(col) for name, col in lvl.items()}
                        for lvl in qdev.extra),
            levels=qdev.levels, alphabet=qdev.alphabet, mode=qdev.mode,
            stack=qdev.stack))
    return DistTieredIndex(shards=tuple(shards), raw=tindex.raw,
                           n_valid=n_valid)


def store_sharded_tiered(dti: DistTieredIndex, path):
    """Persist the mesh-resident tiered index, one store dir per shard
    (``index.sharded.store_sharded_quantized``)."""
    from ..index.sharded import store_sharded_quantized as _store
    return _store(dti, path, n_valid=dti.n_valid)


def load_sharded_tiered(path, mesh: ShardMesh, axis: str = "data",
                        verify: bool = False) -> DistTieredIndex:
    """Warm-start the distributed quantized engine from a tiered sharded
    store: shard file *i*'s screen columns upload to mesh device *i*, the
    raw verify tier stays a set of per-shard host mmaps
    (``index.sharded.load_sharded_tiered``)."""
    from ..index.sharded import load_sharded_tiered as _load
    shards, raw, n_valid = _load(path, mesh, axis=axis, verify=verify)
    return DistTieredIndex(shards=shards, raw=raw, n_valid=n_valid)


def _dist_quant_candidates(dti: DistTieredIndex, qr: QueryReprDev, eps_col,
                           opts: SearchOptions, cap0: int):
    """The screen on every shard (kernel 5 on ``cuda``), then one
    compaction at the first capacity of cap0, 4·cap0, … (capped at the
    shard size) that no shard overflows — the reference's escalating
    rounds, which recompute the same screen each round.  Returns
    ``(gidx (Q, P·C), valid (Q, P·C), overflow (Q, P))``."""
    b_loc = dti.b_loc
    keeps = []
    for shard in dti.shards:
        with _on(shard.device):
            keep, _ = _quantized_screen_backend(
                TieredIndex(dev=shard, raw=dti.raw),
                _qr_to(qr, shard.device), eps_col.to(shard.device),
                opts.backend)
        keeps.append(keep)
    most = max(int(k.sum(dim=-1).max()) if k.numel() else 0 for k in keeps)
    cap = min(b_loc, max(1, int(cap0)))
    for _ in range(opts.max_doublings):
        if cap >= b_loc or most <= cap:
            break
        cap = min(b_loc, cap * 4)
    out = [[], [], []]
    for s, keep in enumerate(keeps):
        idx, valid, overflow = _compact_mask(keep, cap)
        for acc, t in zip(out, (idx + s * b_loc, valid, overflow[:, None])):
            acc.append(t)
    return tuple(_gather(p, dti.device) for p in out)


def _dist_seed_eps(dti: DistTieredIndex, qr: QueryReprDev,
                   k: int) -> torch.Tensor:
    """k-NN seed radius: a strided verified sample of the host raw tier's
    own (real) rows, so the sampled k-th distance upper-bounds the global
    k-th."""
    R = int(dti.raw.shape[0])
    S = min(R, max(k, _KNN_SEED_SAMPLE))
    sample = (np.arange(S) * R) // S
    rows = torch.as_tensor(np.asarray(dti.raw[sample], np.float32),
                           device=qr.q.device)
    return _sample_eps(rows, qr.q, k)


def distributed_quantized_range_query(dti: DistTieredIndex, queries, epsilon,
                                      mesh: ShardMesh, axis: str = "data",
                                      options: SearchOptions | None = None,
                                      **legacy):
    """Exact range query with the quantized screen on every shard:
    ``(gidx (Q, P·C), answer (Q, P·C), d2 (Q, P·C), exact (Q,))``,
    set-identical to ``engine.quantized_range_query``; ``exact`` is True
    after escalation."""
    opts = _dist_options(options, legacy,
                               "distributed_quantized_range_query")
    _check_mesh(dti, mesh, axis)
    qr = _queries_qr(dti, queries, opts.normalize_queries)
    eps = _eps_qcol(epsilon, qr.q.shape[0], dti.device)
    cap0 = 64 if opts.capacity is None else int(opts.capacity)
    gidx, valid, overflow = _dist_quant_candidates(dti, qr, eps, opts, cap0)
    d2 = _verify_tier(dti.raw, gidx, qr.q, valid, opts)
    answer = valid & (d2 <= eps * eps)
    return gidx, answer, torch.where(answer, d2, INF), ~overflow.any(dim=-1)


def distributed_quantized_knn_query(dti: DistTieredIndex, queries, k: int,
                                    mesh: ShardMesh, axis: str = "data",
                                    options: SearchOptions | None = None,
                                    **legacy):
    """Exact k-NN with the quantized screen on every shard: seed a
    verified radius from the raw tier, screen at the slacked radius,
    verify the survivors' ids against the raw tier and take the global
    top-k (ties to the lowest global index).  Returns ``(nn_idx (Q, k),
    nn_d2 (Q, k), exact (Q,))``."""
    opts = _dist_options(options, legacy,
                               "distributed_quantized_knn_query")
    _check_mesh(dti, mesh, axis)
    qr = _queries_qr(dti, queries, opts.normalize_queries)
    k_eff = max(1, min(int(k), dti.n_valid))
    eps = _dist_seed_eps(dti, qr, k_eff)
    cap0 = max(4 * k_eff, 64) if opts.capacity is None else int(opts.capacity)
    gidx, valid, overflow = _dist_quant_candidates(
        dti, qr, _slacked(eps), opts, max(cap0, k_eff))
    d2 = _verify_tier(dti.raw, gidx, qr.q, valid, opts)
    nn_idx, nn_d2 = _merge_topk(gidx, d2, k_eff)
    nn_idx = torch.where(torch.isfinite(nn_d2), nn_idx,
                         torch.full_like(nn_idx, -1))
    return nn_idx, nn_d2, ~overflow.any(dim=-1)


def distributed_quantized_mixed_query(dti: DistTieredIndex, queries, epsilon,
                                      is_knn, k: int, mesh: ShardMesh,
                                      axis: str = "data",
                                      options: SearchOptions | None = None,
                                      **legacy):
    """Mixed range / k-NN batch over the mesh-resident tiered index, in
    the serving layout: ``(gidx, answer, d2, overflow (Q,))``, overflow
    all False after escalation; k-NN rows mark verified candidate slots
    (finish with ``engine.mixed_topk``)."""
    opts = _dist_options(options, legacy,
                               "distributed_quantized_mixed_query")
    _check_mesh(dti, mesh, axis)
    qr = _queries_qr(dti, queries, opts.normalize_queries)
    Q, dev = qr.q.shape[0], dti.device
    k_eff = max(1, min(int(k), dti.n_valid))
    knn_col = torch.as_tensor(np.asarray(is_knn), dtype=torch.bool,
                              device=dev).reshape(Q, 1)
    eps_req = _eps_qcol(epsilon, Q, dev)
    eps = torch.where(knn_col, _slacked(_dist_seed_eps(dti, qr, k_eff)),
                      eps_req)
    cap0 = max(4 * k_eff, 64) if opts.capacity is None else int(opts.capacity)
    gidx, valid, overflow = _dist_quant_candidates(
        dti, qr, eps, opts, max(cap0, k_eff))
    d2 = _verify_tier(dti.raw, gidx, qr.q, valid, opts)
    answer = torch.where(knn_col, valid, valid & (d2 <= eps_req * eps_req))
    gidx = torch.where(answer, gidx, torch.full_like(gidx, -1))
    return (gidx, answer, torch.where(answer, d2, INF),
            overflow.any(dim=-1))


# ---------------------------------------------------------------------------
# Failover serving engine.
#
# The collective engines above couple the shards: one dead device fails
# the whole dispatch.  ``FailoverShards`` trades that for independence:
# each shard is its own single-device ``DeviceIndex`` (or ``TieredIndex``)
# queried on its own thread with its own timeout, retry budget and health
# state, and the merge happens on the host.  When every shard answers, the
# merged result is the single-index engines'; when a shard is lost, the
# survivors merge into a *certified-partial* answer whose
# ``ShardCoverage`` says exactly what part of the database it covers.
# ---------------------------------------------------------------------------


class FailoverError(RuntimeError):
    """No shard produced an answer for a dispatch (all down/failed)."""


def _screen_of(shard):
    """The screen-tier index of a failover shard: a full-precision shard
    IS its screen (``DeviceIndex``); a quantized tiered shard
    (``engine.TieredIndex``) screens through ``.dev``."""
    return shard.dev if hasattr(shard, "dev") else shard


@dataclasses.dataclass(frozen=True)
class ShardCoverage:
    """The degraded-answer certificate: which part of the database this
    answer covers.  ``exact`` iff every shard answered — the serve layer
    propagates it onto each request."""

    shards_ok: int
    shards_total: int
    rows_ok: int
    rows_total: int

    @property
    def exact(self) -> bool:
        return self.shards_ok == self.shards_total

    def as_dict(self) -> dict:
        return {"exact": self.exact,
                "shards_ok": self.shards_ok,
                "shards_total": self.shards_total,
                "rows_ok": self.rows_ok,
                "rows_total": self.rows_total}


class FailoverShards:
    """Per-shard query execution with timeouts, retries, and failover.

    Health model (all counting is in dispatches/attempts, never wall
    clock, so chaos replays are deterministic), as the reference's:

      * every live shard is queried concurrently (thread pool; on a CUDA
        shard the thread issues its calls on that shard's device); a
        shard's attempt is bounded by a per-shard timeout — ``timeout_s``
        until the shard's ``StepWatchdog`` has ``min_samples``, then
        ``slow_factor × median`` (straggler hedging: a slow shard is
        re-dispatched rather than awaited; the re-dispatch writes fresh
        output tensors while the late attempt finishes);
      * a failed/timed-out attempt is retried up to ``retries`` times
        with exponential backoff (``backoff_s · 2^attempt``);
      * ``down_threshold`` consecutive exhausted dispatches mark the
        shard **down**: it is skipped until every ``probe_every``-th
        dispatch sends a single probe; a probe success marks it up again;
      * the surviving shards' ``(gidx, answer, d2)`` buffers concatenate
        shard-major (the collective engine's (d², lowest-index) order),
        and the dispatch returns a :class:`ShardCoverage`.  Zero
        survivors raises :class:`FailoverError`.

    Each shard answers through ``engine.mixed_query_backend`` (kernels
    1-2 on a CUDA shard; the reference calls the XLA ``mixed_query``) at
    the full shard capacity, or ``engine.quantized_mixed_query`` for a
    tiered shard (kernel 5), so a surviving shard's rows are answered
    exactly and a partial answer equals brute force over the covered
    rows.
    """

    def __init__(self, shards: Sequence,
                 offsets: Optional[Sequence[int]] = None,
                 n_valid: Optional[int] = None, *,
                 timeout_s: float = 30.0, retries: int = 2,
                 backoff_s: float = 0.02, slow_factor: float = 4.0,
                 down_threshold: int = 3, probe_every: int = 4,
                 capacity: Optional[int] = None, n_iters: int = 2,
                 normalize_queries: bool = False, backend: str = "auto",
                 on_event: Optional[Callable[[str, int], None]] = None):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = list(shards)
        P_sh = len(self.shards)
        sizes = [int(_screen_of(s).size) for s in self.shards]
        if offsets is None:
            offsets = list(np.cumsum([0] + sizes[:-1]))
        self.offsets = [int(o) for o in offsets]
        self.n_valid = int(sum(sizes) if n_valid is None else n_valid)
        ref = _screen_of(self.shards[0])
        self.levels = tuple(ref.levels)
        self.alphabet = int(ref.alphabet)
        self.stack = tuple(getattr(ref, "stack", DEFAULT_STACK))
        for s in map(_screen_of, self.shards[1:]):
            if (tuple(s.levels) != self.levels
                    or int(s.alphabet) != self.alphabet
                    or tuple(getattr(s, "stack", DEFAULT_STACK))
                    != self.stack):
                raise ValueError("shards disagree on (levels, alphabet, "
                                 "stack) — not one index")
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.down_threshold = int(down_threshold)
        self.probe_every = max(1, int(probe_every))
        self.capacity = capacity
        self.n_iters = int(n_iters)
        self.normalize_queries = bool(normalize_queries)
        self.backend = backend
        self.on_event = on_event
        self.events: collections.Counter = collections.Counter()

        # Valid-row masks: rows past n_valid or carrying the pad sentinel
        # never answer (the collective engines' rule); None when every
        # row is real.
        self._vmask, self._rows = [], []
        for si, s in enumerate(self.shards):
            B_s = sizes[si]
            hi = max(0, min(B_s, self.n_valid - self.offsets[si]))
            if hasattr(s, "dev"):
                # A tiered shard: its pad rows carry the level-0 sentinel
                # code and its screen kills them; live rows are its raw
                # rows within n_valid (the raw slice is trimmed at load).
                self._rows.append(int(min(hi, int(s.raw.shape[0]))))
                self._vmask.append(None)
                continue
            live = torch.arange(B_s, device=s.device) < hi
            live &= s.residuals[0] < 0.5 * _PAD_RESIDUAL
            self._rows.append(int(live.sum()))
            self._vmask.append(None if bool(live.all()) else live)

        self._wd = [StepWatchdog(slow_factor=slow_factor, window=64,
                                 min_samples=5) for _ in range(P_sh)]
        self._fail_streak = [0] * P_sh
        self._down = [False] * P_sh
        self._down_at = [0] * P_sh
        self._dispatch_no = 0
        self._pool = _futures.ThreadPoolExecutor(
            max_workers=max(2, 2 * P_sh),
            thread_name_prefix="repro-torch-failover")

    # --- construction -------------------------------------------------------

    @classmethod
    def from_series(cls, series: np.ndarray, shards: int,
                    levels: Sequence[int], alphabet: int,
                    normalize: bool = False, stack: tuple = DEFAULT_STACK,
                    device=None, **kw) -> "FailoverShards":
        """Build per-shard indexes from contiguous row splits of a host
        database (shards may be unequal — no padding rows needed), shard
        i on device i of ``make_data_mesh(shards, device=device)``."""
        series = np.asarray(series, np.float32)
        parts = np.array_split(series, int(shards))
        offsets = list(np.cumsum([0] + [p.shape[0] for p in parts[:-1]]))
        mesh = make_data_mesh(int(shards), device=device)
        devs = []
        for p, dev in zip(parts, mesh.devices):
            with _on(dev):
                devs.append(build_device_index(p, levels, alphabet,
                                               normalize=normalize,
                                               stack=stack, device=dev))
        return cls(devs, offsets=offsets, **kw)

    @classmethod
    def from_store(cls, path, verify: bool = False, device=None,
                   **kw) -> "FailoverShards":
        """Warm-start from a sharded store, keeping each ``shard_*/`` a
        separately-queryable index (``index.sharded.load_shard_indexes``)."""
        from ..index.sharded import load_shard_indexes
        devs, offsets, n_valid = load_shard_indexes(path, verify=verify,
                                                    device=device)
        return cls(devs, offsets=offsets, n_valid=n_valid, **kw)

    # --- introspection ------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def size(self) -> int:
        return self.n_valid

    @property
    def n(self) -> int:
        return int(_screen_of(self.shards[0]).n)

    @property
    def devices(self) -> tuple:
        return tuple(_screen_of(s).device for s in self.shards)

    def shard_states(self) -> list:
        return ["down" if d else "up" for d in self._down]

    def close(self, wait: bool = False):
        """Stop the shard pool.  ``wait``: first let every attempt already
        dispatched run to its end, a hedged-away straggler included, so
        that no shard query runs after ``close`` returns."""
        self._pool.shutdown(wait=wait)

    # --- health bookkeeping -------------------------------------------------

    def _emit(self, kind: str, n: int = 1):
        self.events[kind] += n
        if self.on_event is not None:
            self.on_event(kind, n)

    def _on_shard_ok(self, si: int):
        self._fail_streak[si] = 0
        if self._down[si]:
            self._down[si] = False
            self._emit("shard_up")

    def _on_shard_fail(self, si: int):
        self._fail_streak[si] += 1
        if (not self._down[si]
                and self._fail_streak[si] >= self.down_threshold):
            self._down[si] = True
            self._down_at[si] = self._dispatch_no
            self._emit("shard_down")

    def _timeout(self, si: int) -> float:
        wd = self._wd[si]
        if len(wd.window) >= wd.min_samples:
            return max(0.05, wd.slow_factor * statistics.median(wd.window))
        return self.timeout_s

    # --- per-shard execution ------------------------------------------------

    def _query_shard(self, si: int, qrs: dict, eps, knn, k: int):
        chaos.maybe_fire("shard_query", key=str(si))
        wd = self._wd[si]
        wd.start(self._dispatch_no)
        idx = self.shards[si]
        dev = _screen_of(idx).device
        B_s = int(_screen_of(idx).size)
        k_s = max(1, min(int(k), B_s))
        cap = B_s if self.capacity is None else int(self.capacity)
        cap = max(min(cap, B_s), k_s)
        with _on(dev):
            qr = qrs[dev]
            eps_t = torch.as_tensor(eps, dtype=torch.float32, device=dev)
            knn_t = torch.as_tensor(knn, dtype=torch.bool, device=dev)
            opts = SearchOptions(backend=self.backend, capacity=cap,
                                 n_iters=self.n_iters)
            if hasattr(idx, "dev"):
                ridx, answer, d2, overflow = quantized_mixed_query(
                    idx, qr, eps_t, knn_t, k_s, options=opts)
            else:
                ridx, answer, d2, overflow = mixed_query_backend(
                    idx, qr, eps_t, knn_t, k_s, options=opts,
                    valid_mask=self._vmask[si])
                # The buffer at the full shard capacity (dense on cuda):
                # compact it to the largest answer count before the copy,
                # slots staying in row order.
                most = int(answer.sum(dim=-1).max())
                pos, answer, d2, _ = compact_answers(answer, d2,
                                                     max(1, most))
                ridx = torch.gather(ridx, -1, pos.long())
            answer = answer.cpu().numpy()
            gidx = np.where(answer, ridx.cpu().numpy().astype(np.int64)
                            + self.offsets[si], -1)
            out = (gidx, answer, d2.cpu().numpy(), overflow.cpu().numpy())
        wd.stop()
        return out

    def _collect(self, si: int, fut, probe: bool, qrs, eps, knn, k: int):
        """Await one shard with its timeout; retry transient failures
        with exponential backoff.  Returns the shard result or None."""
        attempts = 1 if probe else self.retries + 1
        for a in range(attempts):
            try:
                out = fut.result(timeout=self._timeout(si))
                self._on_shard_ok(si)
                return out
            except _futures.TimeoutError:
                fut.cancel()
                self._emit("hedges")   # straggler: re-dispatch, don't wait
            except Exception:          # noqa: BLE001 — any shard-local
                pass                   # failure is survivable by design
            if a + 1 < attempts:
                self._emit("retries")
                time.sleep(self.backoff_s * (2 ** a))
                fut = self._pool.submit(self._query_shard, si, qrs, eps,
                                        knn, k)
        self._on_shard_fail(si)
        return None

    # --- the dispatch -------------------------------------------------------

    def query(self, q: np.ndarray, eps: np.ndarray, is_knn: np.ndarray,
              k: int):
        """One batch over every live shard.

        Returns ``(gidx, answer, d2, overflow, coverage)`` — the merged
        host buffers ((Q, ΣC_s) over surviving shards, global row ids,
        -1 in dead slots), the per-query overflow OR across survivors,
        and the :class:`ShardCoverage` certificate.
        """
        self._dispatch_no += 1
        dev0 = self.devices[0]
        qr = represent_queries(torch.as_tensor(np.asarray(q), dtype=torch
                                               .float32, device=dev0),
                               self.levels, self.alphabet,
                               normalize=self.normalize_queries,
                               stack=self.stack)
        qrs = {dev: _qr_to(qr, dev) for dev in set(self.devices)}
        eps = np.asarray(eps, np.float32)
        knn = np.asarray(is_knn, bool)

        plan = []   # (shard, is_probe)
        for si in range(self.n_shards):
            if not self._down[si]:
                plan.append((si, False))
            elif (self._dispatch_no - self._down_at[si]) \
                    % self.probe_every == 0:
                plan.append((si, True))
        futs = {si: self._pool.submit(self._query_shard, si, qrs, eps, knn,
                                      k)
                for si, _probe in plan}
        results = {}
        for si, probe in plan:
            out = self._collect(si, futs[si], probe, qrs, eps, knn, k)
            if out is not None:
                results[si] = out

        ok = sorted(results)
        if not ok:
            raise FailoverError(
                f"no shard answered dispatch {self._dispatch_no} "
                f"({self.n_shards} total, "
                f"{sum(self._down)} marked down)")
        gidx = np.concatenate([results[si][0] for si in ok], axis=-1)
        answer = np.concatenate([results[si][1] for si in ok], axis=-1)
        d2 = np.concatenate([results[si][2] for si in ok], axis=-1)
        overflow = np.logical_or.reduce([results[si][3] for si in ok])
        coverage = ShardCoverage(
            shards_ok=len(ok), shards_total=self.n_shards,
            rows_ok=int(sum(self._rows[si] for si in ok)),
            rows_total=int(sum(self._rows)))
        return gidx, answer, d2, overflow, coverage
