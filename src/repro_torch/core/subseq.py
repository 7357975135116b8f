"""Subsequence similarity search over long streams.

Counterpart of ``repro/core/subseq.py``.  The rows of the database are
the length-w windows of a batch of raw streams under per-window
z-normalisation: find every window within ε of a short query, or its k
nearest windows with no two on one stream starting within an exclusion
zone of each other.

  * **Host half** (numpy f64, as the reference): per-window mean and
    standard deviation from cumulative sums of each stream, and every
    window's PAA word and linear-fit residual from O(N) cumsum lookups —
    the PAA of the z window is ``(m − μ)/σ`` of the raw segment means,
    its residual the raw residual over σ (:func:`build_subseq_index`);
    the exclusion-zone greedy (:func:`suppress_trivial_matches`) and the
    fetch count that makes it exact (:func:`knn_fetch_count`).
  * **Device half**: :class:`SubseqDeviceIndex` holds the raw streams,
    μ and σ, and an ordinary ``engine.DeviceIndex`` whose rows are the
    materialised windows (the torch engine and the windows-as-rows
    service use it).  The ``cuda`` backend answers through the streaming
    kernels ``fused_subseq_range`` / ``fused_subseq_topk`` (and
    ``fused_quant_subseq_range`` over quantized screen columns), which
    read stream segments and build each window tile in shared memory with
    the same f32 expression as :func:`device_windows` — so their answers
    and distances are those of the fused whole-series kernels over the
    materialised windows, bit for bit.

The store round trip (:func:`save_subseq_index` /
:func:`load_subseq_index`) writes and reads the reference's format.
The traced twins (:func:`subseq_range_query_traced`,
:func:`subseq_knn_query_traced`) return the cascade counters of
``obs/trace.py`` beside the untraced answers.  A stack beyond the paper
pair builds its extra columns from the same cumsum statistics through
each representation's ``window_symbolize_np`` hook (:class:`WindowStats`;
a representation without the hook is refused).  The torch engine's
cascade over the windows-as-rows index applies them; the streaming
kernels run the paper pair's cascade and verify exactly, so they return
the same answers, and the traced twins count the extras' kills.  The
quantized streaming screen reads the paper pair's columns only, as the
reference's does.  The stream-sharded distributed form is
``core/dist_search.py``'s ``distributed_subseq_*``: each shard holds a
:class:`SubseqDeviceIndex` over its streams and answers through the
entry points here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..index import quantized as _quant
from ..kernels import fused_query as _fused
from ..kernels import ops as kernel_ops
from ..kernels.ref import device_windows
from . import engine as _engine
from . import representation as repr_registry
from .engine import DeviceIndex, QueryReprDev, represent_queries
from .fastsax import FastSAXConfig, LevelData
from .options import SearchOptions, resolve_options
from .paa import row_sum, znormalize_np
from .sax import discretize_np

# Same floor as paa.znormalize / znormalize_np: a (near-)constant window
# z-normalises through the guarded σ instead of dividing by ~0.
ZNORM_EPS = 1e-8


def n_windows_per_stream(stream_len: int, window: int, stride: int) -> int:
    if window > stream_len:
        raise ValueError(f"window={window} longer than stream={stream_len}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    return (stream_len - window) // stride + 1


# ---------------------------------------------------------------------------
# Offline phase: amortised sliding-window features via cumulative sums.
# ---------------------------------------------------------------------------


def _cumsums(streams: np.ndarray):
    """Zero-prefixed cumulative sums of x, x² and t·x (f64): every window
    or segment sum below is two lookups, independent of its length."""
    S, n = streams.shape
    t = np.arange(n, dtype=np.float64)
    c0 = np.zeros((S, n + 1))
    c1 = np.zeros((S, n + 1))
    c2 = np.zeros((S, n + 1))
    np.cumsum(streams, axis=-1, out=c0[:, 1:])
    np.cumsum(streams * streams, axis=-1, out=c1[:, 1:])
    np.cumsum(streams * t[None, :], axis=-1, out=c2[:, 1:])
    return c0, c1, c2


def _window_moments(c0, c1, starts, window: int):
    """Per-window mean and guarded std, (S, W_s) each, from the cumsums."""
    mu = (c0[:, starts + window] - c0[:, starts]) / window
    ex2 = (c1[:, starts + window] - c1[:, starts]) / window
    sd = np.sqrt(np.maximum(ex2 - mu * mu, 0.0))
    return mu, np.maximum(sd, ZNORM_EPS)


@dataclasses.dataclass
class WindowStats:
    """One level's per-window segment statistics, handed to a
    representation's ``window_symbolize_np`` hook so that an extra column
    comes from the same O(N)-per-window cumsum lookups as the paper
    pair's.  ``sxy`` is None when L == 1 (a one-sample segment has no
    slope)."""

    sum_y: np.ndarray          # (S, W_s, N) raw segment sums
    sxy: np.ndarray | None     # (S, W_s, N) raw Σ xc·y per segment
    L: int                     # samples per segment
    sxx: float                 # Σ xc² of the centred abscissa (0 if L == 1)
    sd: np.ndarray             # (S, W_s) guarded per-window std
    alphabet: int


def _window_level(c0, c1, c2, starts, window, mu, sd, N, alphabet):
    """One representation level for every window of every stream, O(W·N):
    ``(words (S, W_s, N) int32, residuals (S, W_s) f64,`` the level's
    :class:`WindowStats` ``)``.

    The PAA of the z window is the affine image of the raw segment means,
    ``(m − μ)/σ``; the linear-fit residual of the z window is the raw
    residual over σ (z is an affine map of the raw window, the
    piecewise-linear class is closed under it, and the scale 1/σ
    multiplies every pointwise error)."""
    L = window // N
    bounds = starts[:, None] + np.arange(N + 1)[None, :] * L   # (W_s, N+1)
    g0 = c0[:, bounds]                                           # (S, W_s, N+1)
    sum_y = g0[..., 1:] - g0[..., :-1]
    mean = sum_y / L
    words = discretize_np((mean - mu[..., None]) / sd[..., None], alphabet)
    if L == 1:                                   # exact fit per sample
        return words, np.zeros(mu.shape), WindowStats(
            sum_y=sum_y, sxy=None, L=1, sxx=0.0, sd=sd, alphabet=alphabet)
    # With the centred abscissa xc = t − b − (L−1)/2 of each segment,
    # Σxc·y = (Σ t·y) − (b + (L−1)/2)·Σy: two more cumsum lookups.
    g1 = c1[:, bounds]
    g2 = c2[:, bounds]
    sum_y2 = g1[..., 1:] - g1[..., :-1]
    t_sum = g2[..., 1:] - g2[..., :-1]
    xc = np.arange(L, dtype=np.float64) - (L - 1) / 2.0
    sxx = float(np.sum(xc * xc))
    off = bounds[:, :-1] + (L - 1) / 2.0
    sxy = t_sum - off[None, :, :] * sum_y
    per_seg = np.maximum(sum_y2 - L * mean * mean - (sxy * sxy) / sxx, 0.0)
    return words, np.sqrt(per_seg.sum(axis=-1)) / sd, WindowStats(
        sum_y=sum_y, sxy=sxy, L=L, sxx=sxx, sd=sd, alphabet=alphabet)


@dataclasses.dataclass
class SubseqHostIndex:
    """The offline subsequence index: raw streams and per-window features.

    Windows are numbered stream-major: window ``wid`` lies on stream
    ``wid // windows_per_stream`` from position ``(wid %
    windows_per_stream) · stride``.  The (W, w) window matrix is not
    stored; :func:`materialize_windows_np` and :func:`device_windows`
    build it on demand."""

    config: FastSAXConfig
    window: int
    stride: int
    streams: np.ndarray        # (S, n_stream) float64, raw
    mu: np.ndarray             # (W,) float64 per-window mean
    sd: np.ndarray             # (W,) float64 guarded per-window std
    levels: list               # [LevelData] over the z windows, visit order

    @property
    def n_streams(self) -> int:
        return self.streams.shape[0]

    @property
    def stream_len(self) -> int:
        return self.streams.shape[-1]

    @property
    def windows_per_stream(self) -> int:
        return n_windows_per_stream(self.stream_len, self.window, self.stride)

    @property
    def n_windows(self) -> int:
        return self.n_streams * self.windows_per_stream

    def window_meta(self, wid):
        """Window ids -> (stream index, start position) arrays."""
        wid = np.asarray(wid)
        W_s = self.windows_per_stream
        return wid // W_s, (wid % W_s) * self.stride


def _as_streams(streams) -> np.ndarray:
    streams = np.asarray(streams, dtype=np.float64)
    if streams.ndim == 1:
        streams = streams[None, :]
    if streams.ndim != 2:
        raise ValueError(f"streams must be (S, n_stream), got {streams.shape}")
    return streams


def build_subseq_index(streams, config: FastSAXConfig, window: int,
                       stride: int = 1) -> SubseqHostIndex:
    """Offline phase: one pass over each stream (cumsums), then O(N) work
    per window and level.  ``window`` must be divisible by every level's
    segment count.  The stack's extra columns come from each
    representation's ``window_symbolize_np`` hook; a representation
    without one raises NotImplementedError."""
    streams = _as_streams(streams)
    for N in config.n_segments:
        if window % N != 0:
            raise ValueError(f"level N={N} does not divide window={window}")
    extras = config.extra_stack
    for name in extras:
        if getattr(repr_registry.get(name), "window_symbolize_np",
                   None) is None:
            raise NotImplementedError(
                f"representation {name!r} defines no window_symbolize_np "
                "hook, so it cannot be computed over sliding windows; drop "
                "it from the stack for subsequence search")
    W_s = n_windows_per_stream(streams.shape[-1], window, stride)
    starts = np.arange(W_s) * stride
    c0, c1, c2 = _cumsums(streams)
    mu, sd = _window_moments(c0, c1, starts, window)
    levels = []
    for N in config.levels:
        words, resid, ws = _window_level(c0, c1, c2, starts, window, mu, sd,
                                         N, config.alphabet)
        extra = {}
        for name in extras:
            rep = repr_registry.get(name)
            col = rep.window_symbolize_np(ws)
            extra[name] = (col.reshape(-1, col.shape[-1])
                           if rep.column.per_segment else col.reshape(-1))
        levels.append(LevelData(n_segments=N, words=words.reshape(-1, N),
                                residuals=resid.reshape(-1), extra=extra))
    return SubseqHostIndex(config=config, window=window, stride=stride,
                           streams=streams, mu=mu.reshape(-1),
                           sd=sd.reshape(-1), levels=levels)


def subseq_host_index_from_numpy(streams, mu, sd, words, residuals, levels,
                                 alphabet: int, window: int,
                                 stride: int) -> SubseqHostIndex:
    """A host index from numpy arrays — e.g. the fields of a reference
    ``SubseqHostIndex`` — so two engines can be compared on the same
    index (the subsequence twin of ``engine.device_index_from_numpy``).

    ``levels`` in visit order, per level ``words`` (W, N) and
    ``residuals`` (W,); ``mu`` and ``sd`` (W,).  Raises on inconsistent
    shapes."""
    streams = _as_streams(streams)
    levels = tuple(int(N) for N in levels)
    W = streams.shape[0] * n_windows_per_stream(streams.shape[-1], window,
                                                stride)
    ascending = tuple(sorted(levels))
    config = FastSAXConfig(
        n_segments=ascending, alphabet=int(alphabet),
        level_order="coarse_first" if levels == ascending else "paper")
    if config.levels != levels:
        raise ValueError(f"levels {levels} are neither coarse-first nor "
                         "fine-first")
    if len(words) != len(levels) or len(residuals) != len(levels):
        raise ValueError("words and residuals need one entry per level")
    mu, sd = np.asarray(mu, np.float64), np.asarray(sd, np.float64)
    if mu.shape != (W,) or sd.shape != (W,):
        raise ValueError(f"mu and sd must be ({W},)")
    lv = []
    for N, w, r in zip(levels, words, residuals):
        w, r = np.asarray(w), np.asarray(r, np.float64)
        if w.shape != (W, N) or r.shape != (W,) or window % N:
            raise ValueError(f"level N={N}: words must be ({W}, {N}) and "
                             f"residuals ({W},), and N must divide "
                             f"window={window}")
        lv.append(LevelData(n_segments=N, words=w.astype(np.int32),
                            residuals=r))
    return SubseqHostIndex(config=config, window=int(window),
                           stride=int(stride), streams=streams, mu=mu, sd=sd,
                           levels=lv)


def _window_positions(n_streams: int, W_s: int, stride: int):
    sid = np.repeat(np.arange(n_streams), W_s)
    start = np.tile(np.arange(W_s) * stride, n_streams)
    return sid, start


def materialize_windows_np(hidx: SubseqHostIndex) -> np.ndarray:
    """(W, window) float64 z-normalised windows — the host oracle."""
    sid, start = _window_positions(hidx.n_streams, hidx.windows_per_stream,
                                   hidx.stride)
    win = hidx.streams[sid[:, None],
                       start[:, None] + np.arange(hidx.window)[None, :]]
    return (win - hidx.mu[:, None]) / hidx.sd[:, None]


def subseq_brute_force_d2(streams, queries, window: int, stride: int = 1,
                          normalize_queries: bool = True) -> np.ndarray:
    """The f64 reference every engine answer is tested against: every
    window materialised and z-normalised on its own (``znormalize_np``,
    not the cumsum moments), each query z-normalised, the full (Q, W)
    squared Euclidean distance matrix.  O(Q·W·w): tests and checks
    only."""
    streams = _as_streams(streams)
    W_s = n_windows_per_stream(streams.shape[-1], window, stride)
    sid, start = _window_positions(streams.shape[0], W_s, stride)
    win = streams[sid[:, None], start[:, None] + np.arange(window)[None, :]]
    z = znormalize_np(win)
    q = np.asarray(queries, dtype=np.float64)
    if q.ndim == 1:
        q = q[None, :]
    if normalize_queries:
        q = znormalize_np(q)
    diff = z[None, :, :] - q[:, None, :]
    return np.sum(diff * diff, axis=-1)


# ---------------------------------------------------------------------------
# Trivial-match suppression (exclusion zone).
# ---------------------------------------------------------------------------


def exclusion_zone_span(excl: int, stride: int) -> int:
    """Z = the most window positions inside one exclusion zone
    (|Δstart| < excl on a stride-s grid): 2·⌊(excl−1)/s⌋ + 1."""
    if excl <= 0:
        return 1
    return 2 * ((int(excl) - 1) // int(stride)) + 1


def knn_fetch_count(k: int, excl: int, stride: int, n_windows: int) -> int:
    """How many globally nearest windows the greedy exclusion-zone
    selection needs to find k admissible answers.

    Scanning candidates in ascending (d², index) order, every rejected
    candidate lies in the zone of an already kept one; each of the first
    k−1 keeps zones at most Z−1 others, so the k-th keep has global rank
    at most k + (k−1)·(Z−1).  Capped at W."""
    Z = exclusion_zone_span(excl, stride)
    return min(int(n_windows), int(k) + (int(k) - 1) * (Z - 1))


def suppress_trivial_matches(idx, d2, stream_of, start_of, k: int,
                             excl: int):
    """Greedy exclusion-zone selection over sorted candidate lists.

    ``idx``/``d2``: (Q, K) candidates ascending by (d², index), −1 / +inf
    on empty slots.  A candidate is kept unless a kept window on the same
    stream starts within ``excl`` positions of it.  Returns ``(sel_idx
    (Q, k), sel_d2 (Q, k))``, −1 / +inf padded when fewer than k
    admissible windows exist.  A host epilogue: O(K·k) per query."""
    idx = np.asarray(idx)
    d2 = np.asarray(d2)
    Q, K = idx.shape
    sel_idx = np.full((Q, k), -1, dtype=np.int64)
    sel_d2 = np.full((Q, k), np.inf)
    for qi in range(Q):
        kept = 0
        kept_stream = np.empty(k, dtype=np.int64)
        kept_start = np.empty(k, dtype=np.int64)
        for ci in range(K):
            w = int(idx[qi, ci])
            if w < 0 or not np.isfinite(d2[qi, ci]):
                break                     # empties sort last: nothing left
            s, a = int(stream_of[w]), int(start_of[w])
            if excl > 0 and any(
                    kept_stream[j] == s and abs(int(kept_start[j]) - a) < excl
                    for j in range(kept)):
                continue
            kept_stream[kept] = s
            kept_start[kept] = a
            sel_idx[qi, kept] = w
            sel_d2[qi, kept] = d2[qi, ci]
            kept += 1
            if kept == k:
                break
    return sel_idx, sel_d2


# ---------------------------------------------------------------------------
# Device index: the streams, and the windows as rows of a DeviceIndex.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SubseqDeviceIndex:
    """Device-resident subsequence index.

    ``index`` is an ordinary :class:`engine.DeviceIndex` whose rows are
    the z-normalised windows (materialised by :func:`device_windows`,
    words and residuals from the host build): the torch engine and the
    windows-as-rows service use it.  ``streams`` (S, n_stream), ``mu`` and
    ``sd`` (W,) f32 feed the streaming kernels, which read stream
    segments instead of the materialised rows."""

    index: DeviceIndex
    streams: torch.Tensor
    mu: torch.Tensor
    sd: torch.Tensor
    window: int = 0
    stride: int = 1

    @property
    def device(self) -> torch.device:
        return self.streams.device

    @property
    def n_streams(self) -> int:
        return self.streams.shape[0]

    @property
    def stream_len(self) -> int:
        return self.streams.shape[-1]

    @property
    def windows_per_stream(self) -> int:
        return n_windows_per_stream(self.stream_len, self.window, self.stride)

    @property
    def n_windows(self) -> int:
        return self.index.size

    @property
    def levels(self) -> tuple:
        return self.index.levels

    @property
    def alphabet(self) -> int:
        return self.index.alphabet

    def window_meta(self, wid):
        """Window ids -> (stream index, start position) host arrays;
        negative ids (empty k-NN slots) map to (−1, −1)."""
        wid = np.asarray(wid)
        W_s = self.windows_per_stream
        sid = np.where(wid >= 0, wid // W_s, -1)
        start = np.where(wid >= 0, (wid % W_s) * self.stride, -1)
        return sid, start


def subseq_device_index(hidx: SubseqHostIndex,
                        device=None) -> SubseqDeviceIndex:
    """Upload the streams and the per-window features to ``device``
    (default: CUDA, see ``engine.resolve_device``); the window rows are
    materialised there by :func:`device_windows` and their norms ‖z‖²
    summed with ``paa.row_sum``, so each is independent of the batch.
    The stack's extra columns upload with the words."""
    stack = repr_registry.validate_stack(hidx.config.stack)
    extras = repr_registry.extra_names(stack)
    dev = _engine.resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    streams = f32(hidx.streams).contiguous()
    mu, sd = f32(hidx.mu), f32(hidx.sd)
    series = device_windows(streams, hidx.window, hidx.stride, mu,
                            sd).contiguous()
    index = DeviceIndex(
        series=series,
        norms_sq=row_sum(series * series),
        words=tuple(torch.as_tensor(lv.words.astype(np.int32), device=dev)
                    for lv in hidx.levels),
        residuals=tuple(f32(lv.residuals) for lv in hidx.levels),
        extra=tuple({name: _engine.upload_host_array(
                         lv.extra[name], _engine._extra_dtype(name), dev)
                     for name in extras}
                    for lv in hidx.levels) if extras else (),
        levels=tuple(int(lv.n_segments) for lv in hidx.levels),
        alphabet=int(hidx.config.alphabet),
        stack=stack)
    return SubseqDeviceIndex(index=index, streams=streams, mu=mu, sd=sd,
                             window=int(hidx.window), stride=int(hidx.stride))


def represent_subseq_queries(sidx: SubseqDeviceIndex, queries,
                             normalize: bool = True) -> QueryReprDev:
    """Represent window-length queries at every level of the index, on
    its device.  A query is a window, so whole-query z-normalisation is
    the per-window z-normalisation of the database side."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=sidx.device)
    if q.ndim == 1:
        q = q[None, :]
    if q.shape[-1] != sidx.window:
        raise ValueError(f"subseq queries must be length window="
                         f"{sidx.window}, got {q.shape[-1]}")
    return represent_queries(q, sidx.levels, sidx.alphabet,
                             normalize=normalize, stack=sidx.index.stack)


# ---------------------------------------------------------------------------
# Online phase: range and exclusion-zone k-NN, backend-dispatched.
# ---------------------------------------------------------------------------


def _subseq_blocks(sidx: SubseqDeviceIndex, Q: int, k: int = 0,
                   block_q: int | None = None, block_w: int | None = None,
                   quant: str | None = None):
    """Tiles of a streaming pass: ``(block_q, block_w)``, chosen by
    ``ops.choose_subseq_blocks`` unless both are given (``quant``: the
    mode of quantized screen columns); raises if they do not fit shared
    memory."""
    if block_q is None or block_w is None:
        bq, bw = kernel_ops.choose_subseq_blocks(
            Q, sidx.n_windows, sidx.window, sidx.stride, sidx.levels,
            sidx.alphabet, k=k, quant=quant)
        block_q, block_w = block_q or bq, block_w or bw
    if int(block_q) not in kernel_ops.FUSED_BLOCK_Q or int(block_w) < 64 \
            or int(block_w) % 64:
        raise ValueError(f"block_q must be one of {kernel_ops.FUSED_BLOCK_Q} "
                         f"and block_w a positive multiple of 64, got "
                         f"{block_q}, {block_w}")
    need = kernel_ops.subseq_smem_bytes(int(block_q), sidx.window,
                                        sidx.stride, sidx.levels,
                                        sidx.alphabet, Q, k, quant)
    if need > kernel_ops.SMEM_BYTES:
        raise ValueError(f"subseq tile block_q={block_q} needs {need} bytes "
                         f"of shared memory (> {kernel_ops.SMEM_BYTES})")
    return int(block_q), int(block_w)


def _stream_inputs(sidx: SubseqDeviceIndex) -> dict:
    return dict(streams=sidx.streams, mu=sidx.mu, sd=sidx.sd,
                norms_sq=sidx.index.norms_sq, levels=sidx.levels,
                alphabet=sidx.alphabet, window=sidx.window,
                stride=sidx.stride)


def subseq_range_query_fused(sidx: SubseqDeviceIndex, qr: QueryReprDev,
                             epsilon, block_q: int | None = None,
                             block_w: int | None = None):
    """Streaming range query, one ``fused_subseq_range`` pass (the
    reference's ``subseq_range_query_pallas``): the answers and d² of
    ``engine.range_query_fused`` over the materialised windows, read from
    stream segments.  Same return convention as :func:`subseq_range_query`."""
    Q = qr.q.shape[0]
    block_q, block_w = _subseq_blocks(sidx, Q, 0, block_q, block_w)
    return _fused.fused_subseq_range(
        **_stream_inputs(sidx), words=sidx.index.words,
        residuals=sidx.index.residuals, q=qr.q,
        q_words=qr.words, q_residuals=qr.residuals,
        eps=_engine._eps_vec(epsilon, Q, sidx.device),
        block_q=block_q, block_b=block_w)


def subseq_range_query(sidx: SubseqDeviceIndex, qr: QueryReprDev, epsilon,
                       options: SearchOptions | None = None, **legacy):
    """Every window within ε of each query: ``(answers (Q, W) bool, d2
    (Q, W))`` with +inf outside the answer set, window ids as row
    positions (map them with :meth:`SubseqDeviceIndex.window_meta`).
    Range answers carry no exclusion zone.  ``options.backend``: ``cuda``
    runs :func:`subseq_range_query_fused`, ``torch`` the torch engine
    over the materialised windows (``auto``: by the index's device).
    Other keywords are tile overrides of the fused form."""
    opts, fused_kw = resolve_options(options, legacy, "subseq_range_query")
    if _engine.resolve_backend(opts.backend, sidx.device) == "cuda":
        return subseq_range_query_fused(sidx, qr, epsilon, **fused_kw)
    return _engine.range_query(sidx.index, qr, epsilon)


def _subseq_knn_fused(sidx: SubseqDeviceIndex, qr: QueryReprDev, k: int,
                      n_iters: int, block_q: int | None = None,
                      block_w: int | None = None,
                      valid_mask: torch.Tensor | None = None):
    """Streaming twin of ``engine.knn_query_fused`` (the reference's
    ``_subseq_knn_pallas``): seed, ``n_iters − 1`` tightening passes, a
    final pass, merge and certificate, each pass one ``fused_subseq_topk``
    read emitting block-local partials in canonical window ids; the
    candidates re-verify in the diff² form over the materialised windows,
    so the distances are the torch engine's.  ``valid_mask`` (W,) keeps
    windows out of the seed sample and the answers (a stream shard's
    padded windows; their level-0 sentinel already fails C9 in the
    kernel)."""
    Q = qr.q.shape[0]
    index = sidx.index
    k = min(int(k), index.size)
    block_q, block_w = _subseq_blocks(sidx, Q, k + _engine._TOPK_GUARD,
                                      block_q, block_w)
    k_sel = min(k + _engine._TOPK_GUARD, block_w)

    def topk_pass(eps):
        idxp, _ = _fused.fused_subseq_topk(
            **_stream_inputs(sidx), words=index.words,
            residuals=index.residuals, q=qr.q, q_words=qr.words,
            q_residuals=qr.residuals,
            eps=_engine._cascade_eps(eps).reshape(-1).contiguous(),
            k=k_sel, block_q=block_q, block_b=block_w)
        return idxp, _engine._reverify_rows(index, qr, idxp, valid_mask)

    eps = _engine._seed_eps(index, qr, k, valid_mask)
    for _ in range(max(0, int(n_iters) - 1)):
        _, d2v = topk_pass(eps)
        eps = torch.minimum(eps, torch.sqrt(_engine._kth_smallest(d2v, k)))
    idxp, d2v = topk_pass(eps)
    nn_idx, nn_d2 = _fused.merge_topk_partials(idxp, d2v, k)
    exact = _engine._topk_exact_certificate(d2v, nn_d2, k, k_sel, block_w)
    return nn_idx, nn_d2, exact


def _subseq_knn_fetch(sidx: SubseqDeviceIndex, qr: QueryReprDev, kf: int,
                      opts: SearchOptions, block_q=None, block_w=None,
                      valid_mask: torch.Tensor | None = None):
    """The k-NN fetch of :func:`subseq_knn_query`: the exact k-NN of the
    ``kf`` nearest windows, by the streaming kernels on ``cuda`` (a fetch
    keeping more than ``cost_model.TOPK_DEMOTE_KSEL`` slots demotes to the
    torch engine, as the reference demotes its Pallas selection).
    ``valid_mask`` excludes windows (a stream shard's pads)."""
    if _engine.resolve_knn_backend(opts.backend, kf, sidx.device) == "cuda":
        return _subseq_knn_fused(sidx, qr, kf, opts.n_iters, block_q,
                                 block_w, valid_mask)
    return _engine.knn_query_auto(sidx.index, qr, kf, capacity=opts.capacity,
                                  n_iters=opts.n_iters,
                                  valid_mask=valid_mask,
                                  max_doublings=opts.max_doublings)


def subseq_knn_query(sidx: SubseqDeviceIndex, qr: QueryReprDev, k: int,
                     excl: int | None = None,
                     options: SearchOptions | None = None,
                     block_q: int | None = None, block_w: int | None = None,
                     **legacy):
    """Exact k nearest non-trivial windows per query.

    ``excl`` is the exclusion-zone radius in start positions (default
    ``window // 2``; 0 turns suppression off): no two reported windows
    on one stream start within ``excl`` of each other.  The engine
    fetches the :func:`knn_fetch_count` globally nearest windows through
    the exact k-NN path and runs the greedy on the host, so the answer is
    the brute-force greedy over the f64 distance profile.

    Returns host arrays ``(sel_idx (Q, k) int64, sel_d2 (Q, k) f64, exact
    (Q,))``, −1 / +inf where fewer than k admissible windows exist;
    ``exact`` is the fetch's certificate."""
    opts, rest = resolve_options(options, legacy, "subseq_knn_query")
    if rest:
        raise TypeError(f"subseq_knn_query: unexpected kwargs {sorted(rest)}")
    excl = (sidx.window // 2) if excl is None else int(excl)
    kf = knn_fetch_count(k, excl, sidx.stride, sidx.n_windows)
    idx, d2, exact = _subseq_knn_fetch(sidx, qr, kf, opts, block_q, block_w)
    sel_idx, sel_d2 = _suppress_candidates(sidx, idx.cpu().numpy(),
                                           d2.cpu().numpy(), int(k), excl)
    return sel_idx, sel_d2, exact.cpu().numpy()


def _suppress_candidates(sidx, idx: np.ndarray, d2: np.ndarray, k: int,
                         excl: int):
    """:func:`suppress_trivial_matches` over (Q, K) candidate window ids,
    run on the candidates' positions with each one's stream and start
    (``sidx.window_meta``: a :class:`SubseqDeviceIndex` or the
    stream-sharded ``dist_search.DistSubseqIndex``), so the host never
    maps all W windows."""
    pos = np.where(idx >= 0, np.arange(idx.size).reshape(idx.shape), -1)
    stream_of, start_of = sidx.window_meta(idx.reshape(-1))
    sel_pos, sel_d2 = suppress_trivial_matches(pos, d2, stream_of, start_of,
                                               k, excl)
    sel_idx = np.where(sel_pos >= 0, idx.reshape(-1)[sel_pos], -1)
    return sel_idx.astype(np.int64), sel_d2


def subseq_range_query_traced(sidx: SubseqDeviceIndex, qr: QueryReprDev,
                              epsilon, options: SearchOptions | None = None,
                              **legacy):
    """:func:`subseq_range_query` and its cascade trace: ``(answers, d2,
    trace)``.  The answers are the untraced call's (on ``cuda``: kernel
    3); windows are rows, so the trace is ``engine.cascade_trace`` over
    the windows-as-rows index, whose counters equal the host engine's
    over the materialised windows at the same ε."""
    opts, fused_kw = resolve_options(options, legacy,
                                     "subseq_range_query_traced")
    ans, d2 = subseq_range_query(sidx, qr, epsilon, options=opts, **fused_kw)
    trace = _engine.cascade_trace(sidx.index, qr, epsilon)
    return ans, d2, dataclasses.replace(trace,
                                        answers=_engine._count_alive(ans))


def subseq_knn_query_traced(sidx: SubseqDeviceIndex, qr: QueryReprDev,
                            k: int, excl: int | None = None,
                            options: SearchOptions | None = None,
                            block_q: int | None = None,
                            block_w: int | None = None, **legacy):
    """:func:`subseq_knn_query` and its cascade trace at the FETCH radius:
    ``(sel_idx, sel_d2, exact, trace)``.

    The trace describes the device work done: the engine fetches the
    :func:`knn_fetch_count` nearest windows (on ``cuda``: kernel 4), so
    the counters are taken at that fetch's final verified radius; the
    exclusion-zone greedy is host bookkeeping over the fetched rows.
    ``answers`` is the answer count per query after the greedy."""
    opts, rest = resolve_options(options, legacy, "subseq_knn_query_traced")
    if rest:
        raise TypeError(
            f"subseq_knn_query_traced: unexpected kwargs {sorted(rest)}")
    excl = (sidx.window // 2) if excl is None else int(excl)
    kf = knn_fetch_count(k, excl, sidx.stride, sidx.n_windows)
    idx, d2, exact = _subseq_knn_fetch(sidx, qr, kf, opts, block_q, block_w)
    trace = _engine.knn_radius_trace(sidx.index, qr, d2,
                                     min(int(kf), int(d2.shape[-1])))
    sel_idx, sel_d2 = _suppress_candidates(sidx, idx.cpu().numpy(),
                                           d2.cpu().numpy(), int(k), excl)
    answers = torch.as_tensor(np.isfinite(sel_d2).sum(axis=-1),
                              dtype=torch.int32, device=sidx.device)
    return (sel_idx, sel_d2, exact.cpu().numpy(),
            dataclasses.replace(trace, answers=answers))


# ---------------------------------------------------------------------------
# Persistence: a plain index store whose rows are the windows.
# ---------------------------------------------------------------------------

_SUBSEQ_META = "subseq"
_STREAMS_COL = "subseq_streams"
_MU_COL = "subseq_mu"
_SD_COL = "subseq_sd"


def save_subseq_index(hidx: SubseqHostIndex, path, extra_meta=None):
    """Persist as a standard ``fastsax-index`` store whose rows are the
    materialised z windows (f64), with the raw streams and the window
    moments riding along as checksummed extra columns, as the reference
    writes it.  The whole index lifecycle (``index.cli info`` /
    ``verify``, ``DeviceIndex.from_store``, ``SearchService.from_store``)
    works on it unchanged; :func:`load_subseq_index` restores the
    stream-aware view."""
    from ..index import store as _store
    from .fastsax import FastSAXIndex

    windows = materialize_windows_np(hidx)
    fsi = FastSAXIndex(config=hidx.config, series=windows, levels=hidx.levels)
    meta = {_SUBSEQ_META: {"window": int(hidx.window),
                           "stride": int(hidx.stride),
                           "n_streams": int(hidx.n_streams),
                           "stream_len": int(hidx.stream_len)},
            **(extra_meta or {})}
    return _store.save_index(
        fsi, path, extra_meta=meta,
        extra_arrays={_STREAMS_COL: hidx.streams, _MU_COL: hidx.mu,
                      _SD_COL: hidx.sd})


def load_subseq_index(path, mmap: bool = True,
                      verify: bool = False) -> SubseqHostIndex:
    """Reopen a committed subsequence store (an mmap open).  Raises
    ``IOError`` on a store :func:`save_subseq_index` did not write: a
    whole-series store has no streams to answer from.  The stored window
    rows are not read; :func:`subseq_device_index` builds them on the
    card from the streams, as after a cold build."""
    from ..index import store as _store

    fsi = _store.load_index(path, mmap=mmap, verify=verify)
    manifest = _store.read_manifest(path)
    sub = manifest.get("extra", {}).get(_SUBSEQ_META)
    if sub is None:
        raise IOError(f"{path}: not a subsequence store (no "
                      f"{_SUBSEQ_META!r} metadata — see save_subseq_index)")
    col = lambda name: np.asarray(_store.read_array(
        path, name, manifest, mmap=mmap, verify=verify))
    return SubseqHostIndex(config=fsi.config, window=int(sub["window"]),
                           stride=int(sub["stride"]),
                           streams=col(_STREAMS_COL), mu=col(_MU_COL),
                           sd=col(_SD_COL), levels=fsi.levels)


# ---------------------------------------------------------------------------
# Quantized screen columns: the words and residuals stream as int8/bf16;
# the raw samples are streamed anyway, so the verify stays exact.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SubseqQuantMeta:
    """Quantized per-window screen columns for ``fused_quant_subseq_range``.

    Only the screen columns (SAX words, linear-fit residuals) are
    quantized, with the whole-series tier's encoders: per level ``words``
    (W, N) int8, ``residuals`` (W,) int8 codes or bf16, and per block of
    ``index.quantized.RESID_BLOCK`` windows the f32 ``scale`` and
    ``zero`` (int8 only, else None) and ``err``, the realized
    dequantization error.  The reference expands the block parameters to
    one value per window; here the kernel and the plain version read
    window ``wid``'s at ``wid // RESID_BLOCK`` (``kernels.ref.
    expand_block_col`` gives the reference's per-window columns): the
    same values from fewer bytes."""

    mode: str
    words: tuple
    residuals: tuple
    scale: tuple
    zero: tuple
    err: tuple


def quantize_subseq_meta(hidx: SubseqHostIndex, mode: str = "int8",
                         device=None) -> SubseqQuantMeta:
    """Quantize the per-window screen columns of a built index with the
    whole-series encoders (``index/quantized.py``: the same codes, the
    same realized error bound, the same ``zero + scale · code``), on
    ``device`` (default: CUDA)."""
    _quant.check_mode(mode)
    if mode == "none":
        raise _quant.QuantizationError(
            "quantize_subseq_meta: mode 'none' has no quantized metadata; "
            "use the full-precision subseq_range_query instead")
    dev = _engine.resolve_device(device)

    def col(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a, np.float32).reshape(-1), device=dev)

    words, residuals, scale, zero, err = [], [], [], [], []
    for lv in hidx.levels:
        words.append(_engine._upload_codes(_quant.narrow_words(lv.words),
                                           dev))
        codes, sc, zp, e_blk = _quant.quantize_residuals(lv.residuals, mode)
        residuals.append(_engine._upload_codes(codes, dev))
        scale.append(col(sc))
        zero.append(col(zp))
        err.append(col(e_blk))
    return SubseqQuantMeta(mode=mode, words=tuple(words),
                           residuals=tuple(residuals), scale=tuple(scale),
                           zero=tuple(zero), err=tuple(err))


def subseq_range_query_quantized(sidx: SubseqDeviceIndex,
                                 qmeta: SubseqQuantMeta, qr: QueryReprDev,
                                 epsilon, block_q: int | None = None,
                                 block_w: int | None = None):
    """Streaming range query over quantized screen columns, one
    ``fused_quant_subseq_range`` pass: answers set-identical to
    :func:`subseq_range_query`.  The widened C9 (``gap ≤ ε + e``) keeps
    the cascade a superset screen and the verify over the streamed raw
    samples is exact, so the ε cut is made on the same f32 distances."""
    Q = qr.q.shape[0]
    block_q, block_w = _subseq_blocks(sidx, Q, 0, block_q, block_w,
                                      quant=qmeta.mode)
    return _fused.fused_quant_subseq_range(
        **_stream_inputs(sidx), qmeta=qmeta, q=qr.q, q_words=qr.words,
        q_residuals=qr.residuals,
        eps=_engine._eps_vec(epsilon, Q, sidx.device),
        block_q=block_q, block_b=block_w)
