"""Wrappers of the fused FAST_SAX kernels (``csrc/fused_query.cu``).

Counterpart of ``repro/kernels/fused_query.py``: the whole-series forms
(``fused_range_pallas``, ``fused_topk_pallas``, ``merge_topk_partials``),
the quantized tier's (``fused_quant_range_pallas``,
``fused_quant_topk_pallas``) and the streaming subsequence forms
(``fused_subseq_range_pallas``, ``fused_subseq_topk_pallas``,
``fused_quant_subseq_range_pallas``).  One pass evaluates every cascade
level (C9, C10) and the Euclidean verify — on the quantized tier the
widened screen over dequantized rows; for subsequences over windows
built from stream segments — for a batch of queries while each database
tile is resident (design and bound in the ``.cu`` file's header).
Beside them, two kernels of the port's own with no Pallas counterpart,
:func:`compact_count` and :func:`compact_write`, turn a range pass's
dense (Q, B) answers into the compact (Q, C) layout before they are
copied to the host.

Each wrapper checks its inputs, then

  * on CUDA tensors launches the kernel on the current stream and adds
    one to its launch count (``<wrapper>.launches``, for every wrapper in
    :data:`KERNELS`) — or raises; there is no fallback;
  * on CPU tensors computes the same function with its plain PyTorch
    version in ``ref.py`` (no launch is counted).

Unlike the Pallas wrappers, nothing is padded: the kernel masks the
ragged edges in B and Q itself, so rows ≥ B never enter an answer or a
partial list.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build, ops, ref
from .ref import merge_topk_partials  # noqa: F401  (re-exported)

# Residual sentinel for masked database rows: C9 excludes them at any
# finite ε (the engine folds a valid_mask into level-0 residuals).
PAD_RESIDUAL = 1e30
# Longest per-block top-k list the CUDA selection keeps (csrc KSEL_MAX).
KSEL_MAX = 128
# Largest alphabet: the kernel stages query words as 16-bit offsets qw·α
# (csrc MAX_ALPHABET).
ALPHABET_MAX = 256
MAX_LEVELS = 4

_count_lock = threading.Lock()


def _lib():
    lib = build.load("fused_query")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        pvp = ctypes.POINTER(ctypes.c_void_p)
        lib.fused_query_launch.argtypes = [
            ci, vp, vp, ci, ci, ci, ctypes.POINTER(ci), pvp, pvp,
            vp, ci, vp, pvp, pvp, vp, ci, ci, ci, ci, vp, vp, ci, vp, vp, vp]
        lib.fused_query_launch.restype = ci
        lib.fused_quant_launch.argtypes = [
            ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.POINTER(ci), pvp,
            pvp, pvp, pvp, pvp, vp, ci, vp, pvp, pvp, vp, ci, ci, ci, ci, vp,
            vp, ci, vp, vp, vp]
        lib.fused_quant_launch.restype = ci
        lib.fused_subseq_launch.argtypes = [
            ci, ci, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci,
            ctypes.POINTER(ci), pvp, pvp, pvp, pvp, pvp, vp, ci, vp, pvp,
            pvp, vp, ci, ci, ci, ci, vp, vp, ci, vp, vp, vp]
        lib.fused_subseq_launch.restype = ci
        lib.fused_query_smem_bytes.argtypes = [
            ci, ci, ci, ctypes.POINTER(ci), ci, ci, ci, ci, ci, ci, ci]
        lib.fused_query_smem_bytes.restype = ci
        lib.fused_query_stages.argtypes = [
            ci, ci, ci, ctypes.POINTER(ci), ci, ci, ci, ci, ci, ci]
        lib.fused_query_stages.restype = ci
        lib.fused_query_div_check.argtypes = [vp, vp, vp, vp, ci, vp]
        lib.fused_query_div_check.restype = ci
        lib.compact_count_launch.argtypes = [vp, ci, ci, vp, vp, vp]
        lib.compact_count_launch.restype = ci
        lib.compact_write_launch.argtypes = [vp, vp, ci, ci, vp, vp, ci, vp,
                                             vp, vp]
        lib.compact_write_launch.restype = ci
        lib.fused_query_error.argtypes = [ci]
        lib.fused_query_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(**tensors):
    """The columns the kernel copies with 16-byte cp.async must start on a
    16-byte boundary (a fresh allocation does; a view may not)."""
    for name, t in tensors.items():
        ts = t if isinstance(t, (list, tuple)) else (t,)
        for i, x in enumerate(ts):
            if x is not None and x.data_ptr() % 16:
                raise ValueError(f"{name}{f'[{i}]' if t is not x else ''} "
                                 f"must be 16-byte aligned for the kernel")


def _check_query_words(q_words, levels, alphabet, Q, dev):
    if len(q_words) != len(levels):
        raise ValueError("q_words needs one entry per level")
    if not 2 <= int(alphabet) <= ALPHABET_MAX:
        raise ValueError(f"alphabet must be in [2, {ALPHABET_MAX}], "
                         f"got {alphabet}")
    for li, N in enumerate(levels):
        _check(f"q_words[{li}]", q_words[li], torch.int32, (Q, int(N)), dev)


def _panels(q_words, alphabet: int) -> tuple:
    """The plain versions' per-level (Q, α, N) panels of the query words."""
    return tuple(ops.query_panels(w, alphabet) for w in q_words)


def _check_stages(stages):
    if stages not in (None, 1, 2):
        raise ValueError(f"stages must be None (from the shape), 1 or 2, "
                         f"got {stages}")
    return stages or 0


def _check_inputs(series, norms_sq, words, residuals, q, q_words,
                  q_residuals, eps, levels, alphabet, n):
    """Validate the shared input pack; returns (B, Q, device)."""
    if not isinstance(series, torch.Tensor) or series.ndim != 2:
        raise ValueError("series must be a (B, n) tensor")
    B, dev = series.shape[0], series.device
    levels = tuple(int(N) for N in levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the fused kernels take 1 to {MAX_LEVELS} levels, "
                         f"got {len(levels)}")
    if len(words) != len(levels) or len(residuals) != len(levels) \
            or len(q_residuals) != len(levels):
        raise ValueError("words, residuals and q_residuals need one entry "
                         "per level")
    if B < 1:
        raise ValueError("the database is empty")
    if not isinstance(q, torch.Tensor) or q.ndim != 2 or q.shape[0] < 1:
        raise ValueError("q must be a non-empty (Q, n) tensor")
    Q = q.shape[0]
    f32 = torch.float32
    _check("series", series, f32, (B, n), dev)
    _check("norms_sq", norms_sq, f32, (B,), dev)
    _check("q", q, f32, (Q, n), dev)
    _check("eps", eps, f32, (Q,), dev)
    for li, N in enumerate(levels):
        if n % N:
            raise ValueError(f"level N={N} does not divide n={n}")
        _check(f"words[{li}]", words[li], torch.int32, (B, N), dev)
        _check(f"residuals[{li}]", residuals[li], f32, (B,), dev)
        _check(f"q_residuals[{li}]", q_residuals[li], f32, (Q,), dev)
    _check_query_words(q_words, levels, alphabet, Q, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        _check_aligned(series=series, norms_sq=norms_sq, words=words,
                       residuals=residuals)
    return B, Q, dev


def _check_tiles(block_q: int, block_b: int):
    if block_q not in (16, 32):
        raise ValueError(f"block_q must be 16 or 32, got {block_q}")
    if block_b < 64 or block_b % 64:
        raise ValueError(f"block_b must be a positive multiple of 64, "
                         f"got {block_b}")


def _ptrs(ts) -> ctypes.Array:
    """A C array of the tensors' device pointers (None -> null)."""
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _nullable(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.fused_query_error(code).decode())


def _table(alphabet: int, dev) -> torch.Tensor:
    """The (α, α) MINDIST table the kernel stages for C10."""
    return ops.mindist_table_cached(int(alphabet), str(dev))


def _launch(topk, series, norms_sq, words, residuals, q, q_words,
            q_residuals, eps, levels, alphabet, n, block_q, block_b, stages,
            ans=None, d2=None, k_sel=0, out_idx=None, out_d2=None):
    lib = _lib()
    L = len(levels)
    Ns = (ctypes.c_int * L)(*[int(N) for N in levels])
    tab = _table(alphabet, series.device)
    with torch.cuda.device(series.device):
        stream = torch.cuda.current_stream(series.device).cuda_stream
        code = lib.fused_query_launch(
            int(topk), series.data_ptr(), norms_sq.data_ptr(),
            series.shape[0], n, L, Ns, _ptrs(words), _ptrs(residuals),
            q.data_ptr(), q.shape[0], tab.data_ptr(), _ptrs(q_words),
            _ptrs(q_residuals), eps.data_ptr(), alphabet, block_q, block_b,
            stages, _nullable(ans), _nullable(d2), k_sel,
            _nullable(out_idx), _nullable(out_d2), stream)
    _raise_on(lib, code, "fused_query")


def fused_range(series, norms_sq, words, residuals, q, q_words, q_residuals,
                eps, *, levels, alphabet: int, n: int, block_q: int = 32,
                block_b: int = 1024, stages: int | None = None):
    """One fused range pass: ``(answers (Q, B) bool, d2 (Q, B) float32)``
    with +inf off the answers.

    ``series`` (B, n) f32, ``norms_sq`` (B,) f32 (‖u‖²), per level
    ``words`` (B, N) int32 in [0, alphabet) and ``residuals`` (B,) f32;
    ``q`` (Q, n) f32, per level ``q_words`` (Q, N) int32 in [0, alphabet)
    and ``q_residuals`` (Q,) f32; ``eps`` (Q,) f32.  All contiguous, on
    one device (on the card, the database columns 16-byte aligned).  The
    kernel reads the MINDIST cells from ``ops.mindist_table_cached``
    through the query words; the plain version takes their
    ``ops.query_panels``.  ``block_q`` (16 or 32), ``block_b`` (a
    multiple of 64) and ``stages`` (the ring's stages, 1 or 2; None: from
    the shape, ``ops.ring_stages``) shape the kernel only: the result does
    not depend on them.
    """
    B, Q, dev = _check_inputs(series, norms_sq, words, residuals, q,
                              q_words, q_residuals, eps, levels, alphabet, n)
    _check_tiles(block_q, block_b)
    stages = _check_stages(stages)
    if dev.type == "cpu":
        return ref.fused_range_ref(series, norms_sq, words, residuals, q,
                                   _panels(q_words, alphabet), q_residuals,
                                   eps, levels, n)
    ans = torch.empty((Q, B), dtype=torch.bool, device=dev)
    d2 = torch.empty((Q, B), dtype=torch.float32, device=dev)
    _launch(False, series, norms_sq, words, residuals, q, q_words,
            q_residuals, eps, levels, alphabet, n, block_q, block_b, stages,
            ans=ans, d2=d2)
    with _count_lock:
        fused_range.launches += 1
    return ans, d2


def fused_topk(series, norms_sq, words, residuals, q, q_words, q_residuals,
               eps, *, levels, alphabet: int, n: int, k: int,
               block_q: int = 32, block_b: int = 1024,
               stages: int | None = None):
    """One fused pass emitting block-local top-k partials:
    ``(idx (Q, nb·k) int32, d2 (Q, nb·k) float32)``, ``nb = ⌈B/block_b⌉``.

    For every block of ``block_b`` rows, the k smallest d² among that
    block's cascade survivors (no ε² filter), ascending with ties to the
    lower row, +inf / −1 on empty slots.  ``block_b`` is part of the
    output layout (the engine reshapes the partials to (Q, nb, k)); the
    inputs are those of :func:`fused_range`.  ``k`` ≤ min(block_b,
    KSEL_MAX).
    """
    B, Q, dev = _check_inputs(series, norms_sq, words, residuals, q,
                              q_words, q_residuals, eps, levels, alphabet, n)
    _check_tiles(block_q, block_b)
    stages = _check_stages(stages)
    k = int(k)
    if not 1 <= k <= min(block_b, KSEL_MAX):
        raise ValueError(f"k={k} must be in [1, min(block_b={block_b}, "
                         f"{KSEL_MAX})]")
    if dev.type == "cpu":
        return ref.fused_topk_ref(series, norms_sq, words, residuals, q,
                                  _panels(q_words, alphabet), q_residuals,
                                  eps, levels, n, k, block_b)
    nb = -(-B // block_b)
    out_idx = torch.empty((Q, nb * k), dtype=torch.int32, device=dev)
    out_d2 = torch.empty((Q, nb * k), dtype=torch.float32, device=dev)
    _launch(True, series, norms_sq, words, residuals, q, q_words,
            q_residuals, eps, levels, alphabet, n, block_q, block_b, stages,
            k_sel=k, out_idx=out_idx, out_d2=out_d2)
    with _count_lock:
        fused_topk.launches += 1
    return out_idx, out_d2


# ---------------------------------------------------------------------------
# The quantized resident tier.
# ---------------------------------------------------------------------------

_QUANT_MODES = {"int8": (1, torch.int8), "bf16": (2, torch.bfloat16)}


def _check_quant_inputs(qdev, q, q_words, q_residuals, eps):
    """Validate a quantized index (an ``engine.QuantizedDeviceIndex`` or
    any object with its fields) and the query pack; returns (B, Q, dev)."""
    if qdev.mode not in _QUANT_MODES:
        raise ValueError(f"quantized index mode must be one of "
                         f"{tuple(_QUANT_MODES)}, got {qdev.mode!r}")
    _, code_t = _QUANT_MODES[qdev.mode]
    series = qdev.series
    if not isinstance(series, torch.Tensor) or series.ndim != 2 \
            or series.shape[0] < 1:
        raise ValueError("series must be a non-empty (B, n) tensor")
    (B, n), dev = series.shape, series.device
    levels = tuple(int(N) for N in qdev.levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the fused kernels take 1 to {MAX_LEVELS} levels, "
                         f"got {len(levels)}")
    cols = (qdev.words, qdev.residuals, qdev.resid_scale, qdev.resid_zero,
            qdev.resid_err, q_residuals)
    if any(len(c) != len(levels) for c in cols):
        raise ValueError("words, residuals, resid_scale, resid_zero, "
                         "resid_err and q_residuals need one entry per "
                         "level")
    if not isinstance(q, torch.Tensor) or q.ndim != 2 or q.shape[0] < 1:
        raise ValueError("q must be a non-empty (Q, n) tensor")
    Q, nb = q.shape[0], -(-B // ref.RESID_BLOCK)
    f32, int8 = torch.float32, qdev.mode == "int8"
    _check("series", series, code_t, (B, n), dev)
    for name, t in (("series_scale", qdev.series_scale),
                    ("series_zero", qdev.series_zero)):
        if int8:
            _check(name, t, f32, (B,), dev)
        elif t is not None:
            raise ValueError(f"{name} must be None in bf16 mode")
    _check("series_err", qdev.series_err, f32, (B,), dev)
    _check("norms_sq", qdev.norms_sq, f32, (B,), dev)
    _check("q", q, f32, (Q, n), dev)
    _check("eps", eps, f32, (Q,), dev)
    for li, N in enumerate(levels):
        if n % N:
            raise ValueError(f"level N={N} does not divide n={n}")
        _check(f"words[{li}]", qdev.words[li], torch.int8, (B, N), dev)
        _check(f"residuals[{li}]", qdev.residuals[li], code_t, (B,), dev)
        for name, t in (("resid_scale", qdev.resid_scale[li]),
                        ("resid_zero", qdev.resid_zero[li])):
            if int8:
                _check(f"{name}[{li}]", t, f32, (nb,), dev)
            elif t is not None:
                raise ValueError(f"{name}[{li}] must be None in bf16 mode")
        _check(f"resid_err[{li}]", qdev.resid_err[li], f32, (nb,), dev)
        _check(f"q_residuals[{li}]", q_residuals[li], f32, (Q,), dev)
    _check_query_words(q_words, levels, qdev.alphabet, Q, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        _check_aligned(series=series, series_scale=qdev.series_scale,
                       series_zero=qdev.series_zero,
                       series_err=qdev.series_err, norms_sq=qdev.norms_sq,
                       words=qdev.words, residuals=qdev.residuals)
    return B, Q, dev


def _launch_quant(topk, qdev, q, q_words, q_residuals, eps, block_q,
                  block_b, stages, ans=None, d2=None, k_sel=0, out_idx=None,
                  out_d2=None):
    lib = _lib()
    L = len(qdev.levels)
    Ns = (ctypes.c_int * L)(*[int(N) for N in qdev.levels])
    series = qdev.series
    tab = _table(qdev.alphabet, series.device)
    with torch.cuda.device(series.device):
        stream = torch.cuda.current_stream(series.device).cuda_stream
        code = lib.fused_quant_launch(
            int(topk), _QUANT_MODES[qdev.mode][0], series.data_ptr(),
            _nullable(qdev.series_scale), _nullable(qdev.series_zero),
            qdev.series_err.data_ptr(), qdev.norms_sq.data_ptr(),
            series.shape[0], series.shape[1], L, Ns, _ptrs(qdev.words),
            _ptrs(qdev.residuals), _ptrs(qdev.resid_scale),
            _ptrs(qdev.resid_zero), _ptrs(qdev.resid_err), q.data_ptr(),
            q.shape[0], tab.data_ptr(), _ptrs(q_words), _ptrs(q_residuals),
            eps.data_ptr(), qdev.alphabet, block_q, block_b, stages,
            _nullable(ans), _nullable(d2), k_sel, _nullable(out_idx),
            _nullable(out_d2), stream)
    _raise_on(lib, code, "fused_quant")


def fused_quant_range(qdev, q, q_words, q_residuals, eps, *,
                      block_q: int = 32, block_b: int = 1024,
                      stages: int | None = None):
    """One pass of the quantized screen: ``(keep (Q, B) bool, d̂² (Q, B)
    float32)`` with +inf off the kept rows.

    ``qdev`` is an ``engine.QuantizedDeviceIndex``: ``series`` (B, n)
    int8 codes with ``series_scale``/``series_zero`` (B,) f32, or bf16;
    ``series_err`` and ``norms_sq`` (B,) f32; per level ``words`` (B, N)
    int8, ``residuals`` (B,) int8 or bf16, ``resid_scale``/``resid_zero``
    (int8 only) and ``resid_err`` (⌈B/128⌉,) f32.  The query side is that
    of :func:`fused_range`.  A row is kept when the widened cascade (C9
    ``gap ≤ ε + e_blk``, C10 unwidened) and the series screen
    ``d̂² ≤ ((ε + e_u)(1 + 1e-6) + 1e-6)²`` pass; kept rows still need
    the raw tier's exact verify.  The tiles and ``stages`` shape the kernel
    only.
    """
    B, Q, dev = _check_quant_inputs(qdev, q, q_words, q_residuals, eps)
    _check_tiles(block_q, block_b)
    stages = _check_stages(stages)
    if dev.type == "cpu":
        return ref.fused_quant_range_ref(qdev, q,
                                         _panels(q_words, qdev.alphabet),
                                         q_residuals, eps)
    keep = torch.empty((Q, B), dtype=torch.bool, device=dev)
    d2 = torch.empty((Q, B), dtype=torch.float32, device=dev)
    _launch_quant(False, qdev, q, q_words, q_residuals, eps, block_q,
                  block_b, stages, ans=keep, d2=d2)
    with _count_lock:
        fused_quant_range.launches += 1
    return keep, d2


def fused_quant_topk(qdev, q, q_words, q_residuals, eps, *, k: int,
                     block_q: int = 32, block_b: int = 1024,
                     stages: int | None = None):
    """The quantized screen emitting block-local top-k partials of d̂²
    among the kept rows: ``(idx (Q, nb·k) int32, d̂² (Q, nb·k) float32)``
    in the layout of :func:`fused_topk`, merged by
    :func:`merge_topk_partials`.  The candidates are screen-level
    (distances to the dequantized rows); no engine of the port calls it,
    as none of the reference calls its Pallas twin."""
    B, Q, dev = _check_quant_inputs(qdev, q, q_words, q_residuals, eps)
    _check_tiles(block_q, block_b)
    stages = _check_stages(stages)
    k = int(k)
    if not 1 <= k <= min(block_b, KSEL_MAX):
        raise ValueError(f"k={k} must be in [1, min(block_b={block_b}, "
                         f"{KSEL_MAX})]")
    if dev.type == "cpu":
        return ref.fused_quant_topk_ref(qdev, q,
                                        _panels(q_words, qdev.alphabet),
                                        q_residuals, eps, k, block_b)
    nb = -(-B // block_b)
    out_idx = torch.empty((Q, nb * k), dtype=torch.int32, device=dev)
    out_d2 = torch.empty((Q, nb * k), dtype=torch.float32, device=dev)
    _launch_quant(True, qdev, q, q_words, q_residuals, eps, block_q,
                  block_b, stages, k_sel=k, out_idx=out_idx, out_d2=out_d2)
    with _count_lock:
        fused_quant_topk.launches += 1
    return out_idx, out_d2


# ---------------------------------------------------------------------------
# Streaming subsequence search: the rows are the W = S·W_s z-normalised
# windows of (S, n_stream) raw streams, in canonical stream-major order;
# the kernels read the streams, never the (W, w) window matrix.
# ---------------------------------------------------------------------------


def _check_stream_inputs(streams, mu, sd, norms_sq, q, q_words,
                         q_residuals, eps, levels, alphabet, window, stride):
    """Validate the streams, the per-window moments and the query pack;
    returns (W, Q, device)."""
    if not isinstance(streams, torch.Tensor) or streams.ndim != 2 \
            or streams.shape[0] < 1:
        raise ValueError("streams must be a non-empty (S, n_stream) tensor")
    (S, n_stream), dev = streams.shape, streams.device
    window, stride = int(window), int(stride)
    if not 1 <= window <= n_stream or stride < 1:
        raise ValueError(f"need 1 <= window <= n_stream={n_stream} and "
                         f"stride >= 1, got window={window}, "
                         f"stride={stride}")
    if S * n_stream >= 2 ** 31:
        raise ValueError("the kernels index fewer than 2^31 stream samples")
    W = S * ((n_stream - window) // stride + 1)
    levels = tuple(int(N) for N in levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"the fused kernels take 1 to {MAX_LEVELS} levels, "
                         f"got {len(levels)}")
    if len(q_residuals) != len(levels):
        raise ValueError("q_residuals needs one entry per level")
    if not isinstance(q, torch.Tensor) or q.ndim != 2 or q.shape[0] < 1:
        raise ValueError("q must be a non-empty (Q, window) tensor")
    Q, f32 = q.shape[0], torch.float32
    _check("streams", streams, f32, (S, n_stream), dev)
    for name, t in (("mu", mu), ("sd", sd), ("norms_sq", norms_sq)):
        _check(name, t, f32, (W,), dev)
    _check("q", q, f32, (Q, window), dev)
    _check("eps", eps, f32, (Q,), dev)
    for li, N in enumerate(levels):
        if window % N:
            raise ValueError(f"level N={N} does not divide window={window}")
        _check(f"q_residuals[{li}]", q_residuals[li], f32, (Q,), dev)
    _check_query_words(q_words, levels, alphabet, Q, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        _check_aligned(streams=streams, mu=mu, sd=sd, norms_sq=norms_sq)
    return W, Q, dev


def _check_stream_columns(words, residuals, levels, W, dev):
    if len(words) != len(levels) or len(residuals) != len(levels):
        raise ValueError("words and residuals need one entry per level")
    for li, N in enumerate(levels):
        _check(f"words[{li}]", words[li], torch.int32, (W, int(N)), dev)
        _check(f"residuals[{li}]", residuals[li], torch.float32, (W,), dev)
    if dev.type == "cuda":
        _check_aligned(words=words, residuals=residuals)


def _check_quant_meta(qmeta, levels, W, dev):
    """Validate a ``core.subseq.SubseqQuantMeta`` (or any object with its
    fields) against W windows."""
    if qmeta.mode not in _QUANT_MODES:
        raise ValueError(f"quantized metadata mode must be one of "
                         f"{tuple(_QUANT_MODES)}, got {qmeta.mode!r}")
    code_t = _QUANT_MODES[qmeta.mode][1]
    int8, nb = qmeta.mode == "int8", -(-W // ref.RESID_BLOCK)
    cols = (qmeta.words, qmeta.residuals, qmeta.scale, qmeta.zero, qmeta.err)
    if any(len(c) != len(levels) for c in cols):
        raise ValueError("words, residuals, scale, zero and err need one "
                         "entry per level")
    for li, N in enumerate(levels):
        _check(f"words[{li}]", qmeta.words[li], torch.int8, (W, int(N)), dev)
        _check(f"residuals[{li}]", qmeta.residuals[li], code_t, (W,), dev)
        for name, t in (("scale", qmeta.scale[li]),
                        ("zero", qmeta.zero[li])):
            if int8:
                _check(f"{name}[{li}]", t, torch.float32, (nb,), dev)
            elif t is not None:
                raise ValueError(f"{name}[{li}] must be None in bf16 mode")
        _check(f"err[{li}]", qmeta.err[li], torch.float32, (nb,), dev)
    if dev.type == "cuda":
        _check_aligned(words=qmeta.words, residuals=qmeta.residuals)


def _launch_subseq(topk, mode, streams, mu, sd, norms_sq, words, residuals,
                   q, q_words, q_residuals, eps, levels, alphabet, window,
                   stride, block_q, block_b, stages, r_scale=None,
                   r_zero=None, r_err=None, ans=None, d2=None, k_sel=0,
                   out_idx=None, out_d2=None):
    lib = _lib()
    L = len(levels)
    Ns = (ctypes.c_int * L)(*[int(N) for N in levels])
    none = (None,) * L
    S, n_stream = streams.shape
    tab = _table(alphabet, streams.device)
    with torch.cuda.device(streams.device):
        stream = torch.cuda.current_stream(streams.device).cuda_stream
        code = lib.fused_subseq_launch(
            int(topk), mode, streams.data_ptr(), S, n_stream, int(stride),
            mu.data_ptr(), sd.data_ptr(), norms_sq.data_ptr(), mu.shape[0],
            int(window), L, Ns, _ptrs(words), _ptrs(residuals),
            _ptrs(r_scale or none), _ptrs(r_zero or none),
            _ptrs(r_err or none), q.data_ptr(), q.shape[0], tab.data_ptr(),
            _ptrs(q_words), _ptrs(q_residuals), eps.data_ptr(), alphabet,
            block_q, block_b, stages,
            _nullable(ans), _nullable(d2), k_sel, _nullable(out_idx),
            _nullable(out_d2), stream)
    _raise_on(lib, code, "fused_subseq")


def fused_subseq_range(streams, mu, sd, norms_sq, words, residuals, q,
                       q_words, q_residuals, eps, *, levels, alphabet: int,
                       window: int, stride: int, block_q: int = 32,
                       block_b: int = 1024, stages: int | None = None):
    """One streaming range pass: ``(answers (Q, W) bool, d2 (Q, W)
    float32)`` in canonical window order, +inf off the answers — those of
    :func:`fused_range` over the materialised windows, bit for bit.

    ``streams`` (S, n_stream) f32 raw; per window ``mu``, ``sd`` and
    ``norms_sq`` (‖z‖²) (W,) f32, per level ``words`` (W, N) int32 and
    ``residuals`` (W,) f32, W = S·((n_stream − window)//stride + 1); the
    query side is that of :func:`fused_range` with n = ``window``.  On the
    card the streams, μ, σ and the columns must be 16-byte aligned (the
    loader copies them with cp.async): a misaligned view is refused.
    ``block_b`` windows per thread block; the tiles and ``stages`` (the
    ring's stages, 1 or 2; None: from the shape, ``ops.ring_stages``)
    shape the kernel only."""
    W, Q, dev = _check_stream_inputs(streams, mu, sd, norms_sq, q, q_words,
                                     q_residuals, eps, levels, alphabet,
                                     window, stride)
    _check_stream_columns(words, residuals, levels, W, dev)
    _check_tiles(block_q, block_b)
    stages = _check_stages(stages)
    if dev.type == "cpu":
        return ref.fused_subseq_range_ref(streams, mu, sd, norms_sq, words,
                                          residuals, q,
                                          _panels(q_words, alphabet),
                                          q_residuals, eps, levels, window,
                                          stride)
    ans = torch.empty((Q, W), dtype=torch.bool, device=dev)
    d2 = torch.empty((Q, W), dtype=torch.float32, device=dev)
    _launch_subseq(False, 0, streams, mu, sd, norms_sq, words, residuals, q,
                   q_words, q_residuals, eps, levels, alphabet, window,
                   stride, block_q, block_b, stages, ans=ans, d2=d2)
    with _count_lock:
        fused_subseq_range.launches += 1
    return ans, d2


def fused_subseq_topk(streams, mu, sd, norms_sq, words, residuals, q,
                      q_words, q_residuals, eps, *, levels, alphabet: int,
                      window: int, stride: int, k: int, block_q: int = 32,
                      block_b: int = 1024, stages: int | None = None):
    """One streaming pass emitting block-local top-k partials: ``(idx
    (Q, nb·k) int32, d2 (Q, nb·k) float32)``, ``nb = ⌈W/block_b⌉``, in
    the layout of :func:`fused_topk` with canonical window ids (−1 / +inf
    on empty slots).  The inputs are those of :func:`fused_subseq_range`;
    ``k`` ≤ min(block_b, KSEL_MAX)."""
    W, Q, dev = _check_stream_inputs(streams, mu, sd, norms_sq, q, q_words,
                                     q_residuals, eps, levels, alphabet,
                                     window, stride)
    _check_stream_columns(words, residuals, levels, W, dev)
    _check_tiles(block_q, block_b)
    stages = _check_stages(stages)
    k = int(k)
    if not 1 <= k <= min(block_b, KSEL_MAX):
        raise ValueError(f"k={k} must be in [1, min(block_b={block_b}, "
                         f"{KSEL_MAX})]")
    if dev.type == "cpu":
        return ref.fused_subseq_topk_ref(streams, mu, sd, norms_sq, words,
                                         residuals, q,
                                         _panels(q_words, alphabet),
                                         q_residuals, eps, levels, window,
                                         stride, k, block_b)
    nb = -(-W // block_b)
    out_idx = torch.empty((Q, nb * k), dtype=torch.int32, device=dev)
    out_d2 = torch.empty((Q, nb * k), dtype=torch.float32, device=dev)
    _launch_subseq(True, 0, streams, mu, sd, norms_sq, words, residuals, q,
                   q_words, q_residuals, eps, levels, alphabet, window,
                   stride, block_q, block_b, stages, k_sel=k,
                   out_idx=out_idx, out_d2=out_d2)
    with _count_lock:
        fused_subseq_topk.launches += 1
    return out_idx, out_d2


def fused_quant_subseq_range(streams, mu, sd, norms_sq, qmeta, q, q_words,
                             q_residuals, eps, *, levels, alphabet: int,
                             window: int, stride: int, block_q: int = 32,
                             block_b: int = 1024,
                             stages: int | None = None):
    """One streaming range pass over quantized screen columns: ``(answers
    (Q, W) bool, d2 (Q, W) float32)``, final answers set-identical to
    :func:`fused_subseq_range`'s.

    ``qmeta`` is a ``core.subseq.SubseqQuantMeta``: per level ``words``
    (W, N) int8, ``residuals`` (W,) int8 codes or bf16, ``scale`` /
    ``zero`` (int8 only) and ``err`` (⌈W/128⌉,) f32 per block of 128
    windows.  C9 widens to ``gap ≤ ε + e_blk``, C10 runs on the int8
    words, the verify is exact over the streamed samples and cut at ε².
    The rest is as :func:`fused_subseq_range`."""
    W, Q, dev = _check_stream_inputs(streams, mu, sd, norms_sq, q, q_words,
                                     q_residuals, eps, levels, alphabet,
                                     window, stride)
    levels = tuple(int(N) for N in levels)
    _check_quant_meta(qmeta, levels, W, dev)
    _check_tiles(block_q, block_b)
    stages = _check_stages(stages)
    if dev.type == "cpu":
        return ref.fused_quant_subseq_range_ref(
            streams, mu, sd, norms_sq, qmeta, q, _panels(q_words, alphabet),
            q_residuals, eps, levels, window, stride)
    ans = torch.empty((Q, W), dtype=torch.bool, device=dev)
    d2 = torch.empty((Q, W), dtype=torch.float32, device=dev)
    _launch_subseq(False, _QUANT_MODES[qmeta.mode][0], streams, mu, sd,
                   norms_sq, qmeta.words, qmeta.residuals, q, q_words,
                   q_residuals, eps, levels, alphabet, window, stride,
                   block_q, block_b, stages, r_scale=qmeta.scale,
                   r_zero=qmeta.zero, r_err=qmeta.err, ans=ans, d2=d2)
    with _count_lock:
        fused_quant_subseq_range.launches += 1
    return ans, d2


# ---------------------------------------------------------------------------
# Compaction of a dense answer, the serving pass's step before its copy.
# ---------------------------------------------------------------------------

#: Mask slots one block of the compaction kernels covers (csrc CT_TILE).
COMPACT_TILE = 8192


def _check_answer(answer):
    if not isinstance(answer, torch.Tensor) or answer.ndim != 2:
        raise ValueError("answer must be a (Q, B) tensor")
    Q, B = answer.shape
    _check("answer", answer, torch.bool, (Q, B), answer.device)
    if not 1 <= Q <= 65535 or B < 1:
        raise ValueError(f"answer must have 1 to 65535 rows and at least "
                         f"one column, got {tuple(answer.shape)}")
    return Q, B, answer.device


def compact_count(answer):
    """The answers of a dense (Q, B) bool mask per tile of
    :data:`COMPACT_TILE` slots and per row: ``(tile_counts (Q, ⌈B/tile⌉)
    int32, count (Q,) int32)``, on the mask's device."""
    Q, B, dev = _check_answer(answer)
    if dev.type == "cpu":
        return ref.compact_count_ref(answer, COMPACT_TILE)
    tiles = torch.empty((Q, -(-B // COMPACT_TILE)), dtype=torch.int32,
                        device=dev)
    count = torch.zeros((Q,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.compact_count_launch(answer.data_ptr(), Q, B,
                                        tiles.data_ptr(), count.data_ptr(),
                                        stream)
    _raise_on(lib, code, "compact_count")
    with _count_lock:
        compact_count.launches += 1
    return tiles, count


def compact_write(answer, d2, tile_counts, count, C: int):
    """The compact layout of a dense answer pair, from
    :func:`compact_count`'s counts: ``(idx (Q, C) int32, d2 (Q, C)
    float32)``, row i's answer slots ascending in its first ``count[i]``
    slots, each with its d² as ``d2`` (Q, B) float32 held it, −1 / +inf
    after.  ``C`` is at least the largest count; at C = 0 nothing is
    launched."""
    Q, B, dev = _check_answer(answer)
    _check("d2", d2, torch.float32, (Q, B), dev)
    _check("tile_counts", tile_counts, torch.int32,
           (Q, -(-B // COMPACT_TILE)), dev)
    _check("count", count, torch.int32, (Q,), dev)
    C = int(C)
    if not 0 <= C <= B:
        raise ValueError(f"C must be in [0, B={B}], got {C}")
    if dev.type == "cpu":
        return ref.compact_write_ref(answer, d2, C)
    idx = torch.empty((Q, C), dtype=torch.int32, device=dev)
    out = torch.empty((Q, C), dtype=torch.float32, device=dev)
    if C == 0:
        return idx, out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.compact_write_launch(
            answer.data_ptr(), d2.data_ptr(), Q, B, tile_counts.data_ptr(),
            count.data_ptr(), C, idx.data_ptr(), out.data_ptr(), stream)
    _raise_on(lib, code, "compact_write")
    with _count_lock:
        compact_write.launches += 1
    return idx, out


KERNELS = (fused_range, fused_topk, fused_quant_range, fused_quant_topk,
           fused_subseq_range, fused_subseq_topk, fused_quant_subseq_range,
           compact_count, compact_write)
for _kernel in KERNELS:
    _kernel.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _count_lock:
        for kernel in KERNELS:
            kernel.launches = 0


_MODE_CODES = {None: 0, "int8": 1, "bf16": 2}


def smem_bytes_of_kernel(topk: bool, n: int, levels, alphabet: int,
                         block_q: int, Q: int = 0, k_sel: int = 0,
                         quant=None, stride: int = 0,
                         stages: int | None = None) -> int:
    """The kernel's own count of its shared memory (needs the built
    library); ``ops.fused_smem_bytes`` (``stride`` 0) and
    ``ops.subseq_smem_bytes`` (the streaming kernels at ``stride`` > 0,
    rows of length n = window) must agree with it.  ``quant``: None or
    the tier's mode; ``stages``: None for the launcher's choice."""
    L = len(levels)
    Ns = (ctypes.c_int * L)(*[int(N) for N in levels])
    return int(_lib().fused_query_smem_bytes(
        int(topk), n, L, Ns, alphabet, block_q, Q, k_sel,
        _MODE_CODES[quant or None], int(stride), int(stages or 0)))


def stages_of_kernel(topk: bool, n: int, levels, alphabet: int,
                     block_q: int, Q: int = 0, k_sel: int = 0, quant=None,
                     stride: int = 0) -> int:
    """The ring stages the kernel's launcher chooses for a launch shape
    (needs the built library); ``ops.ring_stages`` mirrors it."""
    L = len(levels)
    Ns = (ctypes.c_int * L)(*[int(N) for N in levels])
    return int(_lib().fused_query_stages(
        int(topk), n, L, Ns, alphabet, block_q, Q, k_sel,
        _MODE_CODES[quant or None], int(stride)))


def divide_check(a, b):
    """The streaming loader's z-tile divide and the card's IEEE divide
    (``__fdiv_rn``) elementwise on two f32 CUDA tensors of one shape:
    ``(fast, rn)``, which must be equal bit for bit.  A check for the
    card tests: it is on no path, counts no launch and has no plain
    version."""
    for name, t in (("a", a), ("b", b)):
        _check(name, t, torch.float32, a.shape, a.device)
    if a.device.type != "cuda":
        raise ValueError("divide_check runs on the card only")
    fast, rn = torch.empty_like(a), torch.empty_like(a)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.fused_query_div_check(a.data_ptr(), b.data_ptr(),
                                         fast.data_ptr(), rn.data_ptr(),
                                         a.numel(), stream)
    _raise_on(lib, code, "divide_check")
    return fast, rn
