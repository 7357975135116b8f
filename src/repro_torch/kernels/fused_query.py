"""Wrappers of the fused FAST_SAX kernels (``csrc/fused_query.cu``).

Counterpart of the whole-series part of ``repro/kernels/fused_query.py``
(``fused_range_pallas``, ``fused_topk_pallas``, ``merge_topk_partials``).
One pass evaluates every cascade level (C9, C10) and the Euclidean
verify for a batch of queries while each database tile is resident
(design and bound in the ``.cu`` file's header).

Each wrapper checks its inputs, then

  * on CUDA tensors launches the kernel on the current stream and adds
    one to its launch count (``fused_range.launches``,
    ``fused_topk.launches``) — or raises; there is no fallback;
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

from . import build, ref
from .ref import merge_topk_partials  # noqa: F401  (re-exported)

# Residual sentinel for masked database rows: C9 excludes them at any
# finite ε (the engine folds a valid_mask into level-0 residuals).
PAD_RESIDUAL = 1e30
# Longest per-block top-k list the CUDA selection keeps (csrc KSEL_MAX).
KSEL_MAX = 128
MAX_LEVELS = 4

_count_lock = threading.Lock()


def _lib():
    lib = build.load("fused_query")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        pvp = ctypes.POINTER(ctypes.c_void_p)
        lib.fused_query_launch.argtypes = [
            ci, vp, vp, ci, ci, ci, ctypes.POINTER(ci), pvp, pvp,
            vp, ci, pvp, pvp, vp, ci, ci, ci, vp, vp, ci, vp, vp, vp]
        lib.fused_query_launch.restype = ci
        lib.fused_query_smem_bytes.argtypes = [
            ci, ci, ci, ctypes.POINTER(ci), ci, ci, ci, ci]
        lib.fused_query_smem_bytes.restype = ci
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


def _check_inputs(series, norms_sq, words, residuals, q, q_panels,
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
            or len(q_panels) != len(levels) or len(q_residuals) != len(levels):
        raise ValueError("words, residuals, q_panels and q_residuals need "
                         "one entry per level")
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
        _check(f"q_panels[{li}]", q_panels[li], f32, (Q, alphabet, N), dev)
        _check(f"q_residuals[{li}]", q_residuals[li], f32, (Q,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and series.data_ptr() % 16:
        raise ValueError("series must be 16-byte aligned for the kernel")
    return B, Q, dev


def _check_tiles(block_q: int, block_b: int):
    if block_q not in (16, 32):
        raise ValueError(f"block_q must be 16 or 32, got {block_q}")
    if block_b < 64 or block_b % 64:
        raise ValueError(f"block_b must be a positive multiple of 64, "
                         f"got {block_b}")


def _launch(topk, series, norms_sq, words, residuals, q, q_panels,
            q_residuals, eps, levels, alphabet, n, block_q, block_b,
            ans=None, d2=None, k_sel=0, out_idx=None, out_d2=None):
    lib = _lib()
    L = len(levels)
    ptrs = lambda ts: (ctypes.c_void_p * L)(*[t.data_ptr() for t in ts])
    Ns = (ctypes.c_int * L)(*[int(N) for N in levels])
    nullable = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(series.device):
        stream = torch.cuda.current_stream(series.device).cuda_stream
        code = lib.fused_query_launch(
            int(topk), series.data_ptr(), norms_sq.data_ptr(),
            series.shape[0], n, L, Ns, ptrs(words), ptrs(residuals),
            q.data_ptr(), q.shape[0], ptrs(q_panels), ptrs(q_residuals),
            eps.data_ptr(), alphabet, block_q, block_b, nullable(ans),
            nullable(d2), k_sel, nullable(out_idx), nullable(out_d2), stream)
    if code != 0:
        raise RuntimeError("fused_query kernel launch failed: "
                           + lib.fused_query_error(code).decode())


def fused_range(series, norms_sq, words, residuals, q, q_panels, q_residuals,
                eps, *, levels, alphabet: int, n: int, block_q: int = 32,
                block_b: int = 1024):
    """One fused range pass: ``(answers (Q, B) bool, d2 (Q, B) float32)``
    with +inf off the answers.

    ``series`` (B, n) f32, ``norms_sq`` (B,) f32 (‖u‖²), per level
    ``words`` (B, N) int32 in [0, alphabet) and ``residuals`` (B,) f32;
    ``q`` (Q, n) f32, per level ``q_panels`` (Q, alphabet, N) f32
    (``ops.query_panels``) and ``q_residuals`` (Q,) f32; ``eps`` (Q,)
    f32.  All contiguous, on one device.  ``block_q`` (16 or 32) and
    ``block_b`` (a multiple of 64) shape the kernel's tiles only: the
    result does not depend on them.
    """
    B, Q, dev = _check_inputs(series, norms_sq, words, residuals, q,
                              q_panels, q_residuals, eps, levels, alphabet, n)
    _check_tiles(block_q, block_b)
    if dev.type == "cpu":
        return ref.fused_range_ref(series, norms_sq, words, residuals, q,
                                   q_panels, q_residuals, eps, levels, n)
    ans = torch.empty((Q, B), dtype=torch.bool, device=dev)
    d2 = torch.empty((Q, B), dtype=torch.float32, device=dev)
    _launch(False, series, norms_sq, words, residuals, q, q_panels,
            q_residuals, eps, levels, alphabet, n, block_q, block_b,
            ans=ans, d2=d2)
    with _count_lock:
        fused_range.launches += 1
    return ans, d2


def fused_topk(series, norms_sq, words, residuals, q, q_panels, q_residuals,
               eps, *, levels, alphabet: int, n: int, k: int,
               block_q: int = 32, block_b: int = 1024):
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
                              q_panels, q_residuals, eps, levels, alphabet, n)
    _check_tiles(block_q, block_b)
    k = int(k)
    if not 1 <= k <= min(block_b, KSEL_MAX):
        raise ValueError(f"k={k} must be in [1, min(block_b={block_b}, "
                         f"{KSEL_MAX})]")
    if dev.type == "cpu":
        return ref.fused_topk_ref(series, norms_sq, words, residuals, q,
                                  q_panels, q_residuals, eps, levels, n, k,
                                  block_b)
    nb = -(-B // block_b)
    out_idx = torch.empty((Q, nb * k), dtype=torch.int32, device=dev)
    out_d2 = torch.empty((Q, nb * k), dtype=torch.float32, device=dev)
    _launch(True, series, norms_sq, words, residuals, q, q_panels,
            q_residuals, eps, levels, alphabet, n, block_q, block_b,
            k_sel=k, out_idx=out_idx, out_d2=out_d2)
    with _count_lock:
        fused_topk.launches += 1
    return out_idx, out_d2


fused_range.launches = 0
fused_topk.launches = 0


def reset_launch_counts() -> None:
    """Set both launch counts to 0."""
    with _count_lock:
        fused_range.launches = 0
        fused_topk.launches = 0


def smem_bytes_of_kernel(topk: bool, n: int, levels, alphabet: int,
                         block_q: int, Q: int = 0, k_sel: int = 0) -> int:
    """The kernel's own count of its shared memory (needs the built
    library); ``ops.fused_smem_bytes`` must agree with it."""
    L = len(levels)
    Ns = (ctypes.c_int * L)(*[int(N) for N in levels])
    return int(_lib().fused_query_smem_bytes(int(topk), n, L, Ns, alphabet,
                                             block_q, Q, k_sel))
