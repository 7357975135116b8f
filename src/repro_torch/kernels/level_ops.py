"""Wrappers of the per-level kernels (``csrc/level_ops.cu``).

Counterpart of the per-kernel wrappers of ``repro/kernels/ops.py``
(``paa``, ``linfit_residual_sq``, ``mindist_sq``, ``sqdist``,
``prune_level``, ``query_table``) and of the Pallas kernels they reach:
``paa.py::paa_pallas``, ``linfit.py::linfit_residual_sq_pallas``,
``mindist.py::mindist_sq_pallas``, ``sqdist.py::sqdist_pallas`` and
``fused_prune.py::fused_prune_level_pallas``.  They are the paper's
algorithm one query and one level at a time (``core/search.py`` is its
op-counted host form) and the offline phase's columns; the serving
engines use the fused kernels instead, as the reference's do.

Each wrapper checks its inputs (type, shape, device, contiguity) and
raises on a mismatch — nothing is copied or converted — then

  * on CUDA tensors launches the kernel on the current stream and adds
    one to its launch count (``<wrapper>.launches``, for every wrapper in
    :data:`KERNELS`) — or raises; there is no fallback;
  * on CPU tensors computes the same function with its plain PyTorch
    version in ``ref.py`` (no launch is counted).

Nothing is padded: the kernels mask ragged B themselves, so the
reference's ``block_b`` is gone.  An empty batch (B = 0) needs no launch
and returns an empty result on either device.

``mindist_sq`` and ``prune_level`` take the query word on the host (a
numpy array or sequence; a CUDA tensor is read back first).  On the card
each makes one launch and allocates only its output: the kernel reads
the (α, α) MINDIST table cached per device (``ops.
mindist_table_cached``) through the word's offsets ``q_i·α``
(:func:`query_offsets`), which travel in the launch's parameters — no
per-query panel, no host-to-device copy.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import build, ref
from .ops import mindist_table_cached

_FLOATS = {torch.float32: 0, torch.bfloat16: 1}
_PAA, _LINFIT, _SQDIST, _WORDS = 0, 1, 2, 3
#: The longest query word the word kernels take (csrc ``WORD_N_MAX``: its
#: offsets fill the launch's parameters).
WORD_N_MAX = 16000

_count_lock = threading.Lock()


def _lib():
    lib = build.load("level_ops")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.level_segment_launch.argtypes = [ci, ci, vp, ci, ci, ci, vp, ci,
                                             vp, vp]
        lib.level_segment_launch.restype = ci
        lib.level_word_launch.argtypes = [ci, vp, ci, ci, ci, vp, vp, cf, vp,
                                          vp, cf, cf, cf, vp, vp]
        lib.level_word_launch.restype = ci
        lib.level_ops_tile.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        lib.level_ops_tile.restype = ci
        lib.level_ops_error.argtypes = [ci]
        lib.level_ops_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name, t, dtypes, ndim, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {tuple(dtypes)}, "
                        f"got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimension(s), "
                         f"got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _segments(x, n_segments: int) -> int:
    n = x.shape[-1]
    N = int(n_segments)
    if not 1 <= N <= n or n % N:
        raise ValueError(f"n_segments={N} must divide n={n}")
    return N


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.level_ops_error(code).decode())


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _segment(body, x, N, q, out, what):
    lib = _lib()
    B, n = x.shape
    with torch.cuda.device(x.device):
        code = lib.level_segment_launch(
            body, _FLOATS[x.dtype], x.data_ptr(), B, n, N,
            None if q is None else q.data_ptr(),
            0 if q is None else _FLOATS[q.dtype], out.data_ptr(),
            _stream(x.device))
    _raise_on(lib, code, what)


def paa(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(B, n) float32 or bfloat16 -> (B, N) float32 segment means (kernel
    9).  Bit for bit the engine's ``core/paa.paa`` of ``x`` in float32."""
    _check("x", x, _FLOATS, 2)
    N = _segments(x, n_segments)
    if x.device.type == "cpu":
        return ref.paa_ref(x, N)
    out = torch.empty((x.shape[0], N), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _segment(_PAA, x, N, None, out, "paa")
        _count(paa)
    return out


def linfit_residual_sq(x: torch.Tensor, n_segments: int) -> torch.Tensor:
    """(B, n) float32 or bfloat16 -> (B,) float32 squared residuals to
    the optimal per-segment line (kernel 8).  Bit for bit the engine's
    ``core/polyfit.linfit_residual_sq`` of ``x`` in float32."""
    _check("x", x, _FLOATS, 2)
    N = _segments(x, n_segments)
    if x.device.type == "cpu":
        return ref.linfit_residual_sq_ref(x, N)
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _segment(_LINFIT, x, N, None, out, "linfit_residual_sq")
        _count(linfit_residual_sq)
    return out


def sqdist(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, n) × (n,) -> (B,) float32 squared Euclidean distances (kernel
    11); ``x`` and ``q`` float32 or bfloat16, upcast in the kernel."""
    _check("x", x, _FLOATS, 2)
    _check("q", q, _FLOATS, 1, x.device)
    if q.shape[0] != x.shape[1]:
        raise ValueError(f"q must have shape ({x.shape[1]},), "
                         f"got {tuple(q.shape)}")
    if x.device.type == "cpu":
        return ref.sqdist_ref(x, q)
    out = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
    if x.shape[0]:
        _segment(_SQDIST, x, 1, q, out, "sqdist")
        _count(sqdist)
    return out


def _word_array(qword, alphabet: int) -> np.ndarray:
    """The (N,) query word on the host, its symbols checked."""
    if isinstance(qword, torch.Tensor):
        qword = qword.cpu().numpy()
    qword = np.asarray(qword)
    if qword.ndim != 1:
        raise ValueError(f"qword must be (N,), got {qword.shape}")
    if qword.size and (qword.min() < 0 or qword.max() >= alphabet):
        raise ValueError(f"qword leaves [0, {alphabet})")
    return qword


def query_table(qword, alphabet: int, device=None) -> torch.Tensor:
    """(N,) query word -> (α, N) float32 MINDIST panel ``tq[a, i] =
    tab[a, q_i]`` on ``device`` (default: the word's, or the CPU): what the
    plain versions take."""
    if isinstance(qword, torch.Tensor) and device is None:
        device = qword.device
    qword = _word_array(qword, alphabet)
    tab = mindist_table_cached(int(alphabet), str(torch.device(device or
                                                               "cpu")))
    idx = torch.as_tensor(qword.astype(np.int64), device=tab.device)
    return tab[:, idx].contiguous()


def query_offsets(qword, alphabet: int) -> np.ndarray:
    """(N,) query word -> (N,) uint16 offsets ``q_i·α``: the cell
    ``tab[w, q_i]`` of the panel is ``tab.T.flatten()[q_i·α + w]``, which
    the word kernels read from the table they stage transposed."""
    return (_word_array(qword, alphabet).astype(np.int64)
            * int(alphabet)).astype(np.uint16)


def _query(words, qword, alphabet: int) -> np.ndarray:
    """Check ``words`` and the query word; return its offsets."""
    _check("words", words, (torch.int32,), 2)
    if not 2 <= int(alphabet) <= 20:
        raise ValueError(f"alphabet must be in [2, 20], got {alphabet}")
    qoff = query_offsets(qword, alphabet)
    if qoff.shape[0] != words.shape[1]:
        raise ValueError(f"qword has {qoff.shape[0]} symbols, words "
                         f"{words.shape[1]}")
    if words.device.type == "cuda" and qoff.shape[0] > WORD_N_MAX:
        raise ValueError(f"words of {qoff.shape[0]} symbols: the kernels "
                         f"take at most {WORD_N_MAX}")
    return qoff


def _word(prune, words, tab, qoff, n, alphabet, alive, res, qres, eps, out,
          what):
    """Launch kernel 10 (``prune`` 0) or 12 on the current stream."""
    lib = _lib()
    B, N = words.shape
    with torch.cuda.device(words.device):
        code = lib.level_word_launch(
            prune, words.data_ptr(), B, N, int(alphabet), tab.data_ptr(),
            qoff.ctypes.data, float(n / N),
            None if alive is None else alive.data_ptr(),
            None if res is None else res.data_ptr(), qres, eps,
            ref.eps_sq_f32(eps), out.data_ptr(), _stream(words.device))
    _raise_on(lib, code, what)


def mindist_sq(words: torch.Tensor, qword, n: int,
               alphabet: int) -> torch.Tensor:
    """(B, N) int32 words in [0, alphabet) × one (N,) query word -> (B,)
    float32 squared MINDIST ``(n/N)·Σᵢ tab[wᵢ, qᵢ]²`` (kernel 10)."""
    qoff = _query(words, qword, alphabet)
    if words.device.type == "cpu":
        return ref.mindist_sq_level_ref(words, query_table(qword, alphabet),
                                        n)
    out = torch.empty((words.shape[0],), dtype=torch.float32,
                      device=words.device)
    if words.shape[0]:
        _word(0, words, mindist_table_cached(int(alphabet),
                                             str(words.device)),
              qoff, n, alphabet, None, None, 0.0, 0.0, out, "mindist_sq")
        _count(mindist_sq)
    return out


def prune_level(alive: torch.Tensor, residuals: torch.Tensor,
                words: torch.Tensor, qword, qres: float, eps: float, n: int,
                alphabet: int) -> torch.Tensor:
    """One cascade level for one query (kernel 12): the new (B,) bool
    alive mask ``alive ∧ |res − qres| ≤ ε ∧ MINDIST² ≤ ε·ε``.  ``alive``
    (B,) bool, ``residuals`` (B,) float32, ``words`` (B, N) int32;
    ``qres`` and ``eps`` are rounded to float32 and ε·ε is taken in
    float32, as the reference does."""
    _check("words", words, (torch.int32,), 2)
    dev, B = words.device, words.shape[0]
    _check("alive", alive, (torch.bool,), 1, dev)
    _check("residuals", residuals, (torch.float32,), 1, dev)
    if alive.shape[0] != B or residuals.shape[0] != B:
        raise ValueError(f"alive and residuals must have {B} rows")
    qoff = _query(words, qword, alphabet)
    qres, eps = float(np.float32(qres)), float(np.float32(eps))
    if dev.type == "cpu":
        return ref.prune_level_ref(alive, residuals, words,
                                   query_table(qword, alphabet), qres, eps, n)
    out = torch.empty((B,), dtype=torch.bool, device=dev)
    if B:
        _word(1, words, mindist_table_cached(int(alphabet), str(dev)), qoff,
              n, alphabet, alive, residuals, qres, eps, out, "prune_level")
        _count(prune_level)
    return out


def tile_of(kind: str, n: int, N: int) -> tuple:
    """(rows per thread block, shared-memory bytes) of a launch over
    aligned inputs (needs the built library): ``kind`` is ``"paa"``,
    ``"linfit"``, ``"sqdist"`` over rows of length ``n`` with ``N``
    segments, or ``"words"`` over N-symbol words (its static 20 × 20
    table included)."""
    code = {"paa": _PAA, "linfit": _LINFIT, "sqdist": _SQDIST,
            "words": _WORDS}[kind]
    smem = ctypes.c_int(0)
    rows = _lib().level_ops_tile(code, n, N, ctypes.byref(smem))
    return int(rows), int(smem.value)


KERNELS = (linfit_residual_sq, paa, mindist_sq, sqdist, prune_level)
for _kernel in KERNELS:
    _kernel.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    with _count_lock:
        for kernel in KERNELS:
            kernel.launches = 0
