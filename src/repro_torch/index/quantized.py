"""Quantized resident tier of the FAST_SAX cascade (host side, numpy).

Counterpart of ``repro/index/quantized.py``.  The resident tier keeps

  * the SAX words, narrowed losslessly to int8 (every alphabet ≤ 126),
  * each level's residual column as int8 codes with an affine scale and
    zero per block of ``RESID_BLOCK`` rows, or as bf16,
  * the series as int8 codes with a per-row scale and zero, or as bf16,
  * per-block (residuals) and per-row (series, L2) dequantization errors,
    and the squared norms of the dequantized rows,

while the full-precision series stays in host memory (the raw tier) and
is read only for the screen's survivors.  Every bound of the cascade is
widened by the stored error, so no true answer is screened out:

  * C9: |r̂(u) − r(q)| > ε + e_blk implies d(u, q) > ε;
  * C10 runs unwidened: the int8 words are the words;
  * series screen: d(û, q) > ε + e_u implies d(u, q) > ε (triangle
    inequality, e_u = ‖u − û‖₂).

Storage conventions, shared with the CUDA kernels and their plain
versions (they must decode the same values):

  * the dequantizer is ``zero + scale · code``, in float32, multiply then
    add, each rounded;
  * int8 residual code 127 (``SENTINEL_CODE``) is reserved: it decodes to
    ``PAD_RESIDUAL`` whatever the scale; real codes lie in [−126, 126];
  * bf16 columns are uint16 bit patterns on the host.  They are encoded
    through ``torch`` (round to nearest even, through float32), which
    gives the same bits as the reference's ``ml_dtypes`` encoder;
  * every error is the realized worst case against the float64 source,
    rounded up one float32 ulp.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import representation as repr_registry
from ..core.representation import DEFAULT_STACK

#: Rows per residual scale block; divides every kernel ``block_b``.
RESID_BLOCK = 128

#: Padding sentinel residual (the engine's and the kernels' PAD_RESIDUAL).
PAD_RESIDUAL = 1e30

#: Reserved int8 code of the residual padding sentinel.
SENTINEL_CODE = 127

MODES = ("none", "bf16", "int8")


class QuantizationError(ValueError):
    """A quantization request or artifact is invalid."""


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise QuantizationError(
            f"quantization must be one of {MODES}, got {mode!r}")
    return mode


def _round_up_abs(err: np.ndarray) -> np.ndarray:
    """One-ulp upward rounding of a nonnegative f32 error bound, so the
    stored f32 value can never be below the true maximum."""
    err32 = np.asarray(err, np.float32)
    return np.where(err32 > 0, np.nextafter(err32, np.float32(np.inf)),
                    err32).astype(np.float32)


def _as_blocks(x: np.ndarray, block: int) -> Tuple[np.ndarray, int]:
    """(B,) or (B, n) -> (nb, block[, n]) zero-padded copy."""
    B = x.shape[0]
    nb = -(-B // block)
    pad = nb * block - B
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x.reshape((nb, block) + x.shape[1:]), B


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def bf16_encode(x: np.ndarray) -> np.ndarray:
    """float -> bf16 (round to nearest even) as uint16 bit patterns."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bf16_decode(u16: np.ndarray) -> np.ndarray:
    """uint16 bit patterns -> float32 values (exact)."""
    bits = np.asarray(u16, np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


# ---------------------------------------------------------------------------
# int8 affine, per block
# ---------------------------------------------------------------------------

def int8_encode(x: np.ndarray, block: int, code_max: int):
    """Per-block affine int8 quantization.

    Each block of ``block`` leading rows gets ``zero = (hi+lo)/2`` and
    ``scale = (hi-lo)/(2·code_max)`` (1 for a block of span 0), so codes
    land in [−code_max, code_max].  Returns ``(codes int8 like x, scale
    (nb,) f32, zero (nb,) f32)``.
    """
    x64 = np.asarray(x, np.float64)
    xb, B = _as_blocks(x64, block)
    flat = xb.reshape(xb.shape[0], -1)
    lo = flat.min(axis=1)
    hi = flat.max(axis=1)
    zero = ((hi + lo) / 2.0).astype(np.float32)
    span = np.maximum(hi - lo, 0.0)
    scale = np.where(span > 0, span / (2.0 * code_max), 1.0).astype(np.float32)
    q = np.rint((flat - zero[:, None].astype(np.float64))
                / scale[:, None].astype(np.float64))
    codes = np.clip(q, -code_max, code_max).astype(np.int8)
    return codes.reshape((-1,) + x64.shape[1:])[:B], scale, zero


def int8_decode(codes: np.ndarray, scale: np.ndarray, zero: np.ndarray,
                block: int) -> np.ndarray:
    """Dequantize per-block affine int8 codes to float32 with the shared
    expression ``zero + scale · code``."""
    codes = np.asarray(codes)
    per_row = np.repeat(np.asarray(scale, np.float32), block)[:codes.shape[0]]
    per_zero = np.repeat(np.asarray(zero, np.float32), block)[:codes.shape[0]]
    if codes.ndim == 2:
        per_row = per_row[:, None]
        per_zero = per_zero[:, None]
    return (per_zero + per_row * codes.astype(np.float32)).astype(np.float32)


def _block_abs_err(x64: np.ndarray, deq32: np.ndarray,
                   block: int) -> np.ndarray:
    """Realized per-block max |dequant − x|, rounded up one ulp (f32)."""
    diff = np.abs(deq32.astype(np.float64) - x64)
    db, _ = _as_blocks(diff, block)
    return _round_up_abs(db.reshape(db.shape[0], -1).max(axis=1))


# ---------------------------------------------------------------------------
# Column quantizers
# ---------------------------------------------------------------------------

def quantize_residuals(residuals: np.ndarray, mode: str):
    """Quantize one level's (B,) residual column: ``(codes, scale|None,
    zero|None, err (nb,) f32)`` with ``nb = ⌈B / RESID_BLOCK⌉``.  int8
    codes stay below the reserved ``SENTINEL_CODE``."""
    x64 = np.asarray(residuals, np.float64)
    if mode == "bf16":
        codes = bf16_encode(x64)
        err = _block_abs_err(x64, bf16_decode(codes), RESID_BLOCK)
        return codes, None, None, err
    if mode == "int8":
        codes, scale, zero = int8_encode(x64, RESID_BLOCK,
                                         SENTINEL_CODE - 1)
        err = _block_abs_err(
            x64, int8_decode(codes, scale, zero, RESID_BLOCK), RESID_BLOCK)
        return codes, scale, zero, err
    raise QuantizationError(f"cannot quantize residuals with mode {mode!r}")


def quantize_series(series: np.ndarray, mode: str):
    """Quantize the (B, n) series, one scale block per row: ``(codes,
    scale|None, zero|None, err (B,) f32, norms (B,) f32)`` with
    ``err[b] = ‖u_b − û_b‖₂`` (rounded up) and ``norms`` the squared
    norms of the dequantized rows."""
    x64 = np.asarray(series, np.float64)
    if mode == "bf16":
        codes = bf16_encode(x64)
        deq = bf16_decode(codes)
        scale = zero = None
    elif mode == "int8":
        codes, scale, zero = int8_encode(x64, 1, SENTINEL_CODE)
        deq = int8_decode(codes, scale, zero, 1)
    else:
        raise QuantizationError(f"cannot quantize series with mode {mode!r}")
    err = _round_up_abs(np.sqrt(
        np.sum((deq.astype(np.float64) - x64) ** 2, axis=1)))
    norms = np.sum(deq.astype(np.float32) ** 2, axis=1, dtype=np.float32)
    return codes, scale, zero, err, norms


def narrow_words(words: np.ndarray) -> np.ndarray:
    """Losslessly narrow an int32 symbol column to int8 (alphabet ≤ 127)."""
    w = np.asarray(words)
    if w.size and (w.min() < 0 or w.max() > 126):
        raise QuantizationError(
            f"symbols out of int8 range: [{w.min()}, {w.max()}]")
    return w.astype(np.int8)


# ---------------------------------------------------------------------------
# Whole-index quantization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantizedLevel:
    """One quantized cascade level (host arrays)."""

    n_segments: int
    words: np.ndarray              # (B, N) int8, lossless
    residuals: np.ndarray          # (B,) int8 codes or uint16 bf16 bits
    scale: Optional[np.ndarray]    # (nb,) f32 (int8 only)
    zero: Optional[np.ndarray]     # (nb,) f32 (int8 only)
    err: np.ndarray                # (nb,) f32, per-block |r̂ − r| bound
    #: Extra word-kind stack columns {name: (B, N) int8}, narrowed
    #: losslessly like ``words``, so their bounds need no widening.
    extra: dict = dataclasses.field(default_factory=dict)

    def dequant_residuals(self) -> np.ndarray:
        if self.residuals.dtype == np.uint16:
            return bf16_decode(self.residuals)
        deq = int8_decode(self.residuals, self.scale, self.zero, RESID_BLOCK)
        return np.where(self.residuals == SENTINEL_CODE,
                        np.float32(PAD_RESIDUAL), deq).astype(np.float32)

    def row_err(self) -> np.ndarray:
        B = self.residuals.shape[0]
        return np.repeat(self.err, RESID_BLOCK)[:B]


@dataclasses.dataclass(frozen=True)
class QuantizedHostIndex:
    """The resident tier's columns on the host.  The raw full-precision
    series is not a member: ``engine.TieredIndex`` pairs the two."""

    mode: str                              # "bf16" | "int8"
    n: int                                 # samples per series
    alphabet: int
    series: np.ndarray                     # (B, n) int8 or uint16 bf16 bits
    series_scale: Optional[np.ndarray]     # (B,) f32 (int8 only)
    series_zero: Optional[np.ndarray]      # (B,) f32 (int8 only)
    series_err: np.ndarray                 # (B,) f32, ‖u − û‖₂ bound
    norms_sq: np.ndarray                   # (B,) f32, ‖û‖²
    levels: Tuple[QuantizedLevel, ...]
    stack: Tuple[str, ...] = DEFAULT_STACK

    @property
    def size(self) -> int:
        return self.series.shape[0]

    def dequant_series(self) -> np.ndarray:
        if self.series.dtype == np.uint16:
            return bf16_decode(self.series)
        return int8_decode(self.series, self.series_scale, self.series_zero,
                           1)

    def resident_bytes(self) -> int:
        """Bytes of one copy of the resident tier."""
        total = self.series.nbytes + self.series_err.nbytes + \
            self.norms_sq.nbytes
        if self.series_scale is not None:
            total += self.series_scale.nbytes + self.series_zero.nbytes
        for lv in self.levels:
            total += lv.words.nbytes + lv.residuals.nbytes + lv.err.nbytes
            if lv.scale is not None:
                total += lv.scale.nbytes + lv.zero.nbytes
            for col in lv.extra.values():
                total += col.nbytes
        return total


def full_precision_resident_bytes(size: int, n: int,
                                  levels: Sequence[int]) -> int:
    """Resident bytes of the same index in the full-precision layout:
    f32 series and norms, and per level int32 words and f32 residuals."""
    per_row = 4 * n + 4 + sum(4 * N + 4 for N in levels)
    return size * per_row


def quantize_host_index(index, mode: str) -> QuantizedHostIndex:
    """Quantize a ``core/fastsax.FastSAXIndex`` into the resident tier."""
    check_mode(mode)
    if mode == "none":
        raise QuantizationError("mode='none' has no quantized tier")
    if index.config.alphabet > 126:
        raise QuantizationError(
            f"alphabet {index.config.alphabet} exceeds int8 symbol range")
    stack = repr_registry.validate_stack(
        getattr(index.config, "stack", DEFAULT_STACK))
    for name in repr_registry.extra_names(stack):
        if repr_registry.get(name).kind != "word":
            raise QuantizationError(
                f"representation {name!r} is gap-kind: its float gap column "
                "has no lossless narrow form; quantize the paper stack or a "
                "word-kind extension instead")
    s_codes, s_scale, s_zero, s_err, norms = quantize_series(
        np.asarray(index.series, np.float64), mode)
    qlevels = []
    for lv in index.levels:
        r_codes, r_scale, r_zero, r_err = quantize_residuals(
            np.asarray(lv.residuals, np.float64), mode)
        qlevels.append(QuantizedLevel(
            n_segments=lv.n_segments, words=narrow_words(lv.words),
            residuals=r_codes, scale=r_scale, zero=r_zero, err=r_err,
            extra={name: narrow_words(col)
                   for name, col in getattr(lv, "extra", {}).items()}))
    return QuantizedHostIndex(
        mode=mode, n=index.series.shape[1], alphabet=index.config.alphabet,
        series=s_codes, series_scale=s_scale, series_zero=s_zero,
        series_err=s_err, norms_sq=norms, levels=tuple(qlevels),
        stack=stack)
