"""int8 gradient compression with error feedback, single-device half.

Counterpart of ``repro/training/compress.py``: ``compress_decompress``
(one error-feedback round trip of a gradient leaf through the int8 block
codec) and ``init_error_feedback``.  The compressed all-reduce over a
mesh axis (``compressed_psum_grads``, ``make_compressed_dp_grad_fn``)
comes with the device mesh (ROADMAP.md, queue 1, item 11c).
"""
from __future__ import annotations

import torch

from .optimizer import dequantize_i8, quantize_i8

F32 = torch.float32


def compress_decompress(g, err):
    """One error-feedback quantisation round trip (per leaf).  Returns
    (the quantised-then-dequantised gradient in g's dtype, the new
    residual in f32)."""
    g32 = g.to(F32) + err
    codes, scales = quantize_i8(g32)
    deq = dequantize_i8(codes, scales, g32.shape)
    return deq.to(g.dtype), g32 - deq


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}
