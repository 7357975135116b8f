"""AdamW with optional int8 block-quantised moments.

Counterpart of ``repro/training/optimizer.py``, in plain torch ops (the
reference's is plain JAX: no Pallas kernel lies on it).  The int8 mode
stores both Adam moments as int8 with one f32 scale per block of 256
elements tiling the last axis (the codes keep the parameter's shape);
``v`` is kept in the square-root domain.  Quantisation error feeds back
through the next moment update (the quantised value is the state).

Parameters, gradients and moments are dicts keyed by name, and the
caller names the parameters that take weight decay.  The reference
decays every leaf of rank ≥ 2; the train step passes
``models.transformer.decayed_names``, since the model's per-layer
parameters are rows of the reference's stacked leaves.  The state is keyed as the
reference's, ``{"step", "moments": {name: {"m", "v"} | {"m_q", "m_s",
"v_q", "v_s"}}}``; ``checkpoint.layout`` writes it in the reference's
stacked layout.

``apply_updates`` updates in place: a parameter's tensor is overwritten
with its new value (a bf16 parameter as ``(p.f32 − lr·upd).to(bf16)``,
no f32 master copy, as the reference), and each moment is replaced leaf
by leaf, so that a step never holds a second copy of the weights.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

F32 = torch.float32
BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    int8_moments: bool = False
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """Linear warmup -> cosine decay to ``min_lr_frac``·lr, in f32."""
    step = torch.as_tensor(step).to(F32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


# --- int8 blockwise codec -------------------------------------------------


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def quantize_i8(x: torch.Tensor):
    """f32 tensor -> (int8 codes shaped like x, f32 block scales
    (..., n_blocks)).  Blocks tile the last axis only."""
    *lead, n = x.shape
    npad = _pad_len(n)
    xp = torch.nn.functional.pad(x, (0, npad - n))
    blocks = xp.reshape(*lead, npad // BLOCK, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    codes = codes.reshape(*lead, npad)[..., :n]
    return codes, scale[..., 0]


def dequantize_i8(codes: torch.Tensor, scale: torch.Tensor, shape):
    *lead, n = shape
    npad = _pad_len(n)
    cp = torch.nn.functional.pad(codes, (0, npad - n))
    blocks = cp.reshape(*lead, npad // BLOCK, BLOCK).to(F32)
    return (blocks * scale[..., None]).reshape(*lead, npad)[..., :n]


# --- state ------------------------------------------------------------------


def _int8_leaf(cfg: AdamWConfig, p) -> bool:
    return cfg.int8_moments and p.ndim > 0 and p.shape[-1] >= BLOCK


def init_state(cfg: AdamWConfig, params: dict) -> dict:
    """Zero moments beside each parameter, on its device; ``step`` a 0-d
    int32 tensor on the parameters' device."""
    moments = {}
    device = None
    for name, p in params.items():
        device = p.device
        if _int8_leaf(cfg, p):
            n_blocks = _pad_len(p.shape[-1]) // BLOCK
            scales = (*p.shape[:-1], n_blocks)
            moments[name] = {
                "m_q": torch.zeros(p.shape, dtype=torch.int8, device=device),
                "m_s": torch.zeros(scales, dtype=F32, device=device),
                "v_q": torch.zeros(p.shape, dtype=torch.int8, device=device),
                "v_s": torch.zeros(scales, dtype=F32, device=device)}
        else:
            moments[name] = {"m": torch.zeros(p.shape, dtype=F32,
                                              device=device),
                             "v": torch.zeros(p.shape, dtype=F32,
                                              device=device)}
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "moments": moments}


def _leaf_update(cfg, lr, bc1, bc2, p, g, st, decay: bool):
    g = g.to(F32)
    if "m_q" in st:
        m = dequantize_i8(st["m_q"], st["m_s"], p.shape)
        # v in the square-root domain: int8 absmax on raw v collapses the
        # small-magnitude tail of a block; dequantisation squares it back.
        sv = dequantize_i8(st["v_q"], st["v_s"], p.shape)
        v = sv * sv
    else:
        m, v = st["m"], st["v"]
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mh = m / bc1
    vh = v / bc2
    upd = mh / (torch.sqrt(vh) + cfg.eps)
    if decay:
        upd = upd + cfg.weight_decay * p.to(F32)
    new_p = (p.to(F32) - lr * upd).to(p.dtype)
    if "m_q" in st:
        mq, ms = quantize_i8(m)
        vq, vs = quantize_i8(torch.sqrt(v))
        return new_p, {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
    return new_p, {"m": m, "v": v}


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                  decay: set):
    """One AdamW step in place; returns ``(params, state)``.  ``decay``:
    the names that take weight decay."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    t = step.to(F32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=t.device), t)
    moments = state["moments"]
    for name, p in params.items():
        new_p, moments[name] = _leaf_update(cfg, lr, bc1, bc2, p, grads[name],
                                            moments[name], name in decay)
        p.copy_(new_p)
    state["step"] = step
    return params, state


def global_norm(grads: dict):
    return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                          for g in grads.values()))


def clip_by_global_norm(grads: dict, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.to(F32) * scale).to(g.dtype) for k, g in grads.items()}, norm
