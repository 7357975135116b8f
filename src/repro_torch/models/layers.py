"""Shared layer library: norms, RoPE, attention (GQA / qk-norm / sliding
window / cross), SwiGLU and GELU MLPs.

Counterpart of ``repro/models/layers.py``: plain tensor functions over a
parameter container indexed like the reference's pytree (``p["wq"]``).
Attention keeps the reference's online-softmax loop over KV chunks (and
Q chunks), with the same masks, the same −1e30 fill and f32 statistics,
so the CPU tests hold it to the reference; it is not
``scaled_dot_product_attention``.  No TPU kernel lies under this module:
the reference's einsums are XLA products, and here ``torch.einsum``.

A reference einsum with ``preferred_element_type=f32`` becomes
:func:`einsum_f32`: the operands are cast to f32 (a product of two bf16
values is exact in f32) and the sum stays in f32.  A product with a
weight is :func:`matmul`, which promotes mixed operands as JAX does (an
f32 activation times a bf16 weight multiplies in f32).  The activations
are written out op by op as ``jax.nn`` writes them, so bf16 is rounded at
the reference's points: :func:`silu` is ``x * logistic(x)`` with
XLA's expansion of logistic, and :func:`gelu_tanh` the tanh formula with
its constants in the input dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

F32 = torch.float32


# ---------------------------------------------------------------------------
# Parameters: specs and the container the blocks read
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter's shape, dtype and initial values: ``std`` times a
    standard normal draw, or ``fill(shape)`` (ones, zeros, a ramp)."""
    shape: tuple
    dtype: torch.dtype
    std: float = 1.0
    fill: Callable | None = None


def ones(shape):
    return torch.ones(shape, dtype=F32)


def zeros(shape):
    return torch.zeros(shape, dtype=F32)


class Params(nn.Module):
    """A parameter tree keyed like the reference's pytree: ``p["attn"]
    ["wq"]`` reads child ``attn``'s parameter ``wq``."""

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key):
        return key in self._parameters or key in self._modules


def materialize(spec: dict, device, generator=None) -> Params:
    """A :class:`Params` tree from a spec of :class:`Leaf`s.  On the
    ``meta`` device nothing is allocated or drawn; else normal leaves draw
    from ``generator`` (on ``device``) in f32 and are cast to their dtype —
    the reference's distributions and scales, not its bits."""
    out = Params()
    for key, leaf in spec.items():
        if isinstance(leaf, dict):
            out.add_module(key, materialize(leaf, device, generator))
            continue
        t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
        if t.device.type != "meta":
            with torch.no_grad():
                if leaf.fill is not None:
                    t.copy_(leaf.fill(leaf.shape))
                else:
                    t.copy_(torch.randn(leaf.shape, generator=generator,
                                        dtype=F32, device=device)
                            * leaf.std)
        out.register_parameter(key, nn.Parameter(t, requires_grad=False))
    return out


def matmul(x, w):
    """``x @ w`` with JAX's promotion: operands of two float dtypes are
    both cast to the wider one (``torch.matmul`` refuses mixed dtypes)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def einsum_f32(spec: str, *operands):
    """``jnp.einsum(..., preferred_element_type=f32)``: f32 accumulation
    of the operands as given (bf16 operands are widened exactly)."""
    return torch.einsum(spec, *(o.to(F32) for o in operands))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rms_norm(d: int) -> dict:
    return {"scale": Leaf((d,), F32, fill=ones)}


def rms_norm(x, scale, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.to(F32)).to(dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split rotation, not interleaved)
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=F32,
                                         device=device) / d_head))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (Dh/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(F32) * freqs              # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _attn_chunk(q, k, v, mask, scale):
    """One (Q-chunk, KV-chunk) tile: returns (out_unnorm, max, sum)."""
    s = einsum_f32("bqhd,bkhd->bhqk", q, k) * scale
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.amax(s, dim=-1, keepdim=True)                      # (B,H,Q,1)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = einsum_f32("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, m[..., 0], l[..., 0]                               # (B,H,Q)


def _repeat_kv(k, v, n_heads: int):
    """GQA: head h reads kv head h // (H / K) — ``jnp.repeat`` on the head
    axis, i.e. ``repeat_interleave`` (``Tensor.repeat`` would tile)."""
    K = k.shape[2]
    if K == n_heads:
        return k, v
    rep = n_heads // K
    return (torch.repeat_interleave(k, rep, dim=2),
            torch.repeat_interleave(v, rep, dim=2))


def _positions(pos, B: int, S: int):
    if pos.ndim == 1:
        pos = pos[None, :].expand(B, S)
    return pos


def _mask(qp, kp, causal: bool, sliding_window):
    B = qp.shape[0]
    m = torch.ones((B, 1, qp.shape[1], kp.shape[1]), dtype=torch.bool,
                   device=qp.device)
    if causal:
        m = m & (kp[:, None, None, :] <= qp[:, None, :, None])
    if sliding_window is not None:
        m = m & (kp[:, None, None, :] > (qp[:, None, :, None]
                                         - sliding_window))
    return m


def _chunk_size(chunk: int, n: int) -> int:
    """Halve until the chunk divides the length; below 128 (whisper's 1500
    frames, the VLM's 1601 patches) take the whole length in one chunk."""
    chunk = min(chunk, n)
    while n % chunk != 0:
        chunk //= 2
    return n if chunk < 128 else chunk


def flash_attention(q, k, v, *, causal: bool, q_positions, kv_positions,
                    sliding_window: int | None = None,
                    kv_chunk: int = 1024, q_chunk: int = 4096,
                    causal_skip: bool = False):
    """Online-softmax attention.  q: (B, Sq, H, Dh); k/v: (B, Sk, K, Dh)
    with K | H.  Positions drive the causal / sliding-window mask."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    scale = 1.0 / math.sqrt(Dh)
    q_positions = _positions(q_positions, B, Sq)
    kv_positions = _positions(kv_positions, B, Sk)
    kv_chunk = _chunk_size(kv_chunk, Sk)
    q_chunk = _chunk_size(q_chunk, Sq)
    n_kv = Sk // kv_chunk
    n_q = Sq // q_chunk

    def q_block(qi, n_kv_visible):
        qs = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qb, qp = q[:, qs], q_positions[:, qs]
        o_acc = torch.zeros((B, q_chunk, H, Dh), dtype=F32, device=q.device)
        m_acc = torch.full((B, H, q_chunk), -math.inf, dtype=F32,
                           device=q.device)
        l_acc = torch.zeros((B, H, q_chunk), dtype=F32, device=q.device)
        for ki in range(n_kv_visible):
            ks = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            o, m, l = _attn_chunk(qb, k[:, ks], v[:, ks],
                                  _mask(qp, kv_positions[:, ks], causal,
                                        sliding_window), scale)
            m_new = torch.maximum(m_acc, m)
            c_old = torch.exp(m_acc - m_new)
            c_new = torch.exp(m - m_new)
            o_acc = o_acc * c_old.transpose(1, 2)[..., None] \
                + o * c_new.transpose(1, 2)[..., None]
            l_acc = l_acc * c_old + l * c_new
        o = o_acc / torch.clamp(l_acc, min=1e-30).transpose(1, 2)[..., None]
        return o.to(q.dtype)

    # Causal block skipping: with contiguous ascending positions, q block
    # i only sees kv chunks 0..ceil((i+1)·qc / kc).
    skip = causal and causal_skip and sliding_window is None and n_q <= 32
    outs = [q_block(qi, min(n_kv, -(-((qi + 1) * q_chunk) // kv_chunk))
                    if skip and n_q > 1 else n_kv)
            for qi in range(n_q)]
    return outs[0] if n_q == 1 else torch.cat(outs, dim=1)


def naive_attention(q, k, v, *, causal, q_positions, kv_positions,
                    sliding_window=None):
    """Reference attention (materialised scores) — the oracle for tests
    and the decode path's cross-attention."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    q_positions = _positions(q_positions, B, Sq)
    kv_positions = _positions(kv_positions, B, Sk)
    s = einsum_f32("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    mask = _mask(q_positions, kv_positions, causal, sliding_window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return einsum_f32("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block
# ---------------------------------------------------------------------------


def init_attention(d_model, n_heads, n_kv, d_head, qk_norm=False,
                   dtype=torch.bfloat16) -> dict:
    sd = 1.0 / math.sqrt(d_model)
    p = {"wq": Leaf((d_model, n_heads * d_head), dtype, sd),
         "wk": Leaf((d_model, n_kv * d_head), dtype, sd),
         "wv": Leaf((d_model, n_kv * d_head), dtype, sd),
         "wo": Leaf((n_heads * d_head, d_model), dtype,
                    1.0 / math.sqrt(n_heads * d_head))}
    if qk_norm:
        p["q_norm"] = Leaf((d_head,), F32, fill=ones)
        p["k_norm"] = Leaf((d_head,), F32, fill=ones)
    return p


def attention_qkv(p, x, n_heads, n_kv, d_head, positions, rope_theta,
                  qk_norm=False):
    """Project + RoPE; returns q (B,S,H,Dh), k/v (B,S,K,Dh)."""
    B, S, _ = x.shape
    q = matmul(x, p["wq"]).reshape(B, S, n_heads, d_head)
    k = matmul(x, p["wk"]).reshape(B, S, n_kv, d_head)
    v = matmul(x, p["wv"]).reshape(B, S, n_kv, d_head)
    if qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope_theta:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attention_out(p, o):
    B, S, H, Dh = o.shape
    return matmul(o.reshape(B, S, H * Dh), p["wo"])


# ---------------------------------------------------------------------------
# MLPs: SwiGLU, and the classic GELU pair of the whisper-style enc-dec
# ---------------------------------------------------------------------------


def init_mlp(d_model, d_ff, dtype=torch.bfloat16) -> dict:
    return {"w_gate": Leaf((d_model, d_ff), dtype, 1.0 / math.sqrt(d_model)),
            "w_up": Leaf((d_model, d_ff), dtype, 1.0 / math.sqrt(d_model)),
            "w_down": Leaf((d_ff, d_model), dtype, 1.0 / math.sqrt(d_ff))}


def init_mlp_gelu(d_model, d_ff, dtype=torch.bfloat16) -> dict:
    return {"w_in": Leaf((d_model, d_ff), dtype, 1.0 / math.sqrt(d_model)),
            "w_out": Leaf((d_ff, d_model), dtype, 1.0 / math.sqrt(d_ff))}


class _Silu(torch.autograd.Function):
    """``jax.nn.silu``, ``x * logistic(x)``, as XLA compiles it: logistic
    expands to ``1 / (1 + exp(-x))`` in x's dtype, each op rounded.  The
    backward is JAX's transposed JVP, op by op in x's dtype:
    ``g·s + (g·x)·(s·(1 − s))`` (autograd through the expansion would
    round a reciprocal's derivative instead)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


class _GeluTanh(torch.autograd.Function):
    """``jax.nn.gelu(approximate=True)`` op by op; its constants are in
    x's dtype (JAX casts them), and ``x ** 3`` is two products.  The
    backward is JAX's, each op rounded in x's dtype: tanh's derivative
    ``w + w·t`` with ``w = g·(1 − t)``, ``x ** 3``'s ``g·(3·(x·x))``, and
    x's three cotangents summed in JAX's order."""

    @staticmethod
    def forward(ctx, x):
        def c(v):
            return torch.tensor(v, dtype=x.dtype, device=x.device)
        inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
        t = torch.tanh(inner)
        cdf = c(0.5) * (c(1.0) + t)
        ctx.save_for_backward(x, t, cdf)
        return x * cdf

    @staticmethod
    def backward(ctx, g):
        x, t, cdf = ctx.saved_tensors

        def c(v):
            return torch.tensor(v, dtype=x.dtype, device=x.device)
        w = (g * x * c(0.5)) * (1 - t)
        ct_s = (w + w * t) * c(math.sqrt(2 / math.pi))
        ct_cube = (ct_s * c(0.044715)) * (c(3.0) * (x * x))
        return (g * cdf + ct_s) + ct_cube


def silu(x):
    return _Silu.apply(x)


def gelu_tanh(x):
    return _GeluTanh.apply(x)


def mlp(p, x):
    return matmul(silu(matmul(x, p["w_gate"])) * matmul(x, p["w_up"]),
                  p["w_down"])


def mlp_gelu(p, x):
    return matmul(gelu_tanh(matmul(x, p["w_in"])), p["w_out"])
