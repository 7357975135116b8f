"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) in PyTorch.

Counterpart of ``repro/models/ssm.py``.  Prefill runs the chunked dual
form: within a chunk a quadratic ("attention-like") product; across
chunks a sequential loop carries the (H, P, N) state.  Decode is the
O(1)-per-token recurrence.  The depthwise causal conv1d (k = 4) is an
explicit 4-tap shift-multiply.  Params follow the Mamba2 layout: fused
``in_proj`` producing [z, x, B, C, dt], ``A_log``/``D``/``dt_bias`` per
head, gated RMSNorm, ``out_proj``.  The reference computes all of this
in XLA (its inter-chunk step is a ``lax.scan``); no TPU kernel lies
under it.  bf16 is rounded at the reference's points, and its f32
promotions (dt, D, the decay) are written out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import F32, Leaf, einsum_f32, ones, rms_norm, zeros


def ssm_dims(d_model: int, head_dim: int = 64, expand: int = 2,
             state: int = 64, n_groups: int = 1):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * state
    return d_inner, n_heads, conv_dim


def init_mamba2(d_model, *, head_dim=64, expand=2, state=64, n_groups=1,
                d_conv=4, dtype=torch.bfloat16) -> dict:
    d_inner, n_heads, conv_dim = ssm_dims(d_model, head_dim, expand, state,
                                          n_groups)
    proj_out = 2 * d_inner + 2 * n_groups * state + n_heads
    return {
        "in_proj": Leaf((d_model, proj_out), dtype, 1.0 / math.sqrt(d_model)),
        "conv_w": Leaf((d_conv, conv_dim), dtype, 0.2),
        "conv_b": Leaf((conv_dim,), F32, fill=zeros),
        "A_log": Leaf((n_heads,), F32, fill=lambda s: torch.log(
            torch.linspace(1.0, 16.0, s[0], dtype=F32))),
        "D": Leaf((n_heads,), F32, fill=ones),
        "dt_bias": Leaf((n_heads,), F32, fill=zeros),
        "norm": Leaf((d_inner,), F32, fill=ones),
        "out_proj": Leaf((d_inner, d_model), dtype, 1.0 / math.sqrt(d_inner)),
    }


def _split_proj(zxbcdt, d_inner, n_groups, state, n_heads):
    gs = n_groups * state
    return torch.split(zxbcdt, [d_inner, d_inner, gs, gs, n_heads], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv, kernel k: x (B,S,C), w (k,C) — shift+mul."""
    k = w.shape[0]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S, :]
        out = out + xi.to(F32) * w[i].to(F32)
    return (out + b).to(x.dtype)


def ssd_chunked(xh, dt, A, Bc, Cc, chunk: int, initial_state=None):
    """SSD dual form.

    xh: (B,S,H,P) inputs; dt: (B,S,H) f32 post-softplus step sizes;
    A: (H,) negative decay rates; Bc/Cc: (B,S,G,N) with G | H.
    Returns y (B,S,H,P) f32 and the final state (B,H,P,N) f32.
    """
    b, s, h, p = xh.shape
    g, n = Bc.shape[2], Bc.shape[3]
    cs = min(chunk, s)
    while s % cs:
        cs //= 2
    nc = s // cs
    rep = h // g

    xc = xh.reshape(b, nc, cs, h, p)
    dtc = dt.reshape(b, nc, cs, h)
    Bcc = torch.repeat_interleave(Bc.reshape(b, nc, cs, g, n), rep, dim=3)
    Ccc = torch.repeat_interleave(Cc.reshape(b, nc, cs, g, n), rep, dim=3)

    a = dtc * A[None, None, None, :]                   # (b,nc,cs,h) ≤ 0
    a_cum = torch.cumsum(a, dim=2)                     # within-chunk
    a_tot = a_cum[:, :, -1, :]                         # (b,nc,h)

    # --- intra-chunk: y_ij = C_i·B_j (i ≥ j) with the decay between them
    scores = einsum_f32("bzihn,bzjhn->bzhij", Ccc, Bcc)
    a_h = a_cum.permute(0, 1, 3, 2)                    # (b,nc,h,cs)
    ii = torch.arange(cs, device=xh.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, None]
    # decay[b,z,h,i,j] = exp(a_cum_i − a_cum_j) for i ≥ j (≤ 1, stable);
    # masked pairs get exp(−inf) = 0.
    diff = a_h[..., :, None] - a_h[..., None, :]
    expo = torch.where(causal, diff, torch.full_like(diff, -math.inf))
    w = scores * torch.exp(expo)
    xdt = xc.to(F32) * dtc[..., None]                  # (b,nc,cs,h,p) f32
    y_intra = einsum_f32("bzhij,bzjhp->bzihp", w.to(xh.dtype), xdt)

    # --- chunk boundary states: S_z = Σ_j exp(a_tot − a_cum_j)·B_j⊗(dt_j x_j)
    decay_to_end = torch.exp(a_tot[:, :, None, :] - a_cum)   # (b,nc,cs,h)
    states = einsum_f32("bzjhn,bzjhp->bzhpn",
                        (Bcc.to(F32) * decay_to_end[..., None]).to(xh.dtype),
                        xdt)

    # --- inter-chunk recurrence (sequential over nc); the state BEFORE z
    carry = (torch.zeros((b, h, p, n), dtype=F32, device=xh.device)
             if initial_state is None else initial_state.to(F32))
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(a_tot[:, z])[:, :, None, None] \
            + states[:, z]
    prev_states = torch.stack(prev, dim=1)             # (b,nc,h,p,n)

    # --- inter-chunk contribution: y_i += C_i · prev_state · exp(a_cum_i)
    y_inter = einsum_f32("bzihn,bzhpn->bzihp", Ccc,
                         prev_states.to(Ccc.dtype))
    y_inter = y_inter * torch.exp(a_cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, carry


def mamba2_forward(p, x, *, head_dim=64, expand=2, state=64, n_groups=1,
                   chunk=256, return_cache=False):
    """Full Mamba2 block (prefill).  x: (B,S,d) -> (B,S,d).

    ``return_cache``: also return the decode cache {'ssm', 'conv'} (final
    state + conv tail) from the same pass."""
    b, s, d = x.shape
    d_inner, n_heads, conv_dim = ssm_dims(d, head_dim, expand, state, n_groups)
    zxbcdt = x @ p["in_proj"]
    z, xs, Bc, Cc, dt = _split_proj(zxbcdt, d_inner, n_groups, state, n_heads)
    xBC_pre = torch.cat([xs, Bc, Cc], dim=-1)
    xBC = _causal_conv(xBC_pre, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC.to(F32)).to(x.dtype)
    xs, Bc, Cc = torch.split(xBC, [d_inner, n_groups * state,
                                   n_groups * state], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, n_heads, head_dim)
    y, final = ssd_chunked(xh, dt, A,
                           Bc.reshape(b, s, n_groups, state),
                           Cc.reshape(b, s, n_groups, state), chunk)
    y = y + xh.to(F32) * p["D"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(x.dtype), p["norm"])
    out = y @ p["out_proj"]
    if return_cache:
        k = p["conv_w"].shape[0]
        return out, {"ssm": final,
                     "conv": xBC_pre[:, -(k - 1):, :].to(F32)}
    return out


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------


def mamba2_init_cache(batch, d_model, *, head_dim=64, expand=2, state=64,
                      n_groups=1, d_conv=4, dtype=F32, device=None):
    d_inner, n_heads, conv_dim = ssm_dims(d_model, head_dim, expand, state,
                                          n_groups)
    return {
        "ssm": torch.zeros((batch, n_heads, head_dim, state), dtype=dtype,
                           device=device),
        "conv": torch.zeros((batch, d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba2_decode_step(p, x, cache, *, head_dim=64, expand=2, state=64,
                       n_groups=1):
    """One-token step.  x: (B, 1, d); cache: {'ssm', 'conv'}.  Returns
    (out (B, 1, d), the new cache)."""
    b, _, d = x.shape
    d_inner, n_heads, conv_dim = ssm_dims(d, head_dim, expand, state, n_groups)
    zxbcdt = x[:, 0, :] @ p["in_proj"]
    z, xs, Bc, Cc, dt = _split_proj(zxbcdt, d_inner, n_groups, state, n_heads)
    xBC_new = torch.cat([xs, Bc, Cc], dim=-1)              # (B, conv_dim)
    conv_buf = torch.cat([cache["conv"].to(x.dtype), xBC_new[:, None, :]],
                         dim=1)
    xBC = einsum_f32("bkc,kc->bc", conv_buf, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(xBC).to(x.dtype)
    xs, Bc, Cc = torch.split(xBC, [d_inner, n_groups * state,
                                   n_groups * state], dim=-1)
    dt = F.softplus(dt.to(F32) + p["dt_bias"])             # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, n_heads, head_dim).to(F32)
    rep = n_heads // n_groups
    Bh = torch.repeat_interleave(Bc.reshape(b, n_groups, state), rep, dim=1)
    Ch = torch.repeat_interleave(Cc.reshape(b, n_groups, state), rep, dim=1)
    decay = torch.exp(dt * A[None, :])                     # (B,H)
    s_new = (cache["ssm"] * decay[:, :, None, None]
             + einsum_f32("bhp,bhn->bhpn", xh * dt[..., None], Bh))
    y = einsum_f32("bhpn,bhn->bhp", s_new, Ch)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(x.dtype), p["norm"])
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"ssm": s_new,
                 "conv": conv_buf[:, 1:, :].to(cache["conv"].dtype)}
