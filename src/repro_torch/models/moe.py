"""Mixture-of-Experts with sort-based grouped dispatch, single device.

Counterpart of ``repro/models/moe.py``.  Each (token, expert) assignment
is sorted by expert id; each expert multiplies its contiguous group of
rows (the reference's ``lax.ragged_dot``, here one ``torch.matmul`` per
expert), and the gated rows are summed back to their tokens in f32.  No
TPU kernel lies under it: the reference's grouped GEMMs are XLA's.

The two parameter keys of ``ModelConfig.moe_key`` (``moe_ep``,
``moe_tp``) compute the same function on one device.  Over a mesh
(``runtime.sharding.Parallelism``) the reference's ``shard_map`` body
runs once per (data, model) shard, as a loop: ``ep`` gives each model
shard ``E / model_size`` experts (``e0 = shard · e_local``), ``tp`` its
slice of ``d_ff``; the batch splits over the data shards when it
divides.  The weights arrive gathered (the train step's FSDP gather) and
each shard takes its slab.  ``y`` is the f32 sum over the model shards
(``psum``), ``aux`` the mean of the per-shard aux over all shards, the
reference's estimator (not the local path's).

On the ``meta`` device (the dry run) the group sizes are unknown; each
grouped product is priced as the reference prices ``ragged_dot``: every
row against one group's weight.

Ties follow the reference: ``lax.top_k`` returns the lower expert id
first on equal probabilities (a stable descending sort here), and the
dispatch order is a stable ``argsort``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .layers import F32, Leaf


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    mode: str = "ep"               # "ep" | "tp"
    token_chunk: int = 8192        # dispatch chunk (bounds T·K gather)
    aux_loss_coef: float = 0.01
    capacity_factor: float = 2.0   # local-row budget multiplier over the
                                   # balanced load t·K·(e_loc/E); rows past
                                   # it drop (standard capacity semantics)


def init_moe(d_model: int, cfg: MoEConfig, dtype=torch.bfloat16) -> dict:
    sd_in = 1.0 / math.sqrt(d_model)
    sd_out = 1.0 / math.sqrt(cfg.d_ff)
    E, Ff = cfg.n_experts, cfg.d_ff
    return {"router": Leaf((d_model, E), F32, sd_in),
            "w_gate": Leaf((E, d_model, Ff), dtype, sd_in),
            "w_up": Leaf((E, d_model, Ff), dtype, sd_in),
            "w_down": Leaf((E, Ff, d_model), dtype, sd_out)}


def _route(x2d, router, cfg: MoEConfig):
    """Returns (gates (T,K) f32, ids (T,K) int64, aux_loss scalar)."""
    logits = x2d.to(F32) @ router                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = srt[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E · Σ_e f_e · p̄_e
    T = x2d.shape[0]
    f = torch.zeros(cfg.n_experts, dtype=F32, device=x2d.device).index_add_(
        0, ids.reshape(-1), torch.full((ids.numel(),), 1.0 / (T * cfg.top_k),
                                       dtype=F32, device=x2d.device))
    aux = cfg.n_experts * torch.sum(f * probs.mean(dim=0))
    return gates, ids, aux


def _grouped_matmul(x, w, group_sizes: list):
    """``lax.ragged_dot``: rows of group e (contiguous, in order) times
    ``w[e]``; rows past Σ group_sizes are zero."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    start = 0
    for e, size in enumerate(group_sizes):
        if size:
            out[start:start + size] = x[start:start + size] @ w[e]
        start += size
    return out


def _expert_chunk(xc, gates, ids, w_gate, w_up, w_down, *, e0, e_local,
                  top_k, capacity):
    """One token chunk.  xc: (t, d); gates/ids: (t, K); expert weights
    the local slices (E_loc, d, F).  After the sort (local assignments
    first) only the first ``capacity`` rows compute; the rest drop."""
    t, d = xc.shape
    flat_ids = ids.reshape(-1)                             # (t·K,)
    flat_tok = torch.arange(t, device=xc.device).repeat_interleave(top_k)
    flat_gate = gates.reshape(-1)
    local = (flat_ids >= e0) & (flat_ids < e0 + e_local)
    lid = torch.where(local, flat_ids - e0, torch.full_like(flat_ids,
                                                             e_local))
    order = torch.argsort(lid, stable=True)                # non-local last
    order = order[:min(int(capacity), t * top_k)]
    s_lid = lid[order]
    s_tok = flat_tok[order]
    s_gate = torch.where(local[order], flat_gate[order],
                         torch.zeros_like(flat_gate[order]))
    xs = xc[s_tok]                                         # (cap, d)
    if xc.device.type == "meta":
        # no counts on meta: equal groups price the same rows · d · f
        sizes = [xs.shape[0] // e_local] * e_local
        sizes[-1] += xs.shape[0] - sum(sizes)
    else:
        sizes = torch.bincount(s_lid,
                               minlength=e_local + 1)[:e_local].tolist()
    h = (F.silu(_grouped_matmul(xs, w_gate, sizes).to(F32)).to(xs.dtype)
         * _grouped_matmul(xs, w_up, sizes))
    y = _grouped_matmul(h, w_down, sizes)                  # (cap, d)
    y = y.to(F32) * s_gate[:, None]
    return torch.zeros((t, d), dtype=F32, device=xc.device).index_add_(
        0, s_tok, y)


def _moe_local(x2d, router, w_gate, w_up, w_down, cfg: MoEConfig,
               e0: int, e_local: int):
    """Token-chunked local MoE pass; weights already the local slice."""
    T, d = x2d.shape
    gates, ids, aux = _route(x2d, router, cfg)
    tc = min(cfg.token_chunk, T)
    while T % tc:
        tc //= 2
    # Balanced local load per chunk × slack, rounded up to 128 rows.
    balanced = tc * cfg.top_k * e_local / cfg.n_experts
    capacity = int(-(-balanced * cfg.capacity_factor // 128) * 128)
    out = [_expert_chunk(x2d[c:c + tc], gates[c:c + tc], ids[c:c + tc],
                         w_gate, w_up, w_down, e0=e0, e_local=e_local,
                         top_k=cfg.top_k, capacity=capacity)
           for c in range(0, T, tc)]
    return torch.cat(out, dim=0), aux


def moe_forward(p, x, cfg: MoEConfig, parallel=None):
    """x: (B, S, d) -> (y (B, S, d), aux_loss).

    ``parallel``: a ``runtime.sharding.Parallelism`` (mesh + axis names) or
    None for the single-device path."""
    B, S, d = x.shape
    if parallel is None or parallel.mesh is None:
        y, aux = _moe_local(x.reshape(B * S, d), p["router"], p["w_gate"],
                            p["w_up"], p["w_down"], cfg, 0, cfg.n_experts)
        return y.reshape(B, S, d).to(x.dtype), aux
    from ..runtime.sharding import psum

    # Batch over the data shards when it divides (decode with B = 1
    # replicates over data; the model-axis sum is unaffected).
    n_data = parallel.data_size if B % parallel.data_size == 0 else 1
    n_model = parallel.model_size
    devs = parallel.devices_by_data()
    if cfg.mode == "ep":
        assert cfg.n_experts % n_model == 0, (cfg.n_experts, n_model)
        e_local = cfg.n_experts // n_model
    else:                            # "tp": d_ff sharded
        assert cfg.d_ff % n_model == 0
        e_local = cfg.n_experts
        f_local = cfg.d_ff // n_model
    bl = B // n_data
    ys, auxs = [], []
    for i in range(n_data):
        parts = []
        for m in range(n_model):
            dev = devs[i, m]
            if cfg.mode == "ep":
                e0, sl = m * e_local, slice(m * e_local, (m + 1) * e_local)
                w = (p["w_gate"][sl], p["w_up"][sl], p["w_down"][sl])
            else:
                e0, sl = 0, slice(m * f_local, (m + 1) * f_local)
                w = (p["w_gate"][..., sl], p["w_up"][..., sl],
                     p["w_down"][:, sl])
            xl = x[i * bl:(i + 1) * bl].reshape(bl * S, d).to(dev)
            y, aux = _moe_local(xl, p["router"].to(dev),
                                *(t.to(dev) for t in w), cfg, e0, e_local)
            parts.append(y)
            auxs.append(aux.to(devs[0, 0]))
        ys.append(psum(parts, n_model).reshape(bl, S, d)
                  .to(x.device, x.dtype))
    # pmean over all axes; with the batch replicated over data every data
    # row holds the same aux, so the mean over one row is the same.
    return torch.cat(ys), torch.stack(auxs).mean().to(x.device)
