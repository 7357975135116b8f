"""Composable transformer stack covering all ten architectures.

Counterpart of ``repro/models/transformer.py`` (training and serving).
One ``ModelConfig`` describes dense GQA (qwen3 /
phi3 / granite), MoE (mixtral / qwen3-moe), pure SSM (mamba2), hybrid
(zamba2: a Mamba2 backbone and one *shared* attention block applied
periodically), enc-dec (whisper) and cross-attention VLM
(llama-3.2-vision).  Modality frontends
are stubs, as in the reference: whisper takes precomputed frame
embeddings, the VLM precomputed image-patch embeddings.

:class:`Model` is an ``nn.Module`` on an explicit device.  Its parameter
tree is keyed as the reference's pytree (``model["layers"][i]["attn"]
["wq"]``), one entry of a ``ModuleList`` per layer where the reference
stacks layers on a leading axis; :func:`params_from_numpy` loads the
reference's ``init_params`` tree into it, so both packages compute the
same function.  The reference's ``lax.scan`` over stacked layers is a
Python loop over the blocks.

Training: :func:`train_loss` is the full forward and the chunked
next-token cross-entropy (:func:`lm_loss`), plus the MoE's load-balance
loss; its gradients come from ``torch.autograd``.  Each block of
:func:`forward_hidden` is checkpointed as ``cfg.remat`` says while
autograd records (:func:`_remat`).  :func:`params_to_numpy` is the
inverse of :func:`params_from_numpy`.

Over a mesh, ``par`` (a ``runtime.sharding.Parallelism``) reaches the
MoE layers only, as the reference's ``_mlp_or_moe(cfg, par, p, x)``
carries it: the other layers compute on gathered leaves (the reference's
``par.constrain`` calls are layout hints to GSPMD, which computes the
single-device function).

Serving: :func:`prefill` (full sequence; fills the KV / SSM caches) and
:func:`decode_step` (one token against the cache; ring-buffer writes,
``slot = pos % window``, support sliding-window caches).  Run them under
``torch.inference_mode()``.  The port updates a cache in place (the
reference returns a new one): after ``decode_step`` the cache passed in
is the new cache.  ``cache["pos"]`` is a Python int, so no step waits on
the device for it.

Products that the reference computes with ``preferred_element_type=f32``
accumulate in f32 here too (``layers.einsum_f32``); logits are
``(h @ lm_head)`` in the hidden state's dtype, then f32.  Dtypes promote
as in JAX: the VLM's gated cross blocks scale by ``tanh(gate)``, an f32
0-d array, which makes the hidden state f32 for the rest of the stack in
a bf16 config (torch would keep a 0-d tensor's product in bf16, so the
gate is applied through :func:`_gated`), and the products of that f32
state with bf16 weights run in f32 (``layers.matmul``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn

from . import layers as L
from . import moe as moe_lib
from . import ssm as ssm_lib

F32 = L.F32

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    head_dim: int = 64
    expand: int = 2
    state: int = 64
    n_groups: int = 1
    chunk: int = 256
    d_conv: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference's fields and defaults.  ``remat`` checkpoints the
    blocks in training (:func:`_remat`); ``unroll_scans`` is kept so that
    configs carry across (it shapes the reference's analysis graphs, and
    the port has no scan to unroll)."""
    name: str
    kind: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 128
    d_ff: int = 0
    vocab_size: int = 32000
    qk_norm: bool = False
    rope_theta: float = 1e6
    sliding_window: Optional[int] = None
    moe: Optional[moe_lib.MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 6      # hybrid: shared attn before every k-th
    enc_layers: int = 0             # encdec: encoder depth
    enc_seq: int = 1500             # encdec: stub frame count
    cross_attn_every: int = 0       # vlm: cross block before every k-th
    img_tokens: int = 1601          # vlm: stub patch count
    dtype: str = "bfloat16"
    remat: str = "selective"        # none | selective | full
    unroll_scans: bool = False
    attn_kv_chunk: int = 1024       # flash-attention KV tile
    attn_q_chunk: int = 4096        # flash-attention Q tile
    attn_causal_skip: bool = False  # skip fully-masked (q,kv) chunk pairs

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else F32

    @property
    def moe_key(self) -> str:
        return f"moe_{self.moe.mode}" if self.moe else "mlp"

    @property
    def n_cross(self) -> int:
        if self.kind != "vlm":
            return 0
        return math.ceil(self.n_layers / self.cross_attn_every)

    @property
    def n_shared(self) -> int:
        if self.kind != "hybrid":
            return 0
        return math.ceil(self.n_layers / self.hybrid_attn_every)

    def param_count(self) -> int:
        """Exact parameter count: the model built on the ``meta`` device
        (the counterpart of ``jax.eval_shape``; nothing is allocated)."""
        return sum(p.numel() for p in Model(self, device="meta").parameters())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        total = self.param_count()
        if not self.moe:
            return total
        per_expert = (2 * self.d_model * self.moe.d_ff
                      + self.moe.d_ff * self.d_model)
        inactive = (self.n_experts_total - self.moe.top_k) * per_expert \
            * self.n_layers
        return total - inactive

    @property
    def n_experts_total(self) -> int:
        return self.moe.n_experts if self.moe else 0


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _dense_layer_spec(cfg: ModelConfig) -> dict:
    dt = cfg.torch_dtype
    p = {"ln1": L.init_rms_norm(cfg.d_model),
         "attn": L.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, qk_norm=cfg.qk_norm, dtype=dt),
         "ln2": L.init_rms_norm(cfg.d_model)}
    if cfg.moe:
        p[cfg.moe_key] = moe_lib.init_moe(cfg.d_model, cfg.moe, dtype=dt)
    else:
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, dtype=dt)
    return p


def _ssm_layer_spec(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    return {"ln1": L.init_rms_norm(cfg.d_model),
            "ssm": ssm_lib.init_mamba2(
                cfg.d_model, head_dim=s.head_dim, expand=s.expand,
                state=s.state, n_groups=s.n_groups, d_conv=s.d_conv,
                dtype=cfg.torch_dtype)}


def _cross_layer_spec(cfg: ModelConfig) -> dict:
    dt = cfg.torch_dtype
    return {"ln1": L.init_rms_norm(cfg.d_model),
            "cross": L.init_attention(cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.d_head,
                                      qk_norm=cfg.qk_norm, dtype=dt),
            "ln2": L.init_rms_norm(cfg.d_model),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype=dt),
            "gate_attn": L.Leaf((), F32, fill=L.zeros),
            "gate_mlp": L.Leaf((), F32, fill=L.zeros)}


def _attn_gelu_spec(cfg: ModelConfig) -> dict:
    dt = cfg.torch_dtype
    return {"ln1": L.init_rms_norm(cfg.d_model),
            "attn": L.init_attention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.d_head, dtype=dt),
            "ln2": L.init_rms_norm(cfg.d_model),
            "mlp": L.init_mlp_gelu(cfg.d_model, cfg.d_ff, dtype=dt)}


def _encdec_dec_layer_spec(cfg: ModelConfig) -> dict:
    dt = cfg.torch_dtype
    return {"ln1": L.init_rms_norm(cfg.d_model),
            "attn": L.init_attention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.d_head, dtype=dt),
            "ln2": L.init_rms_norm(cfg.d_model),
            "cross": L.init_attention(cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.d_head, dtype=dt),
            "ln3": L.init_rms_norm(cfg.d_model),
            "mlp": L.init_mlp_gelu(cfg.d_model, cfg.d_ff, dtype=dt)}


def model_spec(cfg: ModelConfig) -> dict:
    """The reference's ``init_params`` tree as specs; a list holds one
    spec per layer where the reference stacks them."""
    dt = cfg.torch_dtype
    sd = 1.0 / math.sqrt(cfg.d_model)
    spec: dict = {
        "embed": {"table": L.Leaf((cfg.vocab_size, cfg.d_model), dt, sd)},
        "final_norm": L.init_rms_norm(cfg.d_model),
        "lm_head": L.Leaf((cfg.d_model, cfg.vocab_size), dt, sd),
    }
    if cfg.kind in ("dense", "moe", "vlm"):
        layer = _dense_layer_spec(cfg)
    elif cfg.kind in ("ssm", "hybrid"):
        layer = _ssm_layer_spec(cfg)
    elif cfg.kind == "encdec":
        layer = _encdec_dec_layer_spec(cfg)
        spec["encoder"] = [_attn_gelu_spec(cfg)] * cfg.enc_layers
    else:
        raise ValueError(cfg.kind)
    spec["layers"] = [layer] * cfg.n_layers
    if cfg.kind == "hybrid":
        spec["shared_attn"] = {
            "ln1": L.init_rms_norm(cfg.d_model),
            "attn": L.init_attention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.d_head, dtype=dt),
            "ln2": L.init_rms_norm(cfg.d_model),
            "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, dtype=dt)}
    if cfg.kind == "vlm":
        spec["cross_layers"] = [_cross_layer_spec(cfg)] * cfg.n_cross
    return spec


class Model(L.Params):
    """The parameters of one architecture on ``device``, which the caller
    names (there is no default device).  ``generator`` (a
    ``torch.Generator`` on ``device``) draws the random init; on the
    ``meta`` device nothing is allocated."""

    def __init__(self, cfg: ModelConfig, device, generator=None):
        super().__init__()
        self.cfg = cfg
        for key, sub in model_spec(cfg).items():
            if isinstance(sub, list):
                self.add_module(key, nn.ModuleList(
                    L.materialize(s, device, generator) for s in sub))
            elif isinstance(sub, dict):
                self.add_module(key, L.materialize(sub, device, generator))
            else:
                self.register_parameter(key, L.materialize(
                    {key: sub}, device, generator)[key])


def init_params(cfg: ModelConfig, device, seed: int = 0) -> Model:
    """A randomly initialised model: the reference's distributions and
    scales from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Model(cfg, device=device, generator=gen)


_STACKED = ("layers", "encoder", "cross_layers")


def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> Model:
    """Load the reference's ``init_params`` pytree, as numpy arrays (or
    tensors), into a port model on ``device``.  Leaves of ``layers`` /
    ``encoder`` / ``cross_layers`` are stacked per layer, ``(L, ...)``,
    and are sliced layer by layer.  bf16 leaves may come as f32 arrays
    (bf16 → f32 → bf16 is lossless); every leaf is cast to the
    parameter's dtype."""
    model = Model(cfg, device="meta")

    def load(node, sub: dict, index=None):
        for key, value in sub.items():
            if isinstance(value, dict):
                load(node[key], value, index)
                continue
            target = node[key]
            arr = value if index is None else value[index]
            t = (arr.detach().clone() if isinstance(arr, torch.Tensor)
                 else torch.tensor(arr)).to(device=device, dtype=target.dtype)
            if t.shape != target.shape:
                raise ValueError(f"{key}: shape {tuple(t.shape)} where the "
                                 f"model has {tuple(target.shape)}")
            setattr(node, key, nn.Parameter(t, requires_grad=False))

    missing = set(model_spec(cfg)) - set(tree)
    if missing:
        raise ValueError(f"the tree lacks {sorted(missing)}")
    for key, value in tree.items():
        if key in _STACKED:
            for i, block in enumerate(model[key]):
                load(block, value, i)
        elif isinstance(value, dict):
            load(model[key], value)
        else:
            load(model, {key: value})
    left = [n for n, p in model.named_parameters() if p.device.type == "meta"]
    if left:
        raise ValueError(f"the tree does not set {left[:4]}")
    return model


def _layer_split(name: str):
    """``"layers.3.attn.wq"`` -> (("layers", "attn", "wq"), 3): the path of
    the reference's stacked leaf and the row; (path, None) for a name
    with no layer index."""
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            return tuple(parts[:i] + parts[i + 1:]), int(part)
    return tuple(parts), None


def stack_layers(named: dict) -> dict:
    """``{dotted name: tensor}`` (a module's ``named_parameters`` names,
    or a tree keyed by them) -> the reference's nested tree, each
    per-layer tensor stacked into its ``(L, ...)`` leaf.  A
    ``runtime.sharding.ShardedTensor`` stacks block by block."""
    tree: dict = {}
    rows: dict = {}
    for name, t in named.items():
        path, layer = _layer_split(name)
        if layer is None:
            _set_path(tree, path, t)
        else:
            rows.setdefault(path, {})[layer] = t
    for path, by_layer in rows.items():
        layers = [by_layer[i] for i in range(len(by_layer))]
        _set_path(tree, path, layers[0].stack(layers)
                  if hasattr(layers[0], "shards") else torch.stack(layers))
    return tree


def unstack_layers(tree: dict, names) -> dict:
    """The inverse of :func:`stack_layers`: ``{name: leaf}`` for each of
    ``names``, a per-layer name reading its row of the stacked leaf."""
    out = {}
    for name in names:
        path, layer = _layer_split(name)
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = leaf if layer is None else leaf[layer]
    return out


def _set_path(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def decayed_names(named: dict) -> set:
    """Of ``{dotted name: tensor}``, the names the reference's AdamW
    decays: those whose leaf in the reference's tree has rank ≥ 2.  A
    per-layer parameter is a row of a stacked ``(L, ...)`` leaf, so a
    per-layer norm scale decays as the matrices do; ``final_norm``'s
    ``(d,)`` scale does not."""
    return {n for n, p in named.items()
            if p.ndim + (_layer_split(n)[1] is not None) >= 2}


def params_to_numpy(model: Model) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's pytree
    as numpy arrays, bf16 widened to f32 (losslessly)."""
    def to_np(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def walk(node):
        return ({k: walk(v) for k, v in node.items()}
                if isinstance(node, dict) else to_np(node))
    return walk(stack_layers({n: p.detach().cpu()
                              for n, p in model.named_parameters()}))


# ---------------------------------------------------------------------------
# Blocks (full-sequence path)
# ---------------------------------------------------------------------------


def _self_attn_full(cfg, p, x, positions, *, causal=True,
                    sliding_window=None, emit_kv=False, rope=True):
    h = L.rms_norm(x, p["ln1"]["scale"])
    q, k, v = L.attention_qkv(
        p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, positions,
        cfg.rope_theta if rope else 0.0, qk_norm=cfg.qk_norm)
    o = L.flash_attention(q, k, v, causal=causal, q_positions=positions,
                          kv_positions=positions,
                          sliding_window=sliding_window,
                          kv_chunk=cfg.attn_kv_chunk,
                          q_chunk=cfg.attn_q_chunk,
                          causal_skip=cfg.attn_causal_skip)
    x = x + L.attention_out(p["attn"], o)
    return x, ((k, v) if emit_kv else None)


def _cross_attn_full(cfg, p_cross, x, memory):
    """Cross-attention: queries from x, kv from encoder / image memory."""
    B, S, _ = x.shape
    Sm = memory.shape[1]
    q = L.matmul(x, p_cross["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = L.matmul(memory, p_cross["wk"]).reshape(B, Sm, cfg.n_kv_heads, cfg.d_head)
    v = L.matmul(memory, p_cross["wv"]).reshape(B, Sm, cfg.n_kv_heads, cfg.d_head)
    if "q_norm" in p_cross:
        q = L.rms_norm(q, p_cross["q_norm"])
        k = L.rms_norm(k, p_cross["k_norm"])
    dev = x.device
    o = L.flash_attention(q, k, v, causal=False,
                          q_positions=torch.arange(S, device=dev),
                          kv_positions=torch.arange(Sm, device=dev),
                          kv_chunk=cfg.attn_kv_chunk,
                          q_chunk=cfg.attn_q_chunk)
    return L.attention_out(p_cross, o)


def _mlp_or_moe(cfg, p, x, par=None):
    """Second half of a dense block.  Returns (x, aux_loss).  ``par``: the
    mesh the MoE runs over (None: one device)."""
    h = L.rms_norm(x, p["ln2"]["scale"])
    if cfg.moe:
        y, aux = moe_lib.moe_forward(p[cfg.moe_key], h, cfg.moe, par)
        return x + y.to(x.dtype), aux
    return x + L.mlp(p["mlp"], h), 0.0


def _dense_block_full(cfg, p, x, positions, emit_kv=False, par=None):
    x, kv = _self_attn_full(cfg, p, x, positions, causal=True,
                            sliding_window=cfg.sliding_window,
                            emit_kv=emit_kv)
    x, aux = _mlp_or_moe(cfg, p, x, par)
    return x, kv, aux


def _ssm_kw(cfg) -> dict:
    s = cfg.ssm
    return dict(head_dim=s.head_dim, expand=s.expand, state=s.state,
                n_groups=s.n_groups)


def _ssm_block_full(cfg, p, x, emit_cache=False):
    h = L.rms_norm(x, p["ln1"]["scale"])
    out = ssm_lib.mamba2_forward(p["ssm"], h, chunk=cfg.ssm.chunk,
                                 return_cache=emit_cache, **_ssm_kw(cfg))
    if emit_cache:
        y, cache = out
        return x + y.to(x.dtype), cache
    return x + out.to(x.dtype), None


def _shared_attn_block_full(cfg, p, x, positions, emit_kv=False):
    x, kv = _self_attn_full(cfg, p, x, positions, causal=True,
                            emit_kv=emit_kv)
    x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"]["scale"]))
    return x, kv


def _encdec_dec_block(cfg, lp, x, positions, enc, emit_kv=False):
    x, kv = _self_attn_full(cfg, lp, x, positions, causal=True,
                            emit_kv=emit_kv)
    h = L.rms_norm(x, lp["ln2"]["scale"])
    x = x + _cross_attn_full(cfg, lp["cross"], h, enc).to(x.dtype)
    x = x + L.mlp_gelu(lp["mlp"], L.rms_norm(x, lp["ln3"]["scale"]))
    return x, kv


def _enc_block(cfg, lp, x, positions):
    x, _ = _self_attn_full(cfg, lp, x, positions, causal=False, rope=False)
    return x + L.mlp_gelu(lp["mlp"], L.rms_norm(x, lp["ln2"]["scale"]))


# The 2-D weight products that "selective" saves: ``x @ w`` reaches aten
# as ``mm`` (``addmm`` with a bias); attention's batched products are
# ``bmm`` and are recomputed, as ``dots_with_no_batch_dims_saveable``
# saves only the reference's dots without batch dimensions.
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_weight_products(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """The reference's ``jax.checkpoint`` of a block, as
    ``torch.utils.checkpoint``: ``"full"`` recomputes the whole block in
    the backward pass, ``"selective"`` saves its weight products and
    recomputes the rest, ``"none"`` saves everything.  Only while
    autograd records: under ``inference_mode`` or ``no_grad`` the block
    runs as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils import checkpoint as ckpt

    context = (ckpt.noop_context_fn if cfg.remat == "full" else
               functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_weight_products))
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             context_fn=context)


def _gated(gate, y):
    """``jnp.tanh(gate) * y`` for an f32 0-d ``gate``: JAX promotes the
    product to f32 (torch would keep y's dtype)."""
    dt = torch.promote_types(gate.dtype, y.dtype)
    return torch.tanh(gate).to(dt) * y.to(dt)


def _gated_cross_block(cfg, cp, x, attn_out):
    """The VLM's gated cross block around its attention output; in a bf16
    config it returns an f32 hidden state, as the reference does."""
    x = x + _gated(cp["gate_attn"], attn_out.to(x.dtype))
    return x + _gated(cp["gate_mlp"], L.mlp(
        cp["mlp"], L.rms_norm(x, cp["ln2"]["scale"])).to(x.dtype))


# ---------------------------------------------------------------------------
# Full-sequence forward (train + prefill)
# ---------------------------------------------------------------------------


def embed_tokens(cfg, model, tokens):
    return model["embed"]["table"][tokens].to(cfg.torch_dtype)


def _vlm_groups(cfg):
    """[(cross_idx, layer_start, layer_end)] — cross block BEFORE each."""
    e = cfg.cross_attn_every
    return [(g, g * e, min((g + 1) * e, cfg.n_layers))
            for g in range(cfg.n_cross)]


def _hybrid_groups(cfg):
    e = cfg.hybrid_attn_every
    return [(g, g * e, min((g + 1) * e, cfg.n_layers))
            for g in range(cfg.n_shared)]


def _stack_kv(kvs):
    """[(k, v) per layer] -> (K (L,B,S,K,Dh), V (L,B,S,K,Dh))."""
    return (torch.stack([kv[0] for kv in kvs]),
            torch.stack([kv[1] for kv in kvs]))


def _stack_ssm(caches):
    return {key: torch.stack([c[key] for c in caches])
            for key in ("ssm", "conv")}


def forward_hidden(model: Model, tokens, memory=None, collect_caches=False,
                   par=None):
    """tokens (B, S) -> (final hidden states (B, S, d), aux loss).

    ``memory``: (B, Sm, d) encoder frames (encdec) or image patches (vlm).
    ``collect_caches``: also return the prefill caches (see ``prefill``).
    ``par``: the mesh the MoE layers run over (None: one device).
    """
    cfg = model.cfg
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)
    x = embed_tokens(cfg, model, tokens)
    caches: dict = {}
    aux_total = torch.zeros((), dtype=F32, device=dev)
    kvs = []

    dense_block = _remat(cfg, _dense_block_full)
    ssm_block = _remat(cfg, _ssm_block_full)

    if cfg.kind in ("dense", "moe"):
        for lp in model["layers"]:
            x, kv, aux = dense_block(cfg, lp, x, positions,
                                     emit_kv=collect_caches, par=par)
            aux_total = aux_total + aux
            kvs.append(kv)
        if collect_caches:
            caches["self_kv"] = _stack_kv(kvs)

    elif cfg.kind == "ssm":
        ssm_caches = []
        for lp in model["layers"]:
            x, c = ssm_block(cfg, lp, x, emit_cache=collect_caches)
            ssm_caches.append(c)
        if collect_caches:
            caches["ssm"] = _stack_ssm(ssm_caches)

    elif cfg.kind == "hybrid":
        ssm_caches = []
        for g, s0, e0 in _hybrid_groups(cfg):
            x, kv = _shared_attn_block_full(cfg, model["shared_attn"], x,
                                            positions, emit_kv=collect_caches)
            kvs.append(kv)
            for lp in model["layers"][s0:e0]:
                x, c = ssm_block(cfg, lp, x, emit_cache=collect_caches)
                ssm_caches.append(c)
        if collect_caches:
            caches["shared_kv"] = _stack_kv(kvs)
            caches["ssm"] = _stack_ssm(ssm_caches)

    elif cfg.kind == "vlm":
        if memory is None:
            raise ValueError("vlm needs image patch embeddings")
        memory = memory.to(cfg.torch_dtype)
        for g, s0, e0 in _vlm_groups(cfg):
            cp = model["cross_layers"][g]
            h = L.rms_norm(x, cp["ln1"]["scale"])
            x = _gated_cross_block(cfg, cp, x,
                                   _cross_attn_full(cfg, cp["cross"], h,
                                                    memory))
            for lp in model["layers"][s0:e0]:
                x, kv, aux = dense_block(cfg, lp, x, positions,
                                         emit_kv=collect_caches, par=par)
                aux_total = aux_total + aux
                kvs.append(kv)
        if collect_caches:
            caches["self_kv"] = _stack_kv(kvs)
            caches["cross_kv"] = _cross_kv(cfg, model["cross_layers"],
                                           memory)

    elif cfg.kind == "encdec":
        if memory is None:
            raise ValueError("encdec needs encoder frame embeddings")
        enc = _encode(cfg, model, memory)
        dec_block = _remat(cfg, _encdec_dec_block)
        for lp in model["layers"]:
            x, kv = dec_block(cfg, lp, x, positions, enc,
                              emit_kv=collect_caches)
            kvs.append(kv)
        if collect_caches:
            caches["self_kv"] = _stack_kv(kvs)
            caches["cross_kv"] = _cross_kv(cfg, model["layers"], enc)
    else:
        raise ValueError(cfg.kind)

    x = L.rms_norm(x, model["final_norm"]["scale"])
    return (x, aux_total, caches) if collect_caches else (x, aux_total)


def _encode(cfg, model, frames):
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): sinusoidal positions + a bidirectional attention stack."""
    frames = frames.to(cfg.torch_dtype)
    B, Sm, d = frames.shape
    dev = frames.device
    pos = torch.arange(Sm, device=dev, dtype=F32)[:, None] / (
        10000 ** (torch.arange(0, d, 2, device=dev, dtype=F32)[None, :] / d))
    pe = torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)[None]
    x = frames + pe.to(cfg.torch_dtype)
    positions = torch.arange(Sm, device=dev)
    block = _remat(cfg, _enc_block)
    for lp in model["encoder"]:
        x = block(cfg, lp, x, positions)
    return x


def _cross_kv(cfg, blocks, memory):
    """Per-block cross K/V over the encoder output or image patches
    (the reference's ``_encdec_cross_kv`` / ``_vlm_cross_kv``)."""
    B, Sm, _ = memory.shape
    kvs = [(L.matmul(memory, b["cross"]["wk"]).reshape(B, Sm, cfg.n_kv_heads,
                                                cfg.d_head),
            L.matmul(memory, b["cross"]["wv"]).reshape(B, Sm, cfg.n_kv_heads,
                                                cfg.d_head))
           for b in blocks]
    return _stack_kv(kvs)


def logits_of(model: Model, hidden):
    """(…, d) hidden states -> f32 logits: the product in the model dtype,
    then f32, as the reference."""
    return L.matmul(hidden, model["lm_head"]).to(F32)


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy)
# ---------------------------------------------------------------------------


def lm_loss(model: Model, hidden, tokens, chunk: int = 512):
    """Next-token cross-entropy over sequence chunks, so that the
    (B, tc, V) logits never exceed one chunk: S − 1 positions padded (and
    masked) up to a chunk multiple, as the reference does.  The logits
    are f32 from an f32 ``lm_head``; the sum is divided by B·(S − 1)."""
    B, S, d = hidden.shape
    h = hidden[:, :-1, :]
    t = tokens[:, 1:].long()
    n = S - 1
    tc = min(chunk, n)
    n_pad = (n + tc - 1) // tc * tc
    if n_pad != n:
        h = torch.nn.functional.pad(h, (0, 0, 0, n_pad - n))
        t = torch.nn.functional.pad(t, (0, n_pad - n))
    valid = (torch.arange(n_pad, device=hidden.device) < n).to(F32)
    head = model["lm_head"].to(F32)
    total = torch.zeros((), dtype=F32, device=hidden.device)
    for c in range(0, n_pad, tc):
        logits = h[:, c:c + tc].to(F32) @ head
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, t[:, c:c + tc, None])[..., 0]
        total = total + torch.sum((lse - ll) * valid[c:c + tc])
    return total / (B * n)


def train_loss(model: Model, batch: dict, par=None):
    """The full training loss: the LM cross-entropy plus, for the MoE
    configs, ``aux_loss_coef`` times the load-balance loss.
    ``batch["memory"]``: the frames (encdec) or patches (vlm); ``par``:
    the mesh the MoE layers run over."""
    cfg = model.cfg
    hidden, aux = forward_hidden(model, batch["tokens"],
                                 memory=batch.get("memory"), par=par)
    loss = lm_loss(model, hidden, batch["tokens"])
    if cfg.moe:
        loss = loss + cfg.moe.aux_loss_coef * aux
    return loss


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

_INVALID_POS = 2 ** 30   # cache-slot sentinel: always masked out


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """The cache layout: (shape, dtype) for every tensor, as the
    reference's ``cache_spec``; ``pos`` is a Python int."""
    f32 = F32
    dt = cfg.torch_dtype
    window = min(max_seq, cfg.sliding_window or max_seq)
    c = {"kv_positions": ((batch, window), torch.int32)}
    kv = lambda n, s: (((n, batch, s, cfg.n_kv_heads, cfg.d_head), dt),) * 2
    if cfg.kind in ("dense", "moe", "vlm", "encdec"):
        c["self_kv"] = kv(cfg.n_layers, window)
    if cfg.kind == "vlm":
        c["cross_kv"] = kv(cfg.n_cross, cfg.img_tokens)
    if cfg.kind == "encdec":
        c["cross_kv"] = kv(cfg.n_layers, cfg.enc_seq)
    if cfg.kind in ("ssm", "hybrid"):
        s = cfg.ssm
        d_inner, n_heads, conv_dim = ssm_lib.ssm_dims(
            cfg.d_model, s.head_dim, s.expand, s.state, s.n_groups)
        c["ssm"] = {
            "ssm": ((cfg.n_layers, batch, n_heads, s.head_dim, s.state), f32),
            "conv": ((cfg.n_layers, batch, s.d_conv - 1, conv_dim), f32)}
    if cfg.kind == "hybrid":
        c["shared_kv"] = kv(cfg.n_shared, window)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device) -> dict:
    def zeros(spec):
        if isinstance(spec, dict):
            return {k: zeros(v) for k, v in spec.items()}
        if isinstance(spec[1], torch.dtype):
            return torch.zeros(spec[0], dtype=spec[1], device=device)
        return tuple(zeros(s) for s in spec)

    c = zeros(cache_spec(cfg, batch, max_seq))
    c["kv_positions"].fill_(_INVALID_POS)
    c["pos"] = 0
    return c


def _attn_decode(cfg, p_attn, x1, k_cache, v_cache, kv_positions, pos: int,
                 sliding_window=None, rope=True):
    """One-token attention against a cache layer.  x1: (B, 1, d).  GQA in
    the reference's grouped form, (B, K, G, Dh): head h = k·G + g reads kv
    head k = h // G, the map ``repeat_interleave`` gives the full path."""
    B = x1.shape[0]
    H, K = cfg.n_heads, cfg.n_kv_heads
    G = H // K
    q = L.matmul(x1, p_attn["wq"]).reshape(B, 1, H, cfg.d_head)
    if "q_norm" in p_attn:
        q = L.rms_norm(q, p_attn["q_norm"])
    if rope and cfg.rope_theta:
        q = L.apply_rope(q, torch.full((B, 1), pos, device=x1.device),
                         cfg.rope_theta)
    qg = q.reshape(B, K, G, cfg.d_head)
    s = L.einsum_f32("bkgd,bskd->bkgs", qg, k_cache) / math.sqrt(cfg.d_head)
    mask = kv_positions[:, None, None, :] <= pos
    if sliding_window is not None:
        mask = mask & (kv_positions[:, None, None, :] > pos - sliding_window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    pr = torch.softmax(s, dim=-1)
    o = L.einsum_f32("bkgs,bskd->bkgd", pr.to(v_cache.dtype),
                     v_cache).to(x1.dtype)
    return L.attention_out(p_attn, o.reshape(B, 1, H, cfg.d_head))


def _write_kv(cfg, p_attn, x1, k_cache, v_cache, slot: int, pos: int,
              rope=True):
    """Project the current token's K/V and write them into the cache
    layer at ``slot``, in place (the reference's one-hot select)."""
    B = x1.shape[0]
    k = L.matmul(x1, p_attn["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v = L.matmul(x1, p_attn["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    if "k_norm" in p_attn:
        k = L.rms_norm(k, p_attn["k_norm"])
    if rope and cfg.rope_theta:
        k = L.apply_rope(k, torch.full((B, 1), pos, device=x1.device),
                         cfg.rope_theta)
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)


def _self_attn_decode(cfg, p, x, kc, vc, kv_positions, slot, pos,
                      sliding_window=None):
    h = L.rms_norm(x, p["ln1"]["scale"])
    _write_kv(cfg, p["attn"], h, kc, vc, slot, pos)
    return x + _attn_decode(cfg, p["attn"], h, kc, vc, kv_positions, pos,
                            sliding_window=sliding_window)


def _ssm_decode(cfg, lp, x, cache: dict, i: int):
    """Layer i's SSM step; writes its new state into the stacked cache."""
    h = L.rms_norm(x, lp["ln1"]["scale"])
    y, nc = ssm_lib.mamba2_decode_step(
        lp["ssm"], h, {"ssm": cache["ssm"][i], "conv": cache["conv"][i]},
        **_ssm_kw(cfg))
    cache["ssm"][i] = nc["ssm"]
    cache["conv"][i] = nc["conv"]
    return x + y.to(x.dtype)


def _cross_decode(cfg, p_cross, h, ck, cv):
    """One token's cross-attention against a cached memory K/V."""
    B = h.shape[0]
    q = L.matmul(h, p_cross["wq"]).reshape(B, 1, cfg.n_heads, cfg.d_head)
    if "q_norm" in p_cross:
        q = L.rms_norm(q, p_cross["q_norm"])
    o = L.naive_attention(q, ck, cv, causal=False,
                          q_positions=torch.zeros((B, 1), dtype=torch.int32,
                                                  device=h.device),
                          kv_positions=torch.arange(ck.shape[1],
                                                    device=h.device))
    return L.attention_out(p_cross, o)


def decode_step(model: Model, cache: dict, tokens, par=None):
    """One decode step.  tokens (B, 1) -> (logits (B, V) f32, cache); the
    cache is updated in place and returned.  ``par``: the mesh the MoE
    layers run over."""
    cfg = model.cfg
    B = tokens.shape[0]
    pos = cache["pos"]
    window = cache["kv_positions"].shape[1]
    slot = pos % window
    x = embed_tokens(cfg, model, tokens)
    kv_positions = cache["kv_positions"]
    kv_positions[:, slot] = pos
    sw = cfg.sliding_window

    if cfg.kind in ("dense", "moe"):
        kcs, vcs = cache["self_kv"]
        for i, lp in enumerate(model["layers"]):
            x = _self_attn_decode(cfg, lp, x, kcs[i], vcs[i], kv_positions,
                                  slot, pos, sliding_window=sw)
            x, _ = _mlp_or_moe(cfg, lp, x, par)

    elif cfg.kind == "ssm":
        for i, lp in enumerate(model["layers"]):
            x = _ssm_decode(cfg, lp, x, cache["ssm"], i)

    elif cfg.kind == "hybrid":
        sk, sv = cache["shared_kv"]
        sp = model["shared_attn"]
        for g, s0, e0 in _hybrid_groups(cfg):
            x = _self_attn_decode(cfg, sp, x, sk[g], sv[g], kv_positions,
                                  slot, pos)
            x = x + L.mlp(sp["mlp"], L.rms_norm(x, sp["ln2"]["scale"]))
            for i in range(s0, e0):
                x = _ssm_decode(cfg, model["layers"][i], x, cache["ssm"], i)

    elif cfg.kind == "vlm":
        ck, cv = cache["cross_kv"]
        kcs, vcs = cache["self_kv"]
        for g, s0, e0 in _vlm_groups(cfg):
            cp = model["cross_layers"][g]
            h = L.rms_norm(x, cp["ln1"]["scale"])
            x = _gated_cross_block(cfg, cp, x,
                                   _cross_decode(cfg, cp["cross"], h, ck[g],
                                                 cv[g]))
            for i in range(s0, e0):
                lp = model["layers"][i]
                x = _self_attn_decode(cfg, lp, x, kcs[i], vcs[i],
                                      kv_positions, slot, pos)
                x, _ = _mlp_or_moe(cfg, lp, x, par)

    elif cfg.kind == "encdec":
        ck, cv = cache["cross_kv"]
        kcs, vcs = cache["self_kv"]
        for i, lp in enumerate(model["layers"]):
            x = _self_attn_decode(cfg, lp, x, kcs[i], vcs[i], kv_positions,
                                  slot, pos)
            h = L.rms_norm(x, lp["ln2"]["scale"])
            x = x + _cross_decode(cfg, lp["cross"], h, ck[i],
                                  cv[i]).to(x.dtype)
            x = x + L.mlp_gelu(lp["mlp"], L.rms_norm(x, lp["ln3"]["scale"]))
    else:
        raise ValueError(cfg.kind)

    x = L.rms_norm(x, model["final_norm"]["scale"])
    cache["pos"] = pos + 1
    return logits_of(model, x[:, 0, :]), cache


def prefill(model: Model, tokens, memory=None, max_seq: int | None = None,
            par=None):
    """Full-sequence prefill: returns (last-token logits (B, V) f32, the
    populated cache for ``max_seq`` positions).  ``par``: the mesh the
    MoE layers run over."""
    cfg = model.cfg
    B, S = tokens.shape
    dev = tokens.device
    hidden, _aux, caches = forward_hidden(model, tokens, memory=memory,
                                          collect_caches=True, par=par)
    logits = logits_of(model, hidden[:, -1, :])
    max_seq = max_seq or S
    window = min(max_seq, cfg.sliding_window or max_seq)
    cache = init_cache(cfg, B, max_seq, dev)
    cache["pos"] = S

    def fit_window(k):   # (L, B, S, K, Dh) -> ring slots (slot = pos % W)
        k = k.to(cfg.torch_dtype)
        if k.shape[2] <= window:
            pad = window - k.shape[2]
            return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        # keep the last `window` positions, placed so that position p sits
        # at slot p % window — the invariant decode's ring writes assume.
        return torch.roll(k[:, :, -window:], S % window, dims=2)

    if S >= window:
        kv_pos = torch.roll(torch.arange(S, device=dev)[-window:],
                            S % window)
    else:
        kv_pos = torch.cat([torch.arange(S, device=dev),
                            torch.full((window - S,), _INVALID_POS,
                                       device=dev)])
    cache["kv_positions"] = kv_pos[None, :].expand(B, window).to(
        torch.int32).contiguous()
    for key in ("self_kv", "shared_kv"):
        if key in caches and key in cache:
            cache[key] = tuple(fit_window(k) for k in caches[key])
    if cfg.kind in ("ssm", "hybrid"):
        cache["ssm"] = caches["ssm"]
    if cfg.kind in ("vlm", "encdec"):
        cache["cross_kv"] = tuple(k.to(cfg.torch_dtype).contiguous()
                                  for k in caches["cross_kv"])
    return logits, cache
