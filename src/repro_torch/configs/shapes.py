"""The assigned input-shape set and the (arch × shape) applicability rules.

Counterpart of ``repro/configs/shapes.py``:

  train_4k     seq 4,096   global_batch 256   — train_step
  prefill_32k  seq 32,768  global_batch 32    — serve prefill
  decode_32k   seq 32,768  global_batch 128   — serve decode (1 new token,
                                                KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     — long-context decode;
               sub-quadratic archs only (SSM / hybrid / sliding-window);
               pure full-attention archs SKIP it.

``input_specs`` gives tensors on the ``meta`` device (shapes and dtypes,
nothing allocated) where the reference gives ``ShapeDtypeStruct``s;
tokens are int64, as the port's token pipeline makes them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.transformer import ModelConfig, cache_spec


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    step: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

SHAPE_NAMES = tuple(SHAPES)


def is_subquadratic(cfg: ModelConfig) -> bool:
    return cfg.kind in ("ssm", "hybrid") or cfg.sliding_window is not None


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and not is_subquadratic(cfg):
        return False, ("full-attention arch: 500k decode is skipped per the "
                       "assignment (sub-quadratic archs only)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _memory_spec(cfg: ModelConfig, batch: int):
    """Stub modality frontend output (precomputed embeddings)."""
    if cfg.kind == "encdec":
        return _meta((batch, cfg.enc_seq, cfg.d_model), cfg.torch_dtype)
    if cfg.kind == "vlm":
        return _meta((batch, cfg.img_tokens, cfg.d_model), cfg.torch_dtype)
    return None


def _cache(spec):
    """``cache_spec``'s (shape, dtype) leaves as ``meta`` tensors."""
    if isinstance(spec, dict):
        return {k: _cache(v) for k, v in spec.items()}
    if isinstance(spec[1], torch.dtype):
        return _meta(*spec)
    return tuple(_cache(s) for s in spec)


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of the step."""
    sh = SHAPES[shape_name]
    i64 = torch.int64
    if sh.step in ("train", "prefill"):
        specs = {"tokens": _meta((sh.global_batch, sh.seq_len), i64)}
        mem = _memory_spec(cfg, sh.global_batch)
        if mem is not None:
            specs["memory"] = mem
        return specs
    if sh.step == "decode":
        return {"tokens": _meta((sh.global_batch, 1), i64),
                "cache": _cache(cache_spec(cfg, sh.global_batch,
                                           sh.seq_len))}
    raise ValueError(sh.step)
