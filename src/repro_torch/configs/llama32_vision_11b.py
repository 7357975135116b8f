"""llama-3.2-vision-11b [vlm]: 40L text decoder d_model=4096 32H (GQA kv=8,
head_dim=128) d_ff=14336 vocab=128256, gated cross-attention to image
patches before every 5th layer.  Vision tower is a STUB per the assignment:
``input_specs`` provides precomputed patch embeddings (B, 1601, d_model).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
import dataclasses

from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", kind="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=128256, rope_theta=5e5,
    cross_attn_every=5, img_tokens=1601,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama-vision-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        cross_attn_every=2, img_tokens=24)
