"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10, head_dim=128)
d_ff=17920 vocab=100352 — RoPE SwiGLU GQA.  [arXiv:2404.14219; unverified]

Note: 40 heads is not divisible by the 16-way model axis; attention
activations are left unconstrained and GSPMD resolves the layout (DESIGN.md
§4 parallelism notes)."""
import dataclasses

from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", kind="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_head=128,
    d_ff=17920, vocab_size=100352, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="phi3-medium-14b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256)
