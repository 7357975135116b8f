"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8, head_dim=128)
d_ff=25600 vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
import dataclasses

from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", kind="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab_size=151936, qk_norm=True, rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256)
