"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8, head_dim=64)
d_ff=8192 vocab=49155 — GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
import dataclasses

from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", kind="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab_size=49155, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256)
