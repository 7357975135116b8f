"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4,
head_dim=128), 128 experts top-8 with expert d_ff=1536, vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-30B-A3B family; hf]

MoE parallelism on a mesh: 128 experts / 16 model shards = 8 local experts
→ ``ep`` mode (true expert parallelism; see ``models/moe.py``, which runs
it on one device or over a mesh's shards)."""
import dataclasses

from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", kind="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536, mode="ep"),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, mode="ep",
                      token_chunk=64))
