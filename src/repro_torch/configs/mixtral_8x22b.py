"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8, head_dim=128),
8 experts top-2 with expert d_ff=16384, vocab=32768, sliding-window
attention (4096).  [arXiv:2401.04088; hf]

MoE parallelism on a mesh: 8 experts < 16 model shards → ``tp`` mode (every
expert on every shard, d_ff sharded; see ``models/moe.py``, which runs it
on one device or over a mesh's shards)."""
import dataclasses

from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", kind="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab_size=32768, rope_theta=1e6, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, mode="tp"),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-8x22b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        sliding_window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, mode="tp",
                      token_chunk=64))
