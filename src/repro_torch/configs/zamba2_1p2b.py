"""zamba2-1.2b [hybrid]: 38L d_model=2048, Mamba2 backbone (state=64) +
SHARED attention block (32H, kv=32, head_dim=64; d_ff=8192) applied before
every 6th Mamba2 layer.  vocab=32000.  [arXiv:2411.15242; hf]

The shared block reuses ONE parameter set at every application (Zamba2's
signature trick); each application keeps its own KV cache at decode."""
import dataclasses

from ..models.transformer import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", kind="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=32000, rope_theta=1e4,
    ssm=SSMConfig(head_dim=64, expand=2, state=64, chunk=256),
    hybrid_attn_every=6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-1.2b-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256,
        ssm=SSMConfig(head_dim=16, expand=2, state=16, chunk=32),
        hybrid_attn_every=2)
