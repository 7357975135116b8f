"""mamba2-2.7b [ssm, attention-free]: 64L d_model=2560, SSD state=128,
head_dim=64 (d_inner=5120 → 80 heads), vocab=50280.
[arXiv:2405.21060; unverified]"""
import dataclasses

from ..models.transformer import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", kind="ssm",
    n_layers=64, d_model=2560, d_ff=0, vocab_size=50280,
    ssm=SSMConfig(head_dim=64, expand=2, state=128, chunk=256),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-2.7b-smoke", n_layers=2, d_model=64,
        vocab_size=256,
        ssm=SSMConfig(head_dim=16, expand=2, state=16, chunk=32))
