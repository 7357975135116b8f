"""whisper-medium [audio, enc-dec]: 24 encoder + 24 decoder layers,
d_model=1024 16H (kv=16, head_dim=64) d_ff=4096 vocab=51865.  The conv/mel
frontend is a STUB per the assignment: ``input_specs`` provides precomputed
frame embeddings (B, 1500, d_model).  [arXiv:2212.04356; unverified]"""
import dataclasses

from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", kind="encdec",
    n_layers=24, enc_layers=24, enc_seq=1500,
    d_model=1024, n_heads=16, n_kv_heads=16, d_head=64,
    d_ff=4096, vocab_size=51865, rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-medium-smoke", n_layers=2, enc_layers=2,
        enc_seq=32, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256)
