"""Deterministic synthetic token pipeline for LM training.

Counterpart of ``repro/data/tokens.py``:

  * **stateless**: the batch for step ``s`` is a pure function of
    (seed, s), so a restart replays the stream with no iterator state in
    the checkpoint (the checkpoint stores only the step);
  * **on the device**: the batch is drawn by a ``torch.Generator`` on the
    pipeline's device, seeded from (seed, s), so no host-to-device copy
    of a global batch;
  * **structured**: tokens follow a Zipf marginal with short-range
    repetition, so cross-entropy falls during a smoke-training run.

The reference draws with ``jax.random``; a torch generator cannot give
the same stream, so the port is held to the stream's properties
(determinism, range, the Zipf marginal, the repetition rate) and
``_zipf_inverse_cdf`` to the reference's on the same uniforms.  Tokens
are int64, torch's index dtype (the reference's are int32).
"""
from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.1       # Zipf exponent for the unigram marginal
    repeat_p: float = 0.35    # P(copy a recent token): learnable structure
    repeat_window: int = 8


def _zipf_inverse_cdf(u: torch.Tensor, vocab: int, a: float) -> torch.Tensor:
    """Map U(0,1) to Zipf-ish ranks: the continuous truncated-Pareto
    quantile for p(k) ∝ (k+1)^(−a), rank = (1 + u·((V+1)^(1−a) − 1))^(1/(1−a))
    − 1, in u's dtype, truncated and clipped to [0, V − 1]; rank 0 is the
    most frequent."""
    one_m_a = 1.0 - a
    top = (vocab + 1.0) ** one_m_a - 1.0
    r = (1.0 + u * top) ** (1.0 / one_m_a) - 1.0
    return torch.clamp(r.to(torch.int32), 0, vocab - 1)


def _step_seed(seed: int, step: int) -> int:
    """A 63-bit seed from (seed, step): splitmix64 of the pair."""
    z = ((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


class TokenPipeline:
    """``batch_at(step) -> {"tokens": (B, S) int64}`` on ``device``;
    labels are the tokens shifted by one inside the loss."""

    def __init__(self, cfg: TokenPipelineConfig, device):
        self.cfg = cfg
        self.device = torch.device(device)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(
            _step_seed(cfg.seed, step))
        u = torch.rand((B, S), generator=gen, device=dev)
        base = _zipf_inverse_cdf(u, V, cfg.zipf_a).long()
        # Repetition: with probability repeat_p, copy the token `lag` back.
        lag = torch.randint(1, cfg.repeat_window + 1, (B, S), generator=gen,
                            device=dev)
        do_rep = torch.rand((B, S), generator=gen, device=dev) < cfg.repeat_p
        pos = torch.arange(S, device=dev)[None, :]
        src = torch.clamp(pos - lag, min=0)
        copied = torch.gather(base, 1, src)
        return {"tokens": torch.where(do_rep & (pos > 0), copied, base)}
