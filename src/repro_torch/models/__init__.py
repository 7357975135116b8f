"""The LM model stack, counterpart of ``repro/models``: ``layers``
(norms, RoPE, attention, MLPs), ``ssm`` (Mamba2), ``moe`` (mixture of
experts) and ``transformer`` (the ten architectures' serving path)."""
