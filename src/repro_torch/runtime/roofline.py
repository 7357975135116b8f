"""Three-term roofline model for the NVIDIA H100 SXM (the port's card).

Counterpart of ``repro/runtime/roofline.py``, whose peaks are a TPU
v5e's; these are the H100 SXM's, from NVIDIA's H100 datasheet:

    compute    = FLOPs            / (devices × 989e12 FLOP/s dense bf16)
    memory     = bytes            / (devices × 3.35e12 B/s HBM3)
    collective = collective_bytes / (devices × 450e9 B/s NVLink 4,
                                     per direction)

989 TFLOP/s is the dense bf16 tensor-core peak PERF.md §2 uses; 67
TFLOP/s is the float32 peak outside the tensor cores, which the search
cost model prices its f32 work at (``core/cost_model.py``; pass it as
``peak_flops``).  FLOPs and bytes come from ``runtime.op_cost``
(per device: the global figure over the device count), collective bytes
from ``runtime.collectives``.  On one card the mesh's shards share its
HBM, so their "collectives" are copies in HBM (or none): the link term
prices a mesh of cards, not the one-card run.  MODEL_FLOPS = 6·N·D
(dense) / 6·N_active·D (MoE) gives the useful-compute ratio.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12        # dense bf16 per card (tensor cores)
PEAK_FLOPS_F32 = 67e12     # float32 per card, outside the tensor cores
HBM_BW = 3.35e12           # bytes/s per card (HBM3)
LINK_BW = 450e9            # bytes/s per card per direction (NVLink 4)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    chips: int
    model_flops: float = 0.0
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / bound time."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops / (self.chips * self.peak_flops)) / \
            self.bound_s

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def terms_from_analysis(cost: dict, collective_bytes: float,
                        chips: int, model_flops: float = 0.0,
                        peak_flops: float = PEAK_FLOPS) -> RooflineTerms:
    """``cost`` holds the PER-DEVICE ``flops`` and ``bytes accessed``, and
    ``collective_bytes`` is the per-device link traffic.  Multiplying back
    by ``chips`` gives the global figures: global_flops / (chips × peak)
    == per_device_flops / peak."""
    flops = float(cost.get("flops", 0.0))
    b = float(cost.get("bytes accessed", 0.0))
    return RooflineTerms(
        compute_s=flops / peak_flops,
        memory_s=b / HBM_BW,
        collective_s=collective_bytes / LINK_BW,
        hlo_flops=flops * chips,           # global, for the useful ratio
        hlo_bytes=b * chips,
        collective_bytes=collective_bytes, chips=chips,
        model_flops=model_flops, peak_flops=peak_flops)


def model_flops_train(cfg, n_tokens: int) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) for one training step."""
    return 6.0 * cfg.active_param_count() * n_tokens


def model_flops_decode(cfg, n_tokens: int) -> float:
    """2·N_active per generated token (forward only)."""
    return 2.0 * cfg.active_param_count() * n_tokens


def model_flops_prefill(cfg, n_tokens: int) -> float:
    return 2.0 * cfg.active_param_count() * n_tokens
