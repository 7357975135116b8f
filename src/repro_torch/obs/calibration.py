"""Cost-model calibration residuals: predicted against measured dispatch
time.

Counterpart of ``repro/obs/calibration.py``.  Every traced serving
dispatch becomes a calibration sample: the backend hands over the cost
model's estimate (``core/cost_model.fused_pass_estimate``: ``t_est_s``
and the ``bytes_hbm`` / ``flops`` it was derived from) and the measured
wall time of the dispatch, and the log derives

  * the signed relative residual ``(measured − predicted) / measured``,
  * the roofline share: the estimate's bytes and FLOPs priced at the
    H100's peaks (:func:`h100_bound_s`) over the measured time.

The measured time is the dispatch's ``engine`` stage (``serve.stats``):
on a card its device time from CUDA events, the stream's time from the
engine's first launch to the copy (its kernels, its torch ops and the
gaps between their launches), without the query representation, a
traced dispatch's counting pass, the device-to-host copy of the answers
or the sync; a backend without stages hands over its whole dispatch's
wall time.  Memory is bounded (a
fixed-capacity ring); recording is host arithmetic only.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading

from ..core.cost_model import F32_TFLOPS


@dataclasses.dataclass
class DispatchRecord:
    """One dispatch's calibration sample (all derived fields host floats)."""

    batch: int              # queries in the dispatched batch
    k: int                  # k bucket
    backend: str
    measured_s: float
    predicted_s: float      # cost model t_est_s (0.0 when unavailable)
    bytes_hbm: float
    flops: float
    rel_err: float          # (measured - predicted) / measured
    bound_s: float          # roofline bound of the modelled work
    roofline_frac: float    # bound_s / measured_s  (≤ 1; 1 is ideal)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def h100_bound_s(flops: float, bytes_hbm: float) -> float:
    """The least time one H100 SXM could take for the work, priced
    through the three-term roofline (``runtime.roofline.
    terms_from_analysis``, one card, no collectives on the single-card
    dispatch path) as the reference's ``_roofline_bound_s`` does: FLOPs
    over the float32 peak outside the tensor cores (67 TFLOP/s, the
    search's f32 work) or bytes over HBM3's 3.35 TB/s, whichever is
    larger (the peaks of ``core/cost_model.py``)."""
    from ..runtime.roofline import terms_from_analysis

    return terms_from_analysis(
        {"flops": float(flops), "bytes accessed": float(bytes_hbm)},
        collective_bytes=0.0, chips=1, model_flops=float(flops),
        peak_flops=F32_TFLOPS * 1e12).bound_s


class CalibrationLog:
    """Bounded, thread-safe log of :class:`DispatchRecord` samples."""

    def __init__(self, capacity: int = 2048):
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._recorded = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    @property
    def recorded(self) -> int:
        return self._recorded

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, *, batch: int, k: int, backend: str,
               measured_s: float, estimate: dict | None) -> DispatchRecord:
        est = estimate or {}
        predicted = float(est.get("t_est_s", 0.0))
        measured = max(float(measured_s), 1e-12)
        flops = float(est.get("flops", 0.0))
        bytes_hbm = float(est.get("bytes_hbm", 0.0))
        bound = h100_bound_s(flops, bytes_hbm) if est else 0.0
        rec = DispatchRecord(
            batch=int(batch), k=int(k), backend=str(backend),
            measured_s=measured, predicted_s=predicted, bytes_hbm=bytes_hbm,
            flops=flops, rel_err=(measured - predicted) / measured,
            bound_s=bound, roofline_frac=bound / measured)
        with self._lock:
            self._ring.append(rec)
            self._recorded += 1
        return rec

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def summary(self) -> dict:
        """Aggregates for the metrics surface; clean zeros when empty."""
        recs = self.snapshot()
        if not recs:
            return {"n": 0, "mean_abs_rel_err": 0.0, "mean_rel_err": 0.0,
                    "mean_roofline_frac": 0.0, "mean_measured_s": 0.0,
                    "mean_predicted_s": 0.0}
        n = len(recs)
        return {
            "n": n,
            "mean_abs_rel_err": sum(abs(r.rel_err) for r in recs) / n,
            "mean_rel_err": sum(r.rel_err for r in recs) / n,
            "mean_roofline_frac": sum(r.roofline_frac for r in recs) / n,
            "mean_measured_s": sum(r.measured_s for r in recs) / n,
            "mean_predicted_s": sum(r.predicted_s for r in recs) / n,
        }

    def to_jsonl(self, path) -> int:
        recs = self.snapshot()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r.as_dict(), sort_keys=True) + "\n")
        return len(recs)
