"""Collective traffic of the mesh, for the roofline.

Counterpart of ``repro/runtime/hlo.py``.  The reference parses XLA's
compiled HLO text for its collectives; PyTorch makes no such text, so
here the mesh's own operations (``runtime.sharding.gather``, its
backward, and ``psum``) record what they move while a
:func:`recording` block is open.  Each call adds its result's bytes,
times the devices that receive it, weighted by the same ring-traffic
factors:

  all-gather         : result bytes        (each device receives ≈ it)
  reduce-scatter     : result bytes        (the gradient each device sums)
  all-reduce         : 2 × result bytes    (ring RS + AG)
  all-to-all         : result bytes
  collective-permute : result bytes

So ``total_bytes`` is the link traffic summed over the devices; over
the device count it is the reference's per-chip figure.  On one card the shards' "collectives" are copies in
HBM (or no copy at all when the blocks already share the device).

:func:`count_op` counts an aten operation in a trace: a list of op
names, as ``runtime.op_cost`` records them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

_WEIGHTS = {
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    counts_by_kind: dict = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))

    def summary(self) -> dict:
        return {"total_bytes": self.total_bytes,
                "by_kind": dict(self.bytes_by_kind),
                "counts": dict(self.counts_by_kind)}


_ACTIVE: list = []


@contextlib.contextmanager
def recording():
    """Collect the collectives issued inside the block into the
    :class:`CollectiveStats` it yields (blocks may nest)."""
    stats = CollectiveStats(defaultdict(float), defaultdict(int))
    _ACTIVE.append(stats)
    try:
        yield stats
    finally:
        del _ACTIVE[next(i for i, s in enumerate(_ACTIVE) if s is stats)]
        stats.bytes_by_kind = dict(stats.bytes_by_kind)
        stats.counts_by_kind = dict(stats.counts_by_kind)


def record(kind: str, result, receivers: int) -> None:
    """One collective of ``kind`` whose ``result`` (a tensor) reaches
    ``receivers`` devices.  A no-op outside :func:`recording`."""
    if not _ACTIVE:
        return
    nbytes = result.numel() * result.element_size()
    for stats in _ACTIVE:
        stats.bytes_by_kind[kind] += _WEIGHTS[kind] * nbytes * receivers
        stats.counts_by_kind[kind] += 1


def count_op(trace, opname: str) -> int:
    """How many times aten op ``opname`` (``"mm"`` or ``"aten.mm"``)
    appears in ``trace``."""
    name = opname.removeprefix("aten.")
    return sum(1 for op in trace if op.removeprefix("aten.")
               .split(".")[0] == name)
