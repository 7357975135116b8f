"""Small reductions the metric readers share (``metrics/<name>.py``).

A reader takes the run's record (see ``harness.run_cell``) and returns a
number, or None when the run holds nothing to read: the harness then
leaves the metric out of the result line.
"""
from __future__ import annotations

from . import tracelib


def timed(rec: dict, name: str) -> list:
    """The traced run's ``(t0, t1, ...)`` timings of ``name``
    (``dispatch`` or ``reply``), empty when there are none."""
    return list((rec.get("timing") or {}).get(name, ()))


def stats_delta(rec: dict, *path):
    """Change of one stats-snapshot counter across the run."""
    a, b = rec.get("stats_before"), rec.get("stats_after")
    if a is None or b is None:
        return None
    for key in path:
        a, b = a[key], b[key]
    return b - a


def idle_pct(rec: dict):
    """Share of the traced window in which no kernel, copy or memset ran
    on the card, in %."""
    prof = rec.get("profile")
    if not prof or not prof.get("device") or prof.get("window") is None:
        return None
    w = tracelib.window_s(prof)
    return 100.0 * (1.0 - tracelib.busy_s(prof) / w) if w > 0 else None
