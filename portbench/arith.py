"""The arithmetic of the end-to-end numbers, on the client's records."""
from __future__ import annotations

import math

from .client import OK


def percentile(values, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between the sorted
    values (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * float(q) / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def served_in_window(loop) -> int:
    """Requests answered OK by the close of the window."""
    return sum(1 for o in loop.outcomes
               if o.status == OK and o.t_done <= loop.t_end)


def qps(loop) -> float:
    """Requests answered OK in the window over the window's seconds."""
    return served_in_window(loop) / loop.seconds


def latencies_ms(loop) -> list:
    """Submit-to-reply milliseconds of every request submitted in the
    window and answered OK, those still in flight at the close included
    (their wait counts)."""
    return [o.latency_s * 1e3 for o in loop.outcomes if o.status == OK]


def attempted(loop) -> int:
    return len(loop.outcomes)


def failed(loop) -> int:
    """Requests that were refused, failed or never answered."""
    return sum(1 for o in loop.outcomes if o.status != OK) \
        + loop.unrecorded
