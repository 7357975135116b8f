"""Structured tracing: a bounded span ring with JSONL / Chrome export.

Counterpart of ``repro/obs/spans.py``.  A :class:`SpanRecorder` is a
fixed-capacity ring of closed spans, ``(name, t0, t1, attrs)`` on the
``time.perf_counter`` clock, the clock the service stamps
``Request.t_submit`` with, so service spans join the load generator's
per-request JSONL without a clock translation.  Memory is bounded by
``capacity`` whatever the uptime, recording is an O(1) append under a
lock, and nothing here touches a device (no sync on the hot path).

Exports:

  * :meth:`SpanRecorder.to_jsonl`: one span per line;
  * :meth:`SpanRecorder.to_chrome_trace`: the Chrome trace-event JSON
    array (``ph: "X"`` complete events, microsecond timestamps);
  * :func:`profiler_capture`: the opt-in ``torch.profiler`` capture the
    service wraps around each dispatch when a profile directory is set
    (the device's kernels and copies, which the host spans cannot see).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import pathlib
import threading
import time


@dataclasses.dataclass
class Span:
    name: str
    t0: float             # time.perf_counter seconds
    t1: float
    attrs: dict

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "duration_ms": self.duration_ms, **self.attrs}


class SpanRecorder:
    """Bounded in-memory ring of closed spans (thread-safe)."""

    def __init__(self, capacity: int = 4096):
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._recorded = 0          # total ever recorded (the ring drops)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    @property
    def recorded(self) -> int:
        return self._recorded

    def __len__(self) -> int:
        return len(self._ring)

    def record(self, name: str, t0: float, t1: float, **attrs) -> None:
        with self._lock:
            self._ring.append(Span(name, float(t0), float(t1), attrs))
            self._recorded += 1

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a block on the recorder's clock and record it on exit."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, t0, time.perf_counter(), **attrs)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def counts(self) -> dict:
        """Spans per name currently in the ring (the metrics surface)."""
        out: dict = {}
        for s in self.snapshot():
            out[s.name] = out.get(s.name, 0) + 1
        return out

    def to_jsonl(self, path) -> int:
        spans = self.snapshot()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s.as_dict(), sort_keys=True) + "\n")
        return len(spans)

    def to_chrome_trace(self, path) -> int:
        """Chrome trace-event 'X' (complete) events, ts / dur in µs; one
        thread id per span name, so each stage gets its own track."""
        spans = self.snapshot()
        tids = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s.name, len(tids))
            events.append({
                "name": s.name, "ph": "X", "pid": 0, "tid": tid,
                "ts": s.t0 * 1e6, "dur": (s.t1 - s.t0) * 1e6,
                "args": s.attrs,
            })
        with open(path, "w") as f:
            json.dump(events, f)
        return len(events)


_CAPTURES = itertools.count()


def _activities(device) -> list:
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


def prepare_profiler(device=None) -> None:
    """Start and stop one empty ``torch.profiler`` session on the calling
    thread.  The profiler's backend (Kineto) binds its client to the
    thread of a process's first session and reports an error when that
    session runs on another thread than the one it was registered from;
    a service that captures on its dispatcher thread calls this from the
    thread that builds it, before the dispatcher starts."""
    import torch

    with torch.profiler.profile(activities=_activities(device)):
        pass


@contextlib.contextmanager
def profiler_capture(logdir, device=None):
    """Opt-in ``torch.profiler`` capture around a block (a dispatch).

    A no-op when ``logdir`` is falsy, so call sites need no branch.
    Otherwise it records the host's operators and, when ``device`` is a
    CUDA device, the card's kernels and copies (CUPTI), and writes one
    Chrome trace per capture into ``logdir``
    (``dispatch_<pid>_<n>.json``).  torch is imported only when a
    capture is made."""
    if not logdir:
        yield
        return
    import torch

    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=_activities(device)) as prof:
        yield
    prof.export_chrome_trace(
        str(out / f"dispatch_{os.getpid()}_{next(_CAPTURES):05d}.json"))
