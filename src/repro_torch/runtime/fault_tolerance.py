"""Fault tolerance: a step-time watchdog (straggler detection) and SIGTERM
preemption handling.

Counterpart of ``repro/runtime/fault_tolerance.py``, plain Python, copied:

  * **preemption** (SIGTERM): :class:`PreemptionHandler` sets a flag the
    serving launcher watches, and the service drains (accepted requests
    finish, new ones are shed) before the process exits;
  * **stragglers / hangs**: :class:`StepWatchdog` flags steps slower than
    ``slow_factor`` × the rolling median step time; the failover engine
    (``core/dist_search.FailoverShards``) keeps one per shard and sizes
    each shard's timeout from it.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import statistics
import threading
import time
from typing import Callable


@dataclasses.dataclass
class WatchdogEvent:
    step: int
    seconds: float
    median: float


class StepWatchdog:
    """Rolling-median step-time monitor.  Call ``tick()`` around steps."""

    def __init__(self, slow_factor: float = 3.0, window: int = 32,
                 on_slow: Callable[[WatchdogEvent], None] | None = None,
                 min_samples: int = 5):
        self.slow_factor = slow_factor
        self.window = collections.deque(maxlen=window)
        self.on_slow = on_slow
        self.min_samples = min_samples
        self.events: list[WatchdogEvent] = []
        self._t0 = None
        self._step = 0

    def start(self, step: int):
        self._step = step
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        if len(self.window) >= self.min_samples:
            med = statistics.median(self.window)
            if dt > self.slow_factor * med:
                ev = WatchdogEvent(self._step, dt, med)
                self.events.append(ev)
                if self.on_slow:
                    self.on_slow(ev)
        self.window.append(dt)
        return dt


class PreemptionHandler:
    """SIGTERM → set a flag the training loop checks each step; the loop
    checkpoints and exits cleanly.  Context-manager restores the previous
    handler."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = signals
        self.requested = threading.Event()
        self._prev = {}

    def __enter__(self):
        for sig in self.signals:
            self._prev[sig] = signal.signal(
                sig, lambda *_: self.requested.set())
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False

    @property
    def preempted(self) -> bool:
        return self.requested.is_set()
