"""The time-boxed load: the client layer.

Two loops, chosen by a traffic file's ``loop``:

  * :func:`run_closed_loop` (``"closed"``), rewritten after
    ``src/repro_torch/serve/loadgen.py::run_closed_loop``, which fires a
    fixed count of requests from a thread per client: ``clients``
    requests kept in flight (a reply, then that caller's next request)
    until the window closes, by one thread.  A request is timed from just
    before its submit.
  * :func:`run_open_loop` (``"open"``): requests arrive at fixed offsets
    from the window's start (``datagen.arrivals``), whatever the replies
    do.  A request is timed from its scheduled arrival, so a late submit
    counts against the latency instead of hiding it.

In both, no request is submitted after the window of ``seconds`` closes,
and each one in flight then is waited for, up to ``grace_s`` past the
close; every time is on the client's clock (``time.perf_counter``).
"""
from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Callable

OK = "ok"


@dataclasses.dataclass
class Outcome:
    index: int            # position in the request stream
    t_submit: float       # time.perf_counter seconds: the submit (closed)
    #                       or the scheduled arrival (open)
    t_done: float
    status: str           # the request's terminal status, "timeout" or
    #                       "failed"
    ids: object = None
    distances: object = None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclasses.dataclass
class LoopResult:
    t0: float
    t_end: float
    seconds: float
    outcomes: list        # Outcome, in completion order
    unrecorded: int       # requests sent but never recorded (an open
    #                       loop's collector still waiting past the grace)


def run_closed_loop(submit: Callable, clients: int, seconds: float,
                    grace_s: float = 60.0) -> LoopResult:
    """Keep ``clients`` requests in flight for ``seconds``: each reply is
    followed at once by the next request, as ``clients`` callers that
    each wait for their reply would send it.

    ``submit(i)`` sends request ``i`` of the stream (0, 1, 2, ... in
    submit order) and returns an object with ``wait(timeout) -> status``,
    ``ids`` and ``distances``; a submit or a wait that raises counts as a
    failed request.  One thread drives every caller: it waits for the
    oldest request in flight, which is the next the service answers (one
    dispatcher, batches drained from the queue's head, replies in batch
    order), and sends that caller's next one.  A reply that came before
    an older one would be timed when its turn came, never too early."""
    in_flight: collections.deque = collections.deque()
    outcomes: list = []
    t0 = time.perf_counter()
    t_end = t0 + float(seconds)
    cursor = 0

    def send():
        nonlocal cursor
        ts = time.perf_counter()
        try:
            req = submit(cursor)
        except Exception:       # noqa: BLE001 — recorded as failed below
            req = None
        in_flight.append((cursor, ts, req))
        cursor += 1

    for _ in range(max(1, int(clients))):
        send()
    while in_flight:
        i, ts, req = in_flight.popleft()
        outcomes.append(_wait(i, ts, req, t_end + grace_s))
        if time.perf_counter() < t_end:
            send()
    return LoopResult(t0=t0, t_end=t_end, seconds=float(seconds),
                      outcomes=outcomes, unrecorded=0)


def _wait(i: int, ts: float, req, deadline: float) -> Outcome:
    """Wait for request ``i`` (sent or due at ``ts``) until ``deadline``
    and record it; ``req`` None is a submit that raised."""
    try:
        if req is None:
            raise RuntimeError("submit failed")
        status = req.wait(max(0.0, deadline - time.perf_counter()))
    except TimeoutError:
        status = "timeout"
    except Exception:   # noqa: BLE001 — a failed request is a record
        status = "failed"
    return Outcome(i, ts, time.perf_counter(), str(status),
                   getattr(req, "ids", None), getattr(req, "distances", None))


def run_open_loop(submit: Callable, offsets, seconds: float,
                  grace_s: float = 60.0) -> LoopResult:
    """Submit request ``i`` at ``offsets[i]`` seconds into the window, for
    every offset before its close, from the calling thread.

    ``submit`` is as in :func:`run_closed_loop`.  One collector thread
    waits for the requests in the order they were sent, as the closed
    loop does."""
    pending: queue.Queue = queue.Queue()
    outcomes: list = []
    t0 = time.perf_counter()
    t_end = t0 + float(seconds)

    def collect():
        while True:
            item = pending.get()
            if item is None:
                return
            outcomes.append(_wait(*item, t_end + grace_s))

    sent = 0
    collector = threading.Thread(target=collect, name="portbench-collector",
                                 daemon=True)
    collector.start()
    for i, off in enumerate(offsets):
        ts = t0 + float(off)
        if ts >= t_end:
            break
        delay = ts - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        try:
            req = submit(i)
        except Exception:       # noqa: BLE001 — counted by the collector
            req = None
        pending.put((i, ts, req))
        sent += 1
    pending.put(None)
    collector.join(timeout=max(0.0, t_end + grace_s + 5.0
                               - time.perf_counter()))
    done = list(outcomes)
    return LoopResult(t0=t0, t_end=t_end, seconds=float(seconds),
                      outcomes=done, unrecorded=sent - len(done))
