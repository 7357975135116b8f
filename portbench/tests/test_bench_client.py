"""The time-boxed loops stop at the window's close and count what they
attempted and what failed; the open loop keeps its schedule."""
import threading
import time

import pytest

from portbench import arith
from portbench import datagen
from portbench.client import OK, run_closed_loop, run_open_loop


class _Req:
    def __init__(self, i, delay, status):
        self.i, self.status, self.ids, self.distances = i, status, [i], [0.0]
        self._done = threading.Event()
        threading.Timer(delay, self._done.set).start()

    def wait(self, timeout):
        if not self._done.wait(timeout):
            raise TimeoutError
        if self.status == "failed":
            raise RuntimeError("dispatch failed")
        return self.status


def test_stops_at_the_close_and_counts():
    seen = []

    def submit(i):
        seen.append(i)
        return _Req(i, 0.01, "failed" if i % 10 == 3 else OK)

    t0 = time.perf_counter()
    loop = run_closed_loop(submit, clients=4, seconds=0.5, grace_s=5.0)
    wall = time.perf_counter() - t0
    # The close, then the last replies (10 ms each, slower on a loaded
    # host): no wait for the 5 s grace.
    assert 0.5 <= wall < 2.0
    assert loop.unrecorded == 0
    assert arith.attempted(loop) == len(seen) > 20
    assert sorted(o.index for o in loop.outcomes) == sorted(seen)
    assert arith.failed(loop) == sum(1 for i in seen if i % 10 == 3)
    # No request is submitted after the close.
    assert max(o.t_submit for o in loop.outcomes) < loop.t_end


def test_in_flight_requests_are_waited_for_and_timed():
    loop = run_closed_loop(lambda i: _Req(i, 0.3, OK), clients=2,
                           seconds=0.1, grace_s=5.0)
    assert arith.attempted(loop) == 2
    assert all(o.status == OK and o.latency_s >= 0.3 for o in loop.outcomes)
    # Answered after the close: not in the window's rate.
    assert arith.served_in_window(loop) == 0


def test_a_request_never_answered_is_a_failure():
    loop = run_closed_loop(lambda i: _Req(i, 10.0, OK), clients=1,
                           seconds=0.05, grace_s=0.2)
    assert arith.failed(loop) >= 1
    assert loop.outcomes[0].status == "timeout"


def test_open_loop_keeps_its_schedule_and_times_from_it():
    offsets = datagen.arrivals(40.0, 0.5)
    assert len(offsets) == 20 and offsets[1] == pytest.approx(0.025)
    loop = run_open_loop(lambda i: _Req(i, 0.05 if i == 3 else 0.001,
                                        "failed" if i == 5 else OK),
                         offsets, seconds=0.5, grace_s=5.0)
    assert loop.unrecorded == 0
    assert sorted(o.index for o in loop.outcomes) == list(range(20))
    assert arith.failed(loop) == 1
    for o in loop.outcomes:
        # Timed from the scheduled arrival, never before it.
        assert o.t_submit == pytest.approx(loop.t0 + offsets[o.index])
        assert o.latency_s >= 0
    slow = next(o for o in loop.outcomes if o.index == 3)
    assert slow.latency_s >= 0.05


def test_open_loop_sends_nothing_after_the_close():
    loop = run_open_loop(lambda i: _Req(i, 0.3, OK), [0.0, 0.05, 0.2],
                         seconds=0.1, grace_s=5.0)
    assert [o.index for o in loop.outcomes] == [0, 1]
    assert arith.served_in_window(loop) == 0
    loop = run_open_loop(lambda i: _Req(i, 10.0, OK), [0.0], seconds=0.05,
                         grace_s=0.2)
    assert arith.failed(loop) == 1 and loop.outcomes[0].status == "timeout"


def test_arrivals_keep_the_cadence():
    a = datagen.arrivals(20.0, 30.0)
    assert len(a) == 600 and a[0] == 0.0 and a[-1] < 30.0
    assert all(b - x == pytest.approx(0.05) for x, b in zip(a, a[1:]))
