"""The p95 and qps arithmetic on synthetic records."""
import numpy as np
import pytest

from portbench import arith
from portbench.client import OK, LoopResult, Outcome


def _loop(latencies, t_end=10.0, seconds=10.0):
    outs = [Outcome(i, 1.0, 1.0 + lat, OK) for i, lat in
            enumerate(latencies)]
    return LoopResult(t0=0.0, t_end=t_end, seconds=seconds, outcomes=outs,
                      unrecorded=0)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentile_matches_numpy(n):
    xs = np.random.default_rng(n).exponential(size=n)
    for q in (50, 95, 99):
        assert arith.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_p95_of_a_latency_list():
    loop = _loop([i / 1000 for i in range(1, 101)])     # 1 .. 100 ms
    lat = arith.latencies_ms(loop)
    assert arith.percentile(lat, 95) == pytest.approx(95.05)


def test_qps_counts_only_answers_inside_the_window():
    lat = [0.5] * 30 + [9.5] * 5                         # done at 1.5, 10.5
    loop = _loop(lat, t_end=10.0, seconds=10.0)
    assert arith.served_in_window(loop) == 30
    assert arith.qps(loop) == pytest.approx(3.0)
    assert arith.attempted(loop) == 35
    assert len(arith.latencies_ms(loop)) == 35          # late, not lost
    loop.outcomes.append(Outcome(99, 2.0, 3.0, "failed"))
    assert arith.failed(loop) == 1
    assert arith.qps(loop) == pytest.approx(3.0)
