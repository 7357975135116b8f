"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, everything else as a run does it,
the service's device pass patched.  (The cells run on one card: there is
no exchange between cards to leave out.)"""
import numpy as np
import pytest

from conftest import tiny_cell

from portbench import harness

CELLS = ["synth-rw256-4M.mixed-c64", "rw-subseq-4M.mixed-c4"]


def _patch(monkeypatch, change):
    from repro_torch.serve import service

    real = service._SingleBackend.dispatch

    def dispatch(self, q, eps, is_knn, k, want_trace=False):
        idx, answer, d2 = real(self, q, eps, is_knn, k, want_trace)
        return change(q, eps, is_knn, k, idx, answer, d2,
                      lambda *a: real(self, *a))

    monkeypatch.setattr(service._SingleBackend, "dispatch", dispatch)


def _altered(q, eps, is_knn, k, idx, answer, d2, real):
    """Each query's nearest answer moved off by 0.05 in d²."""
    d2 = d2.copy()
    for i in range(d2.shape[0]):
        j = np.argmin(np.where(answer[i], d2[i], np.inf))
        d2[i, j] += 0.05
    return idx, answer, d2


def _half_left_out(q, eps, is_knn, k, idx, answer, d2, real):
    """Only the first half of the batch goes to the device; the second
    half is answered with the first half's answers."""
    h = max(1, q.shape[0] // 2)
    if q.shape[0] == 1:
        return idx, answer, d2
    i1, a1, d1 = real(q[:h], eps[:h], is_knn[:h], k, False)
    rep = np.arange(q.shape[0]) % h
    return i1[rep], a1[rep], d1[rep]


def _stale():
    """The first dispatch of each bucket's shape is served again for
    every later batch of that shape: a pass that returns its state
    unchanged."""
    seen = {}

    def change(q, eps, is_knn, k, idx, answer, d2, real):
        return seen.setdefault((q.shape, k), (idx, answer, d2))
    return change


FAULTS = {"answer_altered": lambda: _altered,
          "half_batch_left_out": lambda: _half_left_out,
          "state_unchanged": _stale}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    _patch(monkeypatch, FAULTS[fault]())
    rec = harness.run_cell(tiny_cell(name), 2 ** 31 + 99, 0.5, False, "cpu")
    assert not rec["correct"]
    c = rec["checks"]
    assert (c["d2_gap"]["value"] > c["d2_gap"]["limit"]
            or c["set_faults"]["value"] > 0)
