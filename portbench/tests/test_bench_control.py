"""The check's control at a size a test run holds: the reference in
TF32, put in the program's place, comes out not correct on every cell
while the program comes out correct."""
import pytest

from conftest import tiny_cell

from portbench import control, harness

CELLS = ["synth-rw256-4M.mixed-c64", "rw-subseq-4M.mixed-c4"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5])
def test_control_is_not_correct(name, seed):
    got = control.control_readings(tiny_cell(name), seed, 200, "cpu")
    assert not got["correct"]
    c = got["checks"]
    assert c["d2_gap"]["value"] > 3 * c["d2_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    rec = harness.run_cell(tiny_cell(name), 2 ** 31 + 77, 0.5, False, "cpu")
    assert rec["correct"], rec["checks"]
    assert rec["checks"]["d2_gap"]["value"] < \
        rec["checks"]["d2_gap"]["limit"] / 10
