"""The command line: no card means no result and a nonzero exit; the
traced path's record on the CPU; on the card (``gpu``) a tiny cell."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO, tiny_cell

from portbench import harness


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "synth-rw256-4M.mixed-c64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (REPO / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [sys.executable, str(tmp_path / "portbench" / "run.py"),
         "--workload", "synth-rw256-4M.mixed-c64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_traced_record_on_the_cpu():
    cell = tiny_cell("synth-rw256-4M.mixed-c64")
    rec = harness.run_cell(cell, 5, 0.5, True, "cpu")
    assert rec["correct"]
    got = {m["name"]: harness.reader(m["name"])(rec)
           for m in cell["per_layer"]}
    assert got["batch_mean"] >= 1 and got["dispatch_ms.sat"] > 0
    assert got["reply_ms.sat"] > 0
    assert 0 < got["pruned_pct"] < 100
    # No card in the trace: the device's metrics read nothing.
    assert got["engine_roofline_pct"] is None
    assert got["device_idle_pct.sat"] is None
    # Every device pass of the window timed, and the service untraced:
    # no counting pass ran in it.
    assert len(rec["timing"]["dispatch"]) == \
        rec["stats_after"]["batches"] - rec["stats_before"]["batches"]
    assert rec["stats_after"]["cascade"] == rec["stats_before"]["cascade"]
    assert rec["cascade"]["rows_screened"] > 0


def test_result_line_keys():
    cell = tiny_cell("rw-subseq-4M.mixed-c4")
    rec = harness.run_cell(cell, 6, 0.5, False, "cpu")
    line = harness.result_line(cell, rec, False, {"name": "x",
                                                  "power_limit": "y"})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"p95_ms", "setup_s"}
    json.dumps(line)


@pytest.mark.gpu
def test_tiny_cells_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in ("synth-rw256-4M.mixed-c64", "rw-subseq-4M.mixed-c4"):
        cell = tiny_cell(name)
        rec = harness.run_cell(cell, 2 ** 31 + 3, 2.0, True, "cuda")
        assert rec["correct"], rec["checks"]
        assert harness.reader("peak_gib")(rec) > 0
