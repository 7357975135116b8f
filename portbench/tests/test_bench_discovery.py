"""A cell, a traffic and a metric added as files alone are found by
name: the harness needs no edit for them."""
import json
import shutil

import pytest

from conftest import REPO

from portbench import harness


def test_tiny_cell_added_as_files_only(tmp_path):
    root = tmp_path / "portbench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(REPO / "portbench" / sub, root / sub)
    cfg = json.loads((root / "configs" / "synth-rw256-4M.json").read_text())
    cfg.update(name="synth-tiny", rows=2048, length=64)
    (root / "configs" / "synth-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "workloads" / "rw-subseq-4M.mixed-c4.json")
                         .read_text())
    # An open loop, which no cell of BENCHMARK.json runs yet: data alone.
    traffic.update(name="synth-tiny.c2", config="synth-tiny", loop="open",
                   rate=40.0, requests=16, k=3)
    (root / "workloads" / "synth-tiny.c2.json").write_text(
        json.dumps(traffic))
    (root / "metrics" / "answered.py").write_text(
        "def read(rec):\n    return float(len(rec['loop'].outcomes))\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "synth-tiny.c2",
                               "config": "synth-tiny", "traffic": "c2",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "answered", "unit": "req",
                               "better": "higher", "source": "host_clock",
                               "layer": "client", "moves": "setup_s",
                               "workloads": ["synth-tiny.c2"]})
    cell = harness.resolve("synth-tiny.c2", bench, root=root)
    assert cell["config"]["rows"] == 2048
    assert [m["name"] for m in cell["per_layer"]] == ["answered"]
    assert {m["name"] for m in cell["end_to_end"]} == {"peak_gib",
                                                       "setup_s"}
    rec = harness.run_cell(cell, 2 ** 31 + 12345, 0.5, False, "cpu")
    assert rec["correct"]
    read = harness.reader("answered", root=root)
    assert read(rec) == len(rec["loop"].outcomes) > 0


def test_unknown_cell_is_refused():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    try:
        harness.resolve("no-such-cell", bench)
    except harness.RunError:
        return
    raise AssertionError("an unknown cell resolved")


def test_a_loop_the_harness_does_not_run_is_refused(tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench" / "configs", root / "configs")
    (root / "workloads").mkdir()
    traffic = json.loads((REPO / "portbench" / "workloads"
                          / "rw-subseq-4M.mixed-c4.json").read_text())
    traffic["loop"] = "replay"
    (root / "workloads" / "rw-subseq-4M.mixed-c4.json").write_text(
        json.dumps(traffic))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    try:
        harness.resolve("rw-subseq-4M.mixed-c4", bench, root=root)
    except harness.RunError as e:
        assert "replay" in str(e)
        return
    raise AssertionError("an unknown loop resolved")


def test_suffixed_metrics_share_their_base_reader():
    rec = {"timing": {"dispatch": [(0.0, 0.5, 32), (1.0, 1.25, 16)],
                      "reply": [(0.5, 0.6), (0.6, 1.0), (1.25, 1.5)]}}
    for suffix in ("sat", "light"):
        assert harness.reader(f"dispatch_ms.{suffix}")(rec) == 375.0
        assert harness.reader(f"reply_ms.{suffix}")(rec) == \
            pytest.approx(375.0)
