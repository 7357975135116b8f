"""BENCHMARK.json against the contract's shape, and every name it gives
found as a file."""
import json
import re

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["command"][:2] == ["python3", "portbench/run.py"]


def test_names_units_and_bounds():
    b = _bench()
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"]


def test_every_cell_reports_what_it_must():
    b = _bench()
    for w in b["workloads"]:
        def mine(ms):
            return [m for m in ms if w["name"] in m.get("workloads",
                                                        [w["name"]])]
        e2e = [m["name"] for m in mine(b["end_to_end"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mine(b["per_layer"])
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


def test_files_behind_every_name():
    b = _bench()
    root = REPO / "portbench"
    for c in b["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        traffic = json.loads((root / "workloads" / f"{w['name']}.json")
                             .read_text())
        assert traffic["config"] == w["config"]
        assert traffic["traffic"] == w["traffic"]
    for m in b["end_to_end"] + b["per_layer"]:
        # Its own file, or the file of the name before its first dot.
        assert any((root / "metrics" / f"{stem}.py").is_file()
                   for stem in (m["name"], m["name"].split(".")[0])), \
            m["name"]
