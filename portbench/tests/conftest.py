"""Shared helpers of the benchmark's CPU tests: the repo's ``src`` and
root on ``sys.path``, and a tiny cell built from a real one."""
import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(name: str, clients: int = 8, requests: int = 64) -> dict:
    """The cell ``name`` of BENCHMARK.json cut to a size the CPU runs in
    a second: 4,096 rows, or 2 streams of 2,175 samples (4,096 windows);
    at most ``clients`` closed-loop clients, or an open loop at 40
    requests a second."""
    from portbench import harness

    cell = harness.resolve(name, harness.manifest())
    if cell["config"]["kind"] == "subsequence":
        cell["config"].update(streams=2, stream_len=2048 + 127)
    else:
        cell["config"].update(rows=4096)
    t = cell["traffic"]
    if t["loop"] == "closed":
        t.update(clients=min(clients, t["clients"]))
    else:
        t.update(rate=40.0)
    t.update(requests=requests)
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
