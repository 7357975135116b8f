"""The readers of the program's stage counters: each reads its traced
CPU record, agrees with the harness's own timings where both measure the
same thing, and reads nothing from a program whose snapshot lacks the
counters."""
import pytest

from conftest import tiny_cell

from portbench import harness

STAGE_METRICS = {
    "synth-rw256-4M.mixed-c64": ("copy_ms.sat", "engine_ms.sat",
                                 "d2h_mb_per_req.sat", "reply_knn_ms.sat"),
    "rw-subseq-4M.mixed-c4": ("copy_ms.light", "reply_knn_ms.light",
                              "queue_ms.light", "reply_wait_ms.light"),
}


@pytest.mark.parametrize("name", sorted(STAGE_METRICS))
def test_stage_metrics_read_a_traced_cpu_record(name):
    cell = tiny_cell(name)
    mine = [m["name"] for m in cell["per_layer"]]
    assert set(STAGE_METRICS[name]) <= set(mine)
    rec = harness.run_cell(cell, 2 ** 31 + 77, 0.5, True, "cpu")
    assert rec["correct"]
    got = {m: harness.reader(m)(rec) for m in STAGE_METRICS[name]}
    assert all(v is not None and v > 0 for v in got.values()), got
    line = harness.result_line(cell, rec, True, {"name": "x",
                                                 "power_limit": "y"})
    assert set(STAGE_METRICS[name]) <= set(line["metrics"])
    # The stages inside the harness's timed calls sum to no more than them.
    before, after = rec["stats_before"], rec["stats_after"]

    def host(stage):
        return (after["stages"][stage]["host_s"]
                - before["stages"][stage]["host_s"])

    passes = rec["timing"]["dispatch"]
    replies = rec["timing"]["reply"]
    assert sum(host(s) for s in ("represent", "engine", "copy")) <= \
        sum(t1 - t0 for t0, t1, _ in passes)
    assert host("reply.knn") + host("reply.range") + host("postprocess") \
        <= sum(t1 - t0 for t0, t1 in replies)


def test_d2h_per_request_is_the_dense_copy():
    cell = tiny_cell("synth-rw256-4M.mixed-c64")
    rec = harness.run_cell(cell, 2 ** 31 + 78, 0.5, True, "cpu")

    def delta(key):
        return rec["stats_after"][key] - rec["stats_before"][key]

    qb = sum(q for _t0, _t1, q in rec["timing"]["dispatch"])
    rows = rec["n_rows"]
    # The pass's requests are recorded with its bytes, before its replies:
    # the last batch may not yet count as served when the window's
    # snapshot is taken, but its requests do.
    requests = delta("d2h_requests")
    assert delta("served") <= requests <= qb
    assert harness.reader("d2h_mb_per_req.sat")(rec) == pytest.approx(
        (qb * rows * 9 + qb) / 1e6 / requests, rel=1e-12)


@pytest.mark.parametrize("metric", sorted(
    {m.split(".")[0] for ms in STAGE_METRICS.values() for m in ms}))
def test_stage_readers_read_nothing_without_the_counters(metric):
    snap = {"served": 10, "batches": 2}
    rec = {"stats_before": dict(snap),
           "stats_after": {"served": 20, "batches": 3}}
    assert harness.reader(metric)(rec) is None
    assert harness.reader(metric)({"stats_before": None,
                                   "stats_after": None}) is None
