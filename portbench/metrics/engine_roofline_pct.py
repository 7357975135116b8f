"""engine_roofline_pct: the least time the window's device passes need
(``portbench/roofline.py``: the database read once a pass, the queries,
an id and a d² per answer served; or the level-0 test's float32
operations), over the device time of every kernel launched inside the
backend's ``dispatch`` calls (copies left out), in %."""
from portbench import roofline, tracelib
from portbench.client import OK
from portbench.readers import timed


def read(rec):
    prof = rec.get("profile")
    passes = timed(rec, "dispatch")
    if not prof or not prof.get("device") or not passes:
        return None
    kernels, _lost = tracelib.engine_kernels(prof, passes)
    busy = sum(b - a for a, b, *_ in kernels)
    if busy <= 0:
        return None
    answers = sum(len(o.ids) for o in rec["loop"].outcomes
                  if o.status == OK and o.ids is not None)
    nbytes, flops = roofline.window_work(
        rec["n_rows"], rec["n"], rec["config"]["levels"],
        [q for _t0, _t1, q in passes], answers)
    t, _which = roofline.bound_s(nbytes, flops,
                                 roofline.peaks_for(rec["device_name"]))
    return 100.0 * t / busy
