"""reply_ms (``.sat``, ``.light``): the host's reply per batch, in ms: the
service's ``_finish`` of every request, timed by the harness around each
call, summed over the window and divided by its device passes."""
from portbench.readers import timed


def read(rec):
    d, r = timed(rec, "dispatch"), timed(rec, "reply")
    return sum(t1 - t0 for t0, t1 in r) / len(d) * 1e3 if d and r else None
