"""dispatch_ms (``.sat``, ``.light``): the mean device pass per batch, in
ms: the backend's ``dispatch`` (representation, kernels, the copy of the
answers to the host) timed by the harness around each call."""
from portbench.readers import timed


def read(rec):
    d = timed(rec, "dispatch")
    return sum(t1 - t0 for t0, t1, *_ in d) / len(d) * 1e3 if d else None
