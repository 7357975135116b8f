"""copy_ms (``.sat``, ``.light``): the device time of the copy of a device
pass's answers to the host, per pass, in ms: the program's ``copy`` stage
(CUDA events around ``_to_host``), from the deltas of the service's stats
snapshot.  None for a program without stage counters."""
from portbench.readers import stats_delta


def read(rec):
    try:
        s = stats_delta(rec, "stages", "copy", "device_s")
        n = stats_delta(rec, "stages", "copy", "count")
    except KeyError:
        return None
    return s / n * 1e3 if n else None
