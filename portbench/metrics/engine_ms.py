"""engine_ms (``.sat``): the device time of a device pass's engine, per
pass, in ms: the program's ``engine`` stage (CUDA events around
``mixed_query_fused``, up to the copy: the kernels, the torch ops and the
gaps between their launches), from the deltas of the service's stats
snapshot.  None for a program without stage counters."""
from portbench.readers import stats_delta


def read(rec):
    try:
        s = stats_delta(rec, "stages", "engine", "device_s")
        n = stats_delta(rec, "stages", "engine", "count")
    except KeyError:
        return None
    return s / n * 1e3 if n else None
