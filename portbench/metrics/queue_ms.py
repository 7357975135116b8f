"""queue_ms (``.light``): a request's wait in the service's queue, from its
submit to its batch's formation, per request, in ms: the program's
``queue`` stage, from the deltas of the service's stats snapshot.  None
for a program without stage counters."""
from portbench.readers import stats_delta


def read(rec):
    try:
        s = stats_delta(rec, "stages", "queue", "host_s")
        n = stats_delta(rec, "stages", "queue", "count")
    except KeyError:
        return None
    return s / n * 1e3 if n else None
