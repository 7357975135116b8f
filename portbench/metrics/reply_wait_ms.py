"""reply_wait_ms (``.light``): a request's wait from the end of its device
pass to the start of its own reply (the replies of the requests before it
in the batch), per request, in ms: the program's ``reply_wait`` stage,
from the deltas of the service's stats snapshot.  None for a program
without stage counters."""
from portbench.readers import stats_delta


def read(rec):
    try:
        s = stats_delta(rec, "stages", "reply_wait", "host_s")
        n = stats_delta(rec, "stages", "reply_wait", "count")
    except KeyError:
        return None
    return s / n * 1e3 if n else None
