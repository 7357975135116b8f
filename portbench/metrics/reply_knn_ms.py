"""reply_knn_ms (``.sat``, ``.light``): the host's select step of a k-NN
request's reply (the sort of its row of d²), per request, in ms: the
program's ``reply.knn`` stage, from the deltas of the service's stats
snapshot.  None for a program without stage counters."""
from portbench.readers import stats_delta


def read(rec):
    try:
        s = stats_delta(rec, "stages", "reply.knn", "host_s")
        n = stats_delta(rec, "stages", "reply.knn", "count")
    except KeyError:
        return None
    return s / n * 1e3 if n else None
