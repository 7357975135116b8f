"""d2h_mb_per_req (``.sat``): bytes the device passes copied to the host
per request they answered, in MB (1e6 bytes): the program's ``d2h_bytes``
counter over its ``d2h_requests`` counter (both added by one record a
pass), from the deltas of the service's stats snapshot.  None for a
program without the counters."""
from portbench.readers import stats_delta


def read(rec):
    try:
        nbytes = stats_delta(rec, "d2h_bytes")
        requests = stats_delta(rec, "d2h_requests")
    except KeyError:
        return None
    return nbytes / 1e6 / requests if requests else None
