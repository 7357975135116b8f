"""batch_mean: requests served per batch over the run, from the deltas of
the service's stats snapshot (served / batches)."""
from portbench.readers import stats_delta


def read(rec):
    served, batches = stats_delta(rec, "served"), stats_delta(rec, "batches")
    if not batches:
        return None
    return served / batches
