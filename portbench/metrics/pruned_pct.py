"""pruned_pct: the share of (query, row) pairs that C9 or C10 excluded
before the exact verify, in %, from the program's cascade counters
(``obs.trace``) over the window's first requests, counted after the
window by the backend's traced pass (``System.cascade_totals``)."""


def read(rec):
    c = rec.get("cascade")
    if not c or not c.get("rows_screened"):
        return None
    return 100.0 * (c["excluded_c9"] + c["excluded_c10"]) / c["rows_screened"]
