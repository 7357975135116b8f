"""p95_ms: the 95th percentile of the submit-to-reply time of every
request of the window answered OK, on the client's clock."""
from portbench import arith


def read(rec):
    lat = arith.latencies_ms(rec["loop"])
    return arith.percentile(lat, 95) if lat else None
