"""qps: requests answered OK in the window over the window's seconds
(host clock, client side)."""
from portbench import arith


def read(rec):
    return arith.qps(rec["loop"])
