"""``QueryTrace``: the cascade's pruning counters out of a device pass.

Counterpart of ``repro/obs/trace.py``.  The paper's headline quantity is
*exclusion power*: how many candidates each condition (C9 residual gap,
C10 MINDIST, the quantized series screen) prunes before the exact
verify.  A trace carries it as five small integer arrays:

  * ``after_c9``  (Q, L): survivors after level ``l``'s C9 test,
  * ``after_c10`` (Q, L): survivors after level ``l``'s C10 test
    (``after_c10[:, -1]`` is the candidate count the verify touches),
  * ``screen_survivors`` (Q,): survivors of the quantized series screen
    (the candidate count on full-precision paths, which have no screen),
  * ``verified`` (Q,): rows whose exact distance was computed,
  * ``answers``  (Q,): final answer-set size per query.

Both engines apply C9 then C10 per level to one running alive set, so
the counters equal the op-counted host engine's (``core/search.py``)
exactly (``tests/test_torch_obs.py``).  The cascade is row-independent,
so traces over a partition of the rows add up (:func:`merge_traces`).

A trace is a plain dataclass: its leaves are torch tensors where the
engines made them (on the index's device) or numpy arrays after
:func:`to_host`; every helper here accepts either.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _host(x) -> np.ndarray:
    """A leaf as a numpy array: a torch tensor is copied from its device."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class QueryTrace:
    """Per-query cascade counters (see the module docstring)."""

    after_c9: object          # (Q, L) int32
    after_c10: object         # (Q, L) int32
    screen_survivors: object  # (Q,) int32
    verified: object          # (Q,) int32
    answers: object           # (Q,) int32

    @property
    def candidates(self) -> np.ndarray:
        """(Q,) cascade survivor count: the host engine's
        ``SearchResult.candidates``."""
        return _host(self.after_c10)[:, -1]


def _fields(trace: QueryTrace) -> list:
    return [getattr(trace, f.name) for f in dataclasses.fields(QueryTrace)]


def to_host(trace: QueryTrace) -> QueryTrace:
    """The trace with numpy leaves: only the (Q, L) and (Q,) counters
    cross from the device."""
    return QueryTrace(*[_host(x) for x in _fields(trace)])


def excluded_c9(trace: QueryTrace, n_rows: int) -> np.ndarray:
    """(Q, L) rows killed by C9 at each level: the alive set entering
    level ``l`` is ``n_rows`` at l = 0, else the previous level's C10
    survivors.  Summed over levels it is the host engine's cumulative
    ``excluded_c9``."""
    a9 = _host(trace.after_c9)
    a10 = _host(trace.after_c10)
    before = np.concatenate(
        [np.full((a9.shape[0], 1), n_rows, dtype=a9.dtype), a10[:, :-1]],
        axis=1)
    return before - a9


def excluded_c10(trace: QueryTrace) -> np.ndarray:
    """(Q, L) rows killed by C10 at each level (C9 survivors − C10
    survivors)."""
    return _host(trace.after_c9) - _host(trace.after_c10)


def merge_traces(traces) -> QueryTrace:
    """Sum counters over traces of disjoint row sets (shards).  Exact:
    the cascade is row-independent."""
    traces = list(traces)
    if not traces:
        raise ValueError("merge_traces needs at least one trace")
    return QueryTrace(*[
        np.sum([_host(getattr(t, f.name)) for t in traces], axis=0)
        for f in dataclasses.fields(QueryTrace)])


def select_queries(trace: QueryTrace, rows) -> QueryTrace:
    """The trace restricted to query rows ``rows`` (host arrays).  The
    service drops its bucket-padding rows with it before accumulating a
    batch's counters."""
    rows = np.asarray(rows)
    return QueryTrace(*[_host(x)[rows] for x in _fields(trace)])


def trace_totals(trace: QueryTrace, n_rows: int) -> dict:
    """Workload totals (python ints) for the stats and metrics surface."""
    a9 = _host(trace.after_c9)
    Q = a9.shape[0]
    return {
        "queries": int(Q),
        "rows_screened": int(Q) * int(n_rows),
        "after_c9": int(a9[:, -1].sum()),
        "after_c10": int(_host(trace.after_c10)[:, -1].sum()),
        "excluded_c9": int(excluded_c9(trace, n_rows).sum()),
        "excluded_c10": int(excluded_c10(trace).sum()),
        "screen_survivors": int(_host(trace.screen_survivors).sum()),
        "verified": int(_host(trace.verified).sum()),
        "answers": int(_host(trace.answers).sum()),
    }


def screen_row_bytes(levels, alphabet: int, resid_itemsize: int = 4,
                     word_itemsize: int = 4) -> int:
    """Resident bytes the cascade reads per database row: one residual
    and one N-symbol word per level (the quantized tier passes its
    itemsizes: 1 for int8, 2 for bf16).  ``alphabet`` is unused, kept
    for the reference's signature."""
    del alphabet
    levels = tuple(int(N) for N in levels)
    return len(levels) * int(resid_itemsize) + \
        sum(levels) * int(word_itemsize)


def tier_bytes(trace: QueryTrace, n_rows: int, row_screen_bytes: int,
               n: int, verify_itemsize: int = 4) -> dict:
    """Bytes touched per tier by one traced pass: the screen tier reads
    every row's screen columns once per query (the masked dataflow has
    no early exit); the verify tier reads only the rows the screen could
    not exclude (``verified`` × the full-precision row; on the quantized
    path at the raw tier's itemsize)."""
    q = int(_host(trace.after_c9).shape[0])
    return {
        "bytes_screen": q * int(n_rows) * int(row_screen_bytes),
        "bytes_verify": int(_host(trace.verified).sum())
        * int(n) * int(verify_itemsize),
    }
