"""The paper's op-counted similarity-search engines: SAX and FAST_SAX.

Counterpart of ``repro/core/search.py``, on the host in float64 numpy as
the reference is: the op counts are the point, and the port's counts and
latencies equal the reference's exactly (``tests/test_torch_search.py``).

* ``sax_range_query``      — classical SAX as a standalone method: one
  MINDIST test per database series (eq. 10), then a linear Euclidean scan
  of the survivors to remove false alarms.
* ``fastsax_range_query``  — the paper's method: per level, condition C9
  (eq. 9, |d(u,ū) − d(q,q̄)| > ε, O(1) with the precomputed residuals) is
  tried first; only series C9 cannot exclude pay for the MINDIST test
  (eq. 10).  Excluded series stay excluded at later levels.  Survivors of
  all levels are Euclidean-verified.
* exact k-NN forms of both (``sax_knn_query``, ``fastsax_knn_query``),
  the brute-force ground truths (``linear_scan``, ``linear_scan_knn``),
  the stack advisor (``advise_stack``) and the range engine over the
  quantized resident tier (``quantized_fastsax_range_query``).

Costs are accounted with the latency-time model of ``core/cost_model.py``:
every primitive computation is charged its closed-form op count.  The
arithmetic is vectorised numpy; the accounting is per-candidate
sequential, which is what the paper measures.  The same cascade, one
query and one level at a time, is what the CUDA kernels of
``kernels/level_ops.py`` compute on the card (``prune_level``,
``mindist_sq``, ``sqdist``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import cost_model as cm
from . import representation as repr_registry
from .cost_model import OpCounter
from .fastsax import FastSAXIndex, QueryRepr, represent_query
from .options import SearchOptions, resolve_options
from .representation import DEFAULT_STACK


def _scale(cost: dict, k: int) -> dict:
    return {name: int(v) * int(k) for name, v in cost.items()}


def _mindist_sq_np(
    words: np.ndarray, qword: np.ndarray, n: int, alphabet: int
) -> np.ndarray:
    """Squared MINDIST of one query word against (B, N) database words
    (delegates to the registered ``sax_word`` bound — one expression)."""
    return repr_registry.get("sax_word").host_bound_sq(
        words, qword, n=n, N=words.shape[-1], alphabet=alphabet)


def _stack_reps(config) -> tuple:
    """(gap_reps, word_reps) of the index's stack, cascade order."""
    reps = [repr_registry.get(name) for name in
            getattr(config, "stack", DEFAULT_STACK)]
    return ([r for r in reps if r.kind == "gap"],
            [r for r in reps if r.kind == "word"])


def _level_column(level, rep) -> np.ndarray:
    """The stored column of ``rep`` at one index level."""
    if rep.canonical_field is not None:
        return getattr(level, rep.canonical_field)
    return level.extra[rep.name]


def _query_value(qr: QueryRepr, li: int, rep):
    """The query-side value of ``rep`` at level ``li``."""
    if rep.canonical_field == "residuals":
        return qr.residuals[li]
    if rep.canonical_field == "words":
        return qr.words[li]
    return qr.extra[li][rep.name]


def _euclidean_np(series: np.ndarray, q: np.ndarray) -> np.ndarray:
    diff = series - q[None, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


@dataclasses.dataclass
class SearchResult:
    """Answer set + accounting for one range query."""

    answers: np.ndarray          # sorted indices of true answers
    distances: np.ndarray        # their Euclidean distances
    counter: OpCounter           # latency-time accounting
    candidates: int              # series that reached the Euclidean verify
    excluded_c9: int = 0         # series first excluded by eq. 9 (FAST_SAX)
    excluded_c10: int = 0        # series first excluded by eq. 10 (MINDIST)
    levels_visited: int = 0

    @property
    def latency(self) -> float:
        return self.counter.latency()


def _query_transform_cost_sax(n: int, N: int, alphabet: int) -> dict:
    """Online cost of representing the query for plain SAX (PAA+discretise)."""
    out = {}
    for c in (cm.paa_cost(n, N), cm.discretize_cost(N, alphabet)):
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def sax_range_query(
    index: FastSAXIndex,
    query: np.ndarray | QueryRepr,
    epsilon: float,
    n_segments: int | None = None,
    counter: OpCounter | None = None,
) -> SearchResult:
    """Classical SAX standalone range query at a single level.

    ``n_segments`` picks the representation level (default: finest level in
    the index, which is the standard SAX configuration).
    """
    counter = counter or OpCounter()
    n, alphabet = index.n, index.config.alphabet
    if n_segments is None:
        n_segments = max(index.config.n_segments)
    level = index.level_for(n_segments)
    qr = (query if isinstance(query, QueryRepr)
          else represent_query(query, index.config))
    li = list(index.config.levels).index(n_segments)
    qword = qr.words[li]

    # Query-side transform (online, once).
    counter.count(**_query_transform_cost_sax(n, n_segments, alphabet))

    # One MINDIST + threshold test per database series (eq. 10).
    B = index.size
    md_sq = _mindist_sq_np(level.words, qword, n, alphabet)
    counter.count(**_scale(cm.mindist_cost(n_segments), B))
    cand_mask = md_sq <= epsilon * epsilon
    cand_idx = np.nonzero(cand_mask)[0]

    # Linear scan of candidates to filter false alarms.
    d = _euclidean_np(index.series[cand_idx], qr.q)
    counter.count(**_scale(cm.euclidean_cost(n), cand_idx.size))
    keep = d <= epsilon
    return SearchResult(
        answers=cand_idx[keep],
        distances=d[keep],
        counter=counter,
        candidates=int(cand_idx.size),
        excluded_c10=int(B - cand_idx.size),
        levels_visited=1,
    )


def _query_transform_cost_fastsax(n: int, N: int, alphabet: int,
                                  stack: tuple = DEFAULT_STACK) -> dict:
    """Online query cost for one FAST_SAX level: the summed query-side
    transforms of every stack representation (PAA+discretise+residual
    for the default paper stack)."""
    out: dict = {}
    for name in stack:
        for k, v in repr_registry.get(name).query_cost(n, N, alphabet).items():
            out[k] = out.get(k, 0) + v
    return out


def fastsax_range_query(
    index: FastSAXIndex,
    query: np.ndarray | QueryRepr,
    epsilon: float,
    counter: OpCounter | None = None,
    lazy_query_levels: bool = True,
) -> SearchResult:
    """FAST_SAX range query (paper §3, "The Online Phase").

    Per level (in ``index.config.levels`` order): C9 first, then MINDIST for
    the series C9 could not exclude.  Terminates early when everything is
    excluded.  ``lazy_query_levels`` charges the query-side transform of a
    level only when that level is actually visited.
    """
    counter = counter or OpCounter()
    n, alphabet = index.n, index.config.alphabet
    qr = (query if isinstance(query, QueryRepr)
          else represent_query(query, index.config))
    gap_reps, word_reps = _stack_reps(index.config)

    B = index.size
    alive = np.ones(B, dtype=bool)
    excluded_c9 = 0
    excluded_c10 = 0
    levels_visited = 0
    eps = float(epsilon)

    for li, level in enumerate(index.levels):
        if not alive.any():
            break
        levels_visited += 1
        N = level.n_segments
        if lazy_query_levels or li == 0:
            counter.count(**_query_transform_cost_fastsax(
                n, N, alphabet, index.config.stack))

        survivors = np.nonzero(alive)[0]
        # --- gap-kind exclusions: |col(u) − col(q)| > ε.  The canonical
        # linfit residual is C9 (eq. 9, precomputed residuals). ---
        for rep in gap_reps:
            if not survivors.size:
                break
            gap = rep.host_gap(_level_column(level, rep)[survivors],
                               _query_value(qr, li, rep))
            counter.count(**_scale(rep.exclude_cost(n, N, alphabet),
                                   survivors.size))
            kill = gap > eps
            excluded_c9 += int(kill.sum())
            survivors = survivors[~kill]

        # --- word-kind exclusions: bound²(ũ,q̃) > ε² only for gap
        # survivors.  The canonical SAX word is C10 (eq. 10, MINDIST). ---
        for rep in word_reps:
            if not survivors.size:
                break
            b_sq = rep.host_bound_sq(
                _level_column(level, rep)[survivors],
                _query_value(qr, li, rep), n=n, N=N, alphabet=alphabet)
            counter.count(**_scale(rep.exclude_cost(n, N, alphabet),
                                   survivors.size))
            kill = b_sq > eps * eps
            excluded_c10 += int(kill.sum())
            survivors = survivors[~kill]

        alive[:] = False
        alive[survivors] = True

    # --- Final linear Euclidean scan over the potential answer set ---
    cand_idx = np.nonzero(alive)[0]
    d = _euclidean_np(index.series[cand_idx], qr.q)
    counter.count(**_scale(cm.euclidean_cost(n), cand_idx.size))
    keep = d <= eps
    return SearchResult(
        answers=cand_idx[keep],
        distances=d[keep],
        counter=counter,
        candidates=int(cand_idx.size),
        excluded_c9=excluded_c9,
        excluded_c10=excluded_c10,
        levels_visited=levels_visited,
    )


# Rows probed per (query, extra representation) when advising a stack.
_STACK_PROBE = 256


def advise_stack(index: FastSAXIndex,
                 queries: np.ndarray,
                 epsilon: float,
                 probe_rows: int = _STACK_PROBE) -> tuple:
    """Cost-model probe: which registered extras should this dataset enable?

    For every extra representation in the index's stack, measure — on a
    deterministic strided row probe of level 0, the first cascade level —
    the fraction of probe rows the representation's bound *alone* would
    kill at radius ``epsilon``, averaged over ``queries``; the extra is
    kept iff :func:`cost_model.level_enable_advised` says the expected
    exclusion gain (saved Euclidean verifies) beats the test's own
    per-candidate cost.  Mirrors the ``_C10_PROBE`` mechanism of the
    adaptive k-NN cascade, lifted to per-dataset level selection.

    Returns the advised stack (always containing the paper backbone) —
    pass it to a new :class:`~.fastsax.FastSAXConfig`.
    """
    config = index.config
    if not config.extra_stack:
        return config.stack
    queries = np.atleast_2d(np.asarray(queries, dtype=np.float64))
    n, alphabet = index.n, config.alphabet
    lv0 = index.levels[0]
    N = lv0.n_segments
    B = index.size
    P = min(int(probe_rows), B)
    rows = (np.arange(P, dtype=np.int64) * B) // P   # strided, deterministic
    eps = float(epsilon)
    qrs = [represent_query(q, config) for q in queries]
    keep = []
    for name in config.stack:
        rep = repr_registry.get(name)
        if rep.canonical_field is not None:
            keep.append(name)     # the backbone is never disabled
            continue
        col = _level_column(lv0, rep)[rows]
        kills = 0
        for qr in qrs:
            lbs = rep.host_lower_bound(col, _query_value(qr, 0, rep),
                                       n=n, N=N, alphabet=alphabet)
            kills += int((lbs > eps).sum())
        kill_frac = kills / float(P * len(qrs))
        if cm.level_enable_advised(kill_frac, n,
                                   rep.exclude_cost(n, N, alphabet)):
            keep.append(name)
    return tuple(keep)


# ---------------------------------------------------------------------------
# Exact k-nearest-neighbour engines (best-so-far cascade).
#
# The same proven-sound lower bounds that power the ε-range cascade (C9's
# residual gap, eq. 9, and MINDIST, eq. 10) turn directly into exact k-NN
# search: any candidate whose lower bound exceeds the current k-th best
# *verified* distance can never enter the answer set.  The radius starts
# from k cheaply-chosen verified candidates and only shrinks, so every
# exclusion is sound — the answer set equals brute-force top-k, with ties
# broken deterministically by (distance, index).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KNNResult:
    """Exact k-NN answer + accounting for one query.

    ``indices``/``distances`` are sorted ascending by (distance, index) —
    identical to brute force under the same deterministic tie-break.
    """

    indices: np.ndarray          # (k',) with k' = min(k, B)
    distances: np.ndarray        # (k',) true Euclidean distances
    counter: OpCounter           # latency-time accounting
    verified: int                # series that paid a full Euclidean distance
    excluded_c9: int = 0         # killed by the residual gap (eq. 9)
    excluded_c10: int = 0        # killed by MINDIST (eq. 10)
    pruned_bsf: int = 0          # skipped by the best-so-far bound at verify
    levels_visited: int = 0
    seed_radius: float = float("inf")   # ε after the seeding phase

    @property
    def latency(self) -> float:
        return self.counter.latency()


class _BestK:
    """Max-heap of the k smallest (distance, index) pairs, op-charged.

    The heap key is the *pair* (d, i), so boundary ties resolve exactly the
    way ``np.lexsort`` brute force does: smaller index wins at equal
    distance.
    """

    def __init__(self, k: int, counter: OpCounter):
        import heapq

        self._heapq = heapq
        self.k = int(k)
        self.counter = counter
        self._heap: list = []    # entries (-d, -i): top is the worst kept pair

    @property
    def full(self) -> bool:
        return len(self._heap) >= self.k

    @property
    def bound(self) -> float:
        """Current k-th best verified distance (inf until k are held)."""
        return -self._heap[0][0] if self.full else float("inf")

    def consider(self, d: float, i: int) -> None:
        if not self.full:
            self._heapq.heappush(self._heap, (-d, -i))
            self.counter.count(**cm.heap_push_cost(self.k))
            return
        self.counter.count(cmp=1)
        if (-d, -i) > self._heap[0]:          # (d, i) < current worst pair
            self._heapq.heapreplace(self._heap, (-d, -i))
            self.counter.count(**cm.heap_push_cost(self.k))

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        pairs = sorted((-nd, -ni) for nd, ni in self._heap)
        idx = np.asarray([i for _, i in pairs], dtype=np.int64)
        dist = np.asarray([d for d, _ in pairs], dtype=np.float64)
        return idx, dist


def _knn_result_from_heap(best: _BestK, **kw) -> KNNResult:
    idx, dist = best.result()
    return KNNResult(indices=idx, distances=dist, **kw)


def linear_scan_knn(
    index: FastSAXIndex,
    query: np.ndarray | QueryRepr,
    k: int,
    counter: OpCounter | None = None,
) -> KNNResult:
    """Brute-force exact k-NN — ground truth and cost ceiling."""
    counter = counter or OpCounter()
    qr = (query if isinstance(query, QueryRepr)
          else represent_query(query, index.config))
    B = index.size
    k_eff = min(int(k), B)
    d = _euclidean_np(index.series, qr.q)
    counter.count(**_scale(cm.euclidean_cost(index.n), B))
    best = _BestK(k_eff, counter)
    for i in range(B):
        best.consider(float(d[i]), i)
    return _knn_result_from_heap(best, counter=counter, verified=B)


def sax_knn_query(
    index: FastSAXIndex,
    query: np.ndarray | QueryRepr,
    k: int,
    n_segments: int | None = None,
    counter: OpCounter | None = None,
) -> KNNResult:
    """Classical SAX exact k-NN at a single level (MINDIST-ordered scan).

    The textbook exact algorithm: compute MINDIST(q̃, ũ) for every series,
    visit candidates in ascending MINDIST order, verify true distances into
    a best-so-far heap, and stop at the first candidate whose lower bound
    exceeds the running k-th best distance (every later candidate's bound is
    at least as large).
    """
    counter = counter or OpCounter()
    n, alphabet = index.n, index.config.alphabet
    if n_segments is None:
        n_segments = max(index.config.n_segments)
    level = index.level_for(n_segments)
    qr = (query if isinstance(query, QueryRepr)
          else represent_query(query, index.config))
    li = list(index.config.levels).index(n_segments)

    counter.count(**_query_transform_cost_sax(n, n_segments, alphabet))

    B = index.size
    k_eff = min(int(k), B)
    md = np.sqrt(_mindist_sq_np(level.words, qr.words[li], n, alphabet))
    counter.count(**_scale(cm.mindist_cost(n_segments), B))
    order = np.argsort(md, kind="stable")
    counter.count(**cm.sort_cost(B))

    best = _BestK(k_eff, counter)
    verified = 0
    pruned = 0
    for rank, i in enumerate(order):
        if best.full:
            counter.count(cmp=1)
            if md[i] > best.bound:
                pruned = B - rank
                break
        d = float(_euclidean_np(index.series[i:i + 1], qr.q)[0])
        counter.count(**cm.euclidean_cost(n))
        verified += 1
        best.consider(d, int(i))
    # The break-pruned tail is charged to pruned_bsf only (not also to
    # excluded_c10), keeping the accounting fields disjoint so
    # verified + excluded_* + pruned_bsf never exceeds B.
    return _knn_result_from_heap(
        best, counter=counter, verified=verified, pruned_bsf=pruned,
        levels_visited=1)


# C10 probe size for the adaptive cascade: enough survivors to estimate
# the level's exclusion rate, cheap enough to charge unconditionally.
_C10_PROBE = 32


def fastsax_knn_query(
    index: FastSAXIndex,
    query: np.ndarray | QueryRepr,
    k: int,
    counter: OpCounter | None = None,
    options: SearchOptions | None = None,
    **legacy,
) -> KNNResult:
    """FAST_SAX exact k-NN: seeded best-so-far radius + exclusion cascade.

    Three phases, all charged to the latency-time model:

    1. **Seed** — the level-0 residual gap |d(u,ū) − d(q,q̄)| is itself a
       lower bound on d(u,q) (eq. 5-9) and costs O(1) per series.  The
       ``seed_factor · k`` series with the smallest gap are Euclidean-
       verified into the best-so-far heap; the k-th verified distance is the
       starting radius ε.
    2. **Cascade** — the ε-range machinery of :func:`fastsax_range_query`
       runs per level (C9 then masked MINDIST) against the seeded ε, while
       recording each survivor's tightest known lower bound.
    3. **Verify** — cascade survivors are visited in ascending lower-bound
       order; each verification can only shrink ε, and the scan stops at the
       first survivor whose bound exceeds it.

    Every exclusion compares a *proven lower bound* against a *verified
    distance*, so the result is exactly brute-force top-k (ties broken by
    index).

    ``adaptive_c10`` (beyond-paper, cost-model-driven): at each level a
    small survivor probe (``_C10_PROBE`` rows, charged) estimates the
    MINDIST kill fraction; when the expected exclusion gain is below the
    test's own cost (``cost_model.c10_skip_advised``) the remaining
    survivors skip that level's MINDIST.  Skipping is sound — C10 only
    removes candidates the Euclidean verify would reject anyway — so the
    answer set is unchanged; only the op accounting moves.  It repairs
    the cells where FAST_SAX lost to plain SAX at k = 5, α ∈ {3, 10}:
    there the coarse level's MINDIST excluded almost nothing yet was
    charged for every survivor.

    Knobs (``seed_factor``, ``adaptive_c10``) live on
    :class:`~.options.SearchOptions`; passing them as bare keywords still
    works through the deprecation shim.
    """
    opts, rest = resolve_options(options, legacy, "fastsax_knn_query")
    if rest:
        raise TypeError(
            f"fastsax_knn_query: unexpected keyword(s) {sorted(rest)}")
    seed_factor = opts.seed_factor
    adaptive_c10 = opts.adaptive_c10
    counter = counter or OpCounter()
    n, alphabet = index.n, index.config.alphabet
    gap_reps, word_reps = _stack_reps(index.config)
    qr = (query if isinstance(query, QueryRepr)
          else represent_query(query, index.config))
    B = index.size
    k_eff = min(int(k), B)
    best = _BestK(k_eff, counter)

    # --- Phase 1: seed the best-so-far radius from level-0 gaps ------------
    lv0 = index.levels[0]
    counter.count(**_query_transform_cost_fastsax(
        n, lv0.n_segments, alphabet, index.config.stack))
    gaps0 = np.abs(lv0.residuals - qr.residuals[0])
    counter.count(**_scale(cm.residual_gap_cost(), B))
    n_seed = min(B, max(k_eff, int(seed_factor) * k_eff))
    seed_idx = np.argsort(gaps0, kind="stable")[:n_seed]
    counter.count(**cm.select_cost(B, n_seed))
    d_seed = _euclidean_np(index.series[seed_idx], qr.q)
    counter.count(**_scale(cm.euclidean_cost(n), n_seed))
    for i, d in zip(seed_idx, d_seed):
        best.consider(float(d), int(i))
    eps = best.bound
    seed_radius = eps

    verified_mask = np.zeros(B, dtype=bool)
    verified_mask[seed_idx] = True
    alive = ~verified_mask
    lb = np.zeros(B)                 # tightest known lower bound per series
    lb[~verified_mask] = gaps0[~verified_mask]

    # --- Phase 2: exclusion cascade with mid-cascade tightening ------------
    excluded_c9 = 0
    excluded_c10 = 0
    levels_visited = 0
    n_verified = int(n_seed)
    for li, level in enumerate(index.levels):
        if not alive.any():
            break
        levels_visited += 1
        N = level.n_segments
        if li > 0:  # level 0's query transform was charged by the seed phase
            counter.count(**_query_transform_cost_fastsax(
                n, N, alphabet, index.config.stack))

        survivors = np.nonzero(alive)[0]
        # --- gap-kind exclusions (canonical: C9, eq. 9) --------------------
        for rep in gap_reps:
            if not survivors.size:
                break
            if rep.canonical_field == "residuals" and li == 0:
                # The seed phase already computed (and charged) level-0
                # gaps; only the threshold compare is new work here.
                gap = gaps0[survivors]
                counter.count(cmp=survivors.size)
            else:
                gap = rep.host_gap(_level_column(level, rep)[survivors],
                                   _query_value(qr, li, rep))
                counter.count(**_scale(rep.exclude_cost(n, N, alphabet),
                                       survivors.size))
            lb[survivors] = np.maximum(lb[survivors], gap)
            kill = gap > eps
            excluded_c9 += int(kill.sum())
            survivors = survivors[~kill]

        # --- word-kind exclusions (canonical: C10, eq. 10) -----------------
        for rep in word_reps:
            if not survivors.size:
                break
            col = _level_column(level, rep)
            qv = _query_value(qr, li, rep)
            m = survivors.size
            kill = np.zeros(m, dtype=bool)
            probe_pos = np.arange(m)
            # Only non-final levels are skippable: the finest level's
            # bound is the tightest lower bound and drives the phase-3
            # verify ordering — dropping it trades a small test cost for
            # far more Euclidean verifications (measured in the
            # reference's experiments).  A coarse level's bound is superseded by the finest
            # level's anyway (lb is a running max).
            last_level = li == len(index.levels) - 1
            if adaptive_c10 and not last_level and m > _C10_PROBE:
                # Evenly-spread probe (deterministic) to estimate this
                # level's exclusion rate before paying for it on every
                # survivor.
                probe_pos = np.unique(
                    np.linspace(0, m - 1, _C10_PROBE).astype(np.int64))
            probe = survivors[probe_pos]
            md_p = np.sqrt(rep.host_bound_sq(col[probe], qv,
                                             n=n, N=N, alphabet=alphabet))
            counter.count(**_scale(rep.exclude_cost(n, N, alphabet),
                                   probe.size))
            lb[probe] = np.maximum(lb[probe], md_p)
            kill[probe_pos] = md_p > eps
            if probe.size < m:
                kill_frac = float((md_p > eps).mean())
                if not cm.c10_skip_advised(kill_frac, n, N):
                    rest_pos = np.setdiff1d(np.arange(m), probe_pos,
                                            assume_unique=True)
                    rest = survivors[rest_pos]
                    md_r = np.sqrt(rep.host_bound_sq(
                        col[rest], qv, n=n, N=N, alphabet=alphabet))
                    counter.count(**_scale(rep.exclude_cost(n, N, alphabet),
                                           rest.size))
                    lb[rest] = np.maximum(lb[rest], md_r)
                    kill[rest_pos] = md_r > eps
                # else: the level's expected exclusion gain is below the
                # test's cost — the remaining survivors skip the bound here
                # (sound: it only removes rows the verify would reject).
            excluded_c10 += int(kill.sum())
            survivors = survivors[~kill]

        alive[:] = False
        alive[survivors] = True

        # Mid-cascade tightening: verify the most promising survivors (the
        # k smallest lower bounds) NOW, so the next level prunes against
        # the tightened radius instead of the loose seed.
        if survivors.size and li < len(index.levels) - 1:
            m = min(k_eff, survivors.size)
            counter.count(**cm.select_cost(survivors.size, m))
            promising = survivors[np.argsort(lb[survivors],
                                             kind="stable")[:m]]
            d_p = _euclidean_np(index.series[promising], qr.q)
            counter.count(**_scale(cm.euclidean_cost(n), m))
            n_verified += int(m)
            for i, d in zip(promising, d_p):
                best.consider(float(d), int(i))
            eps = min(eps, best.bound)
            alive[promising] = False

    # --- Phase 3: best-so-far verification in ascending lower-bound order --
    cand = np.nonzero(alive)[0]
    order = np.argsort(lb[cand], kind="stable")
    counter.count(**cm.sort_cost(cand.size))
    verified = n_verified
    pruned = 0
    for rank, ci in enumerate(order):
        i = int(cand[ci])
        counter.count(cmp=1)
        if lb[i] > best.bound:
            pruned = cand.size - rank
            break
        d = float(_euclidean_np(index.series[i:i + 1], qr.q)[0])
        counter.count(**cm.euclidean_cost(n))
        verified += 1
        best.consider(d, i)
        eps = min(eps, best.bound)
    return _knn_result_from_heap(
        best, counter=counter, verified=verified, excluded_c9=excluded_c9,
        excluded_c10=excluded_c10, pruned_bsf=pruned,
        levels_visited=levels_visited, seed_radius=float(seed_radius))


def linear_scan(
    index: FastSAXIndex,
    query: np.ndarray | QueryRepr,
    epsilon: float,
    counter: OpCounter | None = None,
) -> SearchResult:
    """Brute-force sequential scan — ground truth and cost ceiling."""
    counter = counter or OpCounter()
    qr = (query if isinstance(query, QueryRepr)
          else represent_query(query, index.config))
    d = _euclidean_np(index.series, qr.q)
    counter.count(**_scale(cm.euclidean_cost(index.n), index.size))
    keep = d <= epsilon
    idx = np.nonzero(keep)[0]
    return SearchResult(answers=idx, distances=d[idx], counter=counter,
                        candidates=index.size, levels_visited=0)


# ---------------------------------------------------------------------------
# Quantized-tier range engine.
#
# The resident tier stores int8/bf16 residual codes instead of f32
# residuals; dequantization error would make the raw C9 test unsound, so
# the bound is *widened* by the stored per-block worst-case error e_blk:
#
#   |r̂(u) − r(q)| > ε + e_blk   ⇒   |r(u) − r(q)| > ε   (reverse triangle
#   inequality on |r̂ − r| ≤ e_blk)  ⇒  d(u, q) > ε  by eq. 5–9.
#
# C10 is NOT widened: the SAX symbols narrow to int8 losslessly (alphabet
# ≤ 127, enforced at quantize time), so MINDIST is computed on exactly the
# same words as full precision.  Survivors verify against the raw
# full-precision rows (the raw tier), so answers are set-identical to
# ``fastsax_range_query``.
# ---------------------------------------------------------------------------


def _dequant_c9_extra(mode: str) -> dict:
    """Op cost ON TOP of ``c9_cost()`` per candidate at a quantized level:
    int8 pays the affine dequant (one fused multiply-add, counted mul+add)
    plus the bound-widening add; bf16 decode is a pure bit-shift (charged
    as a lookup) plus the widening add."""
    if mode == "int8":
        return dict(mul=1, add=2)
    return dict(lookup=1, add=1)


def quantized_fastsax_range_query(
    qindex,
    series: np.ndarray,
    query: np.ndarray | QueryRepr,
    epsilon: float,
    config=None,
    counter: OpCounter | None = None,
    lazy_query_levels: bool = True,
) -> SearchResult:
    """FAST_SAX range query over the quantized resident tier.

    ``qindex`` is an ``index.quantized.QuantizedHostIndex`` (the port's,
    or the reference's handed over as it is)
    (symbols + quantized residuals + per-block error bounds); ``series``
    is the raw full-precision row matrix — typically the store's mmap'd
    column — touched only for the survivors' final Euclidean verify.
    ``query`` may be a raw array (then ``config`` must be the index's
    :class:`FastSAXConfig`) or a precomputed :class:`QueryRepr`.

    Same cascade schedule as :func:`fastsax_range_query`; the only
    differences are the widened C9 threshold and the per-candidate
    dequantization charge (:func:`_dequant_c9_extra`).  Answer sets are
    identical to the full-precision engine by the soundness argument
    above.
    """
    counter = counter or OpCounter()
    n, alphabet = qindex.n, qindex.alphabet
    if isinstance(query, QueryRepr):
        qr = query
    else:
        if config is None:
            raise ValueError("raw-array query needs config= to represent it")
        qr = represent_query(query, config)

    B = qindex.size
    alive = np.ones(B, dtype=bool)
    excluded_c9 = 0
    excluded_c10 = 0
    levels_visited = 0
    eps = float(epsilon)
    extra = _dequant_c9_extra(qindex.mode)
    stack = tuple(getattr(qindex, "stack", DEFAULT_STACK))
    word_reps = [repr_registry.get(nm) for nm in stack
                 if repr_registry.get(nm).kind == "word"]

    for li, lv in enumerate(qindex.levels):
        if not alive.any():
            break
        levels_visited += 1
        N = lv.n_segments
        if lazy_query_levels or li == 0:
            counter.count(**_query_transform_cost_fastsax(
                n, N, alphabet, stack))

        alive_idx = np.nonzero(alive)[0]
        res = lv.dequant_residuals()
        err = lv.row_err()
        # --- widened C9: |r̂(u) − r(q)| > ε + e_blk(u) ---------------------
        # Gap-kind columns beyond the canonical residual are rejected at
        # quantize time (index/quantized.py), so C9 stays canonical here.
        gap = np.abs(res[alive_idx] - qr.residuals[li])
        c9_kill = gap > eps + err[alive_idx]
        counter.count(**_scale(cm.c9_cost(), alive_idx.size))
        counter.count(**_scale(extra, alive_idx.size))
        excluded_c9 += int(c9_kill.sum())
        survivors = alive_idx[~c9_kill]

        # --- word-kind bounds, unwidened (int8 symbols are lossless) -------
        for rep in word_reps:
            if not survivors.size:
                break
            col = (lv.words if rep.canonical_field == "words"
                   else lv.extra[rep.name])
            qv = (qr.words[li] if rep.canonical_field == "words"
                  else qr.extra[li][rep.name])
            b_sq = rep.host_bound_sq(col[survivors].astype(np.int64), qv,
                                     n=n, N=N, alphabet=alphabet)
            counter.count(**_scale(rep.exclude_cost(n, N, alphabet),
                                   survivors.size))
            c10_kill = b_sq > eps * eps
            excluded_c10 += int(c10_kill.sum())
            survivors = survivors[~c10_kill]

        alive[:] = False
        alive[survivors] = True

    # --- Final verify from the raw (mmap) tier -----------------------------
    cand_idx = np.nonzero(alive)[0]
    d = _euclidean_np(np.asarray(series[cand_idx], dtype=np.float64),
                      np.asarray(qr.q, dtype=np.float64))
    counter.count(**_scale(cm.euclidean_cost(n), cand_idx.size))
    keep = d <= eps
    return SearchResult(
        answers=cand_idx[keep],
        distances=d[keep],
        counter=counter,
        candidates=int(cand_idx.size),
        excluded_c9=excluded_c9,
        excluded_c10=excluded_c10,
        levels_visited=levels_visited,
    )
