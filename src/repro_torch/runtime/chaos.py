"""Deterministic, seeded fault injection for the serving stack.

Counterpart of ``repro/runtime/chaos.py``, copied: the same sites, modes
and blake2b rolls, so one ``FaultPlan`` fires at the same invocations in
both packages.  A ``FaultPlan`` names *where* faults fire (injection
sites in the production code paths), *how* they fail (raise / slow /
truncate), and *when* (an invocation-count window per site) — and every
decision is a pure hash of ``(seed, site, key, invocation_count)``, so a
chaos run replays **bit-identically** regardless of thread interleaving
or wall clock.

Injection sites (grep for ``chaos.maybe_fire`` / ``chaos.apply``):

  ``shard_query``    per-shard local query in the failover engine
                     (``core/dist_search.FailoverShards``); key = shard id
  ``store_read``     column read in ``index/store.read_array``; key =
                     array name (truncate mode shears rows *before* the
                     manifest shape check, so the store's own validation
                     is what fails loudly)
  ``device_upload``  host->device index upload during a serve-layer
                     generation swap; key = generation number
  ``serve_dispatch`` one fire per formed batch in
                     ``serve/service.SearchService._dispatch``; key=None,
                     so the window counts *dispatches*
  ``verify_fetch``   raw-tier verify row gather in
                     ``index/store.gather_rows`` (both the synchronous
                     path and the double-buffered prefetch path of the
                     tiered engines); key = fetch chunk label (truncate
                     mode shears query rows *before* the shape check, so
                     a torn mmap read fails loudly, never silently-wrong)

Failure modes: ``raise`` (throws ``FaultInjected``, which the failover
and retry layers treat as transient), ``slow`` (sleeps ``delay_s`` —
drives the straggler/timeout/hedging path), ``truncate`` (value sites
only: returns a sheared array so downstream validation trips).

**Zero overhead when disabled**: the production hot paths guard on a
single module-global ``None`` check; no plan installed means no hashing,
no locking, no branching beyond the load.

    plan = FaultPlan(seed=0, specs=[
        FaultSpec(site="shard_query", key="1", mode="raise",
                  start=6, stop=30)])
    with chaos.injected(plan):
        ...   # shard 1's 6th..29th query attempt raises FaultInjected
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import Optional, Sequence

MODE_RAISE = "raise"
MODE_SLOW = "slow"
MODE_TRUNCATE = "truncate"
_MODES = (MODE_RAISE, MODE_SLOW, MODE_TRUNCATE)


class FaultInjected(RuntimeError):
    """An injected fault.  Carries its provenance so tests can assert
    *which* rehearsed failure they observed; treated as transient by the
    retry/failover layers (like a flaky RPC, not a poison query)."""

    def __init__(self, site: str, key: Optional[str], count: int):
        super().__init__(f"injected fault at site={site!r} key={key!r} "
                         f"invocation={count}")
        self.site = site
        self.key = key
        self.count = count


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One rehearsed failure.  Fires when the per-``(site, key)``
    invocation count lands in ``[start, stop)`` and the deterministic
    coin (``p``) comes up — with the default ``p=1.0`` the window alone
    decides, which is what kill/recover schedules want."""

    site: str
    mode: str = MODE_RAISE
    key: Optional[str] = None      # None = any key at this site
    p: float = 1.0                 # fire probability inside the window
    start: int = 0                 # invocation window [start, stop)
    stop: Optional[int] = None     # None = forever
    delay_s: float = 0.0           # slow mode: injected latency
    frac: float = 0.5              # truncate mode: fraction of rows kept

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown fault mode {self.mode!r} "
                             f"(have {_MODES})")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p={self.p} outside [0, 1]")

    def in_window(self, count: int) -> bool:
        return count >= self.start and (self.stop is None
                                        or count < self.stop)


class FaultPlan:
    """A seed plus the fault schedule.  Decisions are pure functions of
    ``(seed, site, key, invocation_count)`` via blake2b, so two runs of
    the same workload under the same plan fail in exactly the same
    places — thread timing and wall clock never enter the decision."""

    def __init__(self, seed: int = 0,
                 specs: Sequence[FaultSpec] = ()):
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._counts: dict = {}
        self.fired: dict = {}
        self._lock = threading.Lock()

    def _roll(self, site: str, key: Optional[str], count: int) -> float:
        """Deterministic uniform [0, 1) for this invocation."""
        msg = f"{self.seed}|{site}|{key}|{count}".encode()
        h = hashlib.blake2b(msg, digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def decide(self, site: str, key: Optional[str]) -> Optional[FaultSpec]:
        """Count this invocation and return the spec to apply (or None).
        First matching spec wins; the counter advances either way."""
        with self._lock:
            count = self._counts.get((site, key), 0)
            self._counts[(site, key)] = count + 1
        for spec in self.specs:
            if spec.site != site:
                continue
            if spec.key is not None and spec.key != key:
                continue
            if not spec.in_window(count):
                continue
            if spec.p < 1.0 and self._roll(site, key, count) >= spec.p:
                continue
            with self._lock:
                self.fired[(site, key)] = \
                    self.fired.get((site, key), 0) + 1
            return dataclasses.replace(spec, key=key) \
                if spec.key is None else spec
        return None

    def invocations(self, site: str, key: Optional[str] = None) -> int:
        with self._lock:
            if key is not None or (site, None) in self._counts:
                return self._counts.get((site, key), 0)
            return sum(n for (s, _k), n in self._counts.items()
                       if s == site)

    def fired_count(self, site: str, key: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for (s, k), n in self.fired.items()
                       if s == site and (key is None or k == key))


# The module-global plan.  ``None`` (the default) is the production
# state: every injection site reduces to one attribute load + None check.
_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    _PLAN = None


def active() -> bool:
    return _PLAN is not None


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """``with chaos.injected(plan): ...`` — install for the block,
    always uninstall (a leaked plan would poison unrelated tests)."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def _execute(spec: FaultSpec, site: str, key: Optional[str],
             count: int, value=None):
    if spec.mode == MODE_RAISE:
        raise FaultInjected(site, key, count)
    if spec.mode == MODE_SLOW:
        time.sleep(spec.delay_s)
        return value
    # truncate: shear rows; meaningless without a value (maybe_fire
    # callers), where it degrades to a raise so a misplaced spec is loud.
    if value is None:
        raise FaultInjected(site, key, count)
    n = len(value)
    return value[:max(0, min(n, int(n * spec.frac)))]


def maybe_fire(site: str, key: Optional[str] = None) -> None:
    """Control-flow injection point: raises or sleeps per the installed
    plan; no-op (single None check) when no plan is installed."""
    plan = _PLAN
    if plan is None:
        return
    spec = plan.decide(site, key)
    if spec is None:
        return
    _execute(spec, site, key, plan.invocations(site, key) - 1)


def apply(site: str, key: Optional[str], value):
    """Value injection point: returns ``value`` untouched (or sheared by
    a truncate spec), raises/sleeps for the other modes.  No-op when no
    plan is installed."""
    plan = _PLAN
    if plan is None:
        return value
    spec = plan.decide(site, key)
    if spec is None:
        return value
    return _execute(spec, site, key,
                    plan.invocations(site, key) - 1, value)
