"""One query-options surface.

Counterpart of ``repro/core/options.py``.  :class:`SearchOptions` is the
frozen dataclass every public ``*_query_backend`` entry point takes;
:func:`resolve_options` forwards the reference's older per-call keywords
into it with a :class:`DeprecationWarning`, so call sites written for the
reference keep working.
"""
from __future__ import annotations

import dataclasses
import warnings

from ..index.quantized import check_mode


@dataclasses.dataclass(frozen=True)
class SearchOptions:
    """Knobs of one search call.

    ``backend``: ``"auto" | "torch" | "cuda"`` (``engine.resolve_backend``;
    the reference's ``"xla"`` and ``"pallas"``).  ``quantization``:
    ``"none" | "bf16" | "int8"`` memory tier (``engine.TieredIndex``).
    ``capacity``: initial compaction capacity (``None`` = engine default);
    escalation from it is automatic.  ``n_iters``: k-NN tightening passes.
    ``max_doublings``: cap on the 4× capacity-escalation loop.
    ``seed_factor`` / ``adaptive_c10``: the host k-NN engine's knobs
    (``search.fastsax_knn_query``).
    ``verify_prefetch``: overlap the tiered engines' raw-tier row fetch
    with the device's upload and verify (``engine._verify_prefetched``);
    the distances are the same, bit for bit.  ``trace``: the serving
    layer's query-path tracing (``serve.ServeConfig.from_options``).
    ``normalize_queries``: z-normalise incoming queries.
    """

    backend: str = "auto"
    quantization: str = "none"
    capacity: int | None = None
    n_iters: int = 2
    max_doublings: int = 8
    verify_prefetch: bool = False
    seed_factor: int = 2
    adaptive_c10: bool = True
    trace: bool = False
    normalize_queries: bool = True


_LEGACY_FIELDS = {
    "backend": "backend",
    "quantization": "quantization",
    "capacity": "capacity",
    "n_iters": "n_iters",
    "max_doublings": "max_doublings",
    "verify_prefetch": "verify_prefetch",
    "seed_factor": "seed_factor",
    "adaptive_c10": "adaptive_c10",
    "trace": "trace",
    "normalize_queries": "normalize_queries",
}


def resolve_options(options: SearchOptions | None, legacy: dict,
                    caller: str = "query"):
    """Merge legacy kwargs into a :class:`SearchOptions`.

    Every key of ``legacy`` named in ``_LEGACY_FIELDS`` is popped and
    applied over ``options`` (or the defaults) with one warning; the rest
    is returned untouched (expert kernel tile overrides).  Returns
    ``(options, remaining_kwargs)``.
    """
    taken = {k: legacy.pop(k) for k in list(legacy) if k in _LEGACY_FIELDS}
    opts = options if options is not None else SearchOptions()
    if taken:
        warnings.warn(
            f"{caller}: keyword(s) {sorted(taken)} are deprecated — pass "
            f"SearchOptions({', '.join(sorted(_LEGACY_FIELDS[k] + '=...' for k in taken))}) "
            "via options= instead",
            DeprecationWarning, stacklevel=3)
        opts = dataclasses.replace(
            opts, **{_LEGACY_FIELDS[k]: v for k, v in taken.items()})
    check_mode(opts.quantization)
    return opts, legacy
