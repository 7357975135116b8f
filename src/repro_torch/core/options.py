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


@dataclasses.dataclass(frozen=True)
class SearchOptions:
    """Knobs of one search call.

    ``backend``: ``"auto" | "torch" | "cuda"`` (``engine.resolve_backend``;
    the reference's ``"xla"`` and ``"pallas"``).  ``quantization``: only
    ``"none"`` in this slice.  ``capacity``: initial compaction capacity
    of the torch engine (``None`` = engine default); escalation from it is
    automatic.  ``n_iters``: k-NN tightening passes.  ``max_doublings``:
    cap on the 4× capacity-escalation loop.
    """

    backend: str = "auto"
    quantization: str = "none"
    capacity: int | None = None
    n_iters: int = 2
    max_doublings: int = 8


_LEGACY_FIELDS = {
    "backend": "backend",
    "quantization": "quantization",
    "capacity": "capacity",
    "n_iters": "n_iters",
    "max_doublings": "max_doublings",
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
    if opts.quantization != "none":
        raise NotImplementedError(
            f"quantization={opts.quantization!r} needs the quantized-tier "
            "slice of the port (ROADMAP.md queue 1)")
    return opts, legacy
