"""Raw-tier row fetch.

Counterpart of ``gather_rows`` in ``repro/index/store.py``; the rest of
the store (manifest, atomic commit, mmap loads) comes with the
index-lifecycle slice of the port (ROADMAP.md queue 1).
"""
from __future__ import annotations

import numpy as np


def gather_rows(raw, idx, out: np.ndarray | None = None) -> np.ndarray:
    """Fetch full-precision verify rows from the raw tier by row id, as
    float32 of shape ``idx.shape + raw.shape[1:]``.

    The one place every raw-tier verify read goes through, synchronous or
    prefetched.  ``raw`` is anything with row-major fancy indexing (an
    ``np.memmap`` or a plain array).  Row ids clamp into the raw tier's
    row range, so a dead slot's arbitrary id never faults the read; an
    empty raw tier serves zeros.  ``out``, when given, receives the rows
    (e.g. a pinned staging buffer) and is returned.  A read of the wrong
    shape raises ``IOError`` instead of returning a truncated candidate
    set.  The reference's ``verify_fetch`` fault-injection site comes
    with the fault-tolerance slice (ROADMAP.md queue 8).
    """
    n_rows = int(raw.shape[0])
    idx = np.asarray(idx)
    want = idx.shape + tuple(raw.shape[1:])
    if n_rows == 0:
        rows = np.zeros(want, np.float32)
    elif out is not None and raw.dtype == np.float32 and out.shape == want:
        # Straight into the caller's buffer: no intermediate copy.
        rows = np.take(raw, idx, axis=0, mode="clip", out=out)
    else:
        clamped = np.clip(idx, 0, n_rows - 1)
        rows = np.asarray(raw[clamped], dtype=np.float32)
    if rows.shape != want:
        raise IOError(
            f"verify fetch returned shape {rows.shape} for row ids of shape "
            f"{idx.shape} (expected {want}): truncated raw-tier read")
    if out is None or rows is out:
        return rows
    out[...] = rows
    return out
