"""Index lifecycle on the host, counterpart of ``repro/index``: the
layer between the offline builder (``core/fastsax.py``) and the engines.

  * ``store``     — the persistent columnar format: a manifest and one
                    ``.npy`` per column, sha256 integrity, atomic commit,
                    O(ms) mmap loads; and the raw-tier row fetch;
  * ``mutable``   — generations: append-only delta segments, a tombstone
                    bitmap, ``compact()``; answers always equal a fresh
                    rebuild over the live rows;
  * ``quantized`` — the quantized resident tier;
  * ``sharded``   — one store per shard of the distributed engine
                    (``core/dist_search.py``), full precision or tiered;
  * ``cli``       — ``python -m repro_torch.index.cli build|insert|delete|
                    compact|info|verify``.
"""
from .mutable import MutableIndex
from .store import load_index, save_index, store_info, verify_store

__all__ = [
    "MutableIndex",
    "load_index",
    "save_index",
    "store_info",
    "verify_store",
]
