"""The port's benchmark: one cell of ``BENCHMARK.json`` a run, driven by
the files under ``configs/``, ``workloads/`` and ``metrics/``."""
