"""Synthetic wafer-like time series (the benchmark database)."""
