"""Synthetic wafer-like and trending time series (the benchmark
databases) and the FAST_SAX near-duplicate curation filter."""
