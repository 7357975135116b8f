"""FAST_SAX search on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX/Pallas package ``repro`` with the same module layout.
``repro`` stays the reference: every module here names its counterpart,
and the tests in ``tests/test_torch_*.py`` feed the same inputs to both.
This package imports ``torch`` and ``numpy`` only — never ``jax``, never
``repro``.
"""
