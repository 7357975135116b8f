"""Hand-written CUDA kernels for Hopper (``csrc/``), their wrappers
(``fused_query.py``), the plain PyTorch versions (``ref.py``) and the
tile chooser (``ops.py``)."""
