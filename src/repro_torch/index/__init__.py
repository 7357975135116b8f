"""Index layouts on the host: the quantized resident tier
(``quantized.py``) and the raw-tier row fetch (``store.py``)."""
