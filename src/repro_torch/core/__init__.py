"""FAST_SAX core: representations, the host index builder and the
device query engine (PyTorch)."""
