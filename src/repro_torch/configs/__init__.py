"""Architecture registry, counterpart of ``repro/configs``: one module per
architecture, each exporting ``CONFIG`` (the exact published config) and
``smoke()`` (a reduced same-family variant for CPU tests).  ``get(name)``
/ ``smoke(name)`` / ``list_archs()`` serve the launcher's ``--arch``.
The configs are plain data; the port keeps its own copy."""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen3_32b",
    "phi3_medium_14b",
    "granite_3_2b",
    "granite_8b",
    "zamba2_1p2b",
    "mixtral_8x22b",
    "qwen3_moe_235b_a22b",
    "llama32_vision_11b",
    "whisper_medium",
    "mamba2_2p7b",
)

# CLI ids (hyphenated, as assigned) → module names
_ALIASES = {
    "qwen3-32b": "qwen3_32b",
    "phi3-medium-14b": "phi3_medium_14b",
    "granite-3-2b": "granite_3_2b",
    "granite-8b": "granite_8b",
    "zamba2-1.2b": "zamba2_1p2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-medium": "whisper_medium",
    "mamba2-2.7b": "mamba2_2p7b",
}

ARCH_IDS = tuple(_ALIASES)


def _module(name: str):
    mod = _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f".{mod}", __name__)


def get(name: str):
    """Full published config for an architecture id."""
    return _module(name).CONFIG


def smoke(name: str):
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke()


def list_archs():
    return ARCH_IDS
