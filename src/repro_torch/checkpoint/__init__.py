"""Checkpointing, counterpart of ``repro/checkpoint``: per-leaf ``.npy``
files and a JSON manifest, an async writer, integrity hashes and atomic
commit, in the reference's format (each package reads the other's), and
the model's parameters and optimizer state in the reference's layout,
sharded over a mesh or not (an elastic restore reshards onto any mesh)."""
from .manager import (CheckpointManager, latest_step, restore_pytree,
                      save_pytree)
from .layout import (params_to_tree, sharded_checkpoint_like,
                     state_from_tree, state_to_tree)
