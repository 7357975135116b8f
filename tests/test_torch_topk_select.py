"""The top-k selection's oracle and the occupancy it must keep.

``ref.block_topk`` is what the card tests hold every top-k kernel's
partials to, bit for bit (``tests/test_torch_gpu.py``, at the open radius
ε = 1e28).  Here it is held against the reference's own selection,
``repro.kernels.fused_query._topk_select`` (the unrolled min/argmin sweep
the Pallas top-k kernels run, a plain ``jnp`` function), on the same
numpy matrices: idx and values must be equal exactly.  The second half
checks that the top-k form keeps two thread blocks per SM at the path's
tiles, the constraint the CUDA selection lives within.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_query as jfq
from repro_torch.core import cost_model
from repro_torch.kernels import ops, ref

# (k_sel, block_b) with k_sel ≤ block_b.
SELECT_GRID = [(k, bb) for k in (1, 9, 67, 128) for bb in (64, 1024, 4096)
               if k <= bb]
PATTERNS = ["distinct", "ties", "sparse"]


def values(pattern: str, Q: int, B: int, block_b: int, seed: int):
    """(Q, B) float32 d² matrices: distinct values; heavy ties (eight
    levels, so equal values are the rule); or mostly +inf, with one
    block holding only three finite values (fewer than k_sel)."""
    rng = np.random.default_rng(seed)
    if pattern == "ties":
        d = rng.integers(0, 8, (Q, B)).astype(np.float32) * np.float32(0.25)
    else:
        d = rng.random((Q, B), dtype=np.float32) * np.float32(16.0)
    if pattern == "sparse":
        d[rng.random((Q, B)) < 0.8] = np.inf
        d[:, block_b:2 * block_b] = np.inf
        d[:, block_b + 7:block_b + 10] = np.float32(0.5)
    return d


def reference_partials(d, k: int, block_b: int):
    """``_topk_select`` per block of ``block_b`` columns, the ragged last
    block padded with +inf as the reference pads masked rows; laid out as
    ``block_topk``'s (Q, nb·k)."""
    Q, B = d.shape
    nb = -(-B // block_b)
    pad = np.full((Q, nb * block_b), np.inf, np.float32)
    pad[:, :B] = d
    vals, idxs = [], []
    for b in range(nb):
        v, i = jfq._topk_select(jnp.asarray(pad[:, b * block_b:
                                                (b + 1) * block_b]),
                                b * block_b, k)
        vals.append(np.asarray(v))
        idxs.append(np.asarray(i))
    return np.concatenate(idxs, axis=1), np.concatenate(vals, axis=1)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("k,block_b", SELECT_GRID)
def test_block_topk_equals_reference_selection(k, block_b, pattern):
    Q, B = 3, 2 * block_b + 37                 # a ragged last block
    d = values(pattern, Q, B, block_b, seed=k * 7 + block_b)
    wi, wd = reference_partials(d, k, block_b)
    gi, gd = ref.block_topk(torch.as_tensor(d), k, block_b)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(gd.numpy().view(np.int32),
                                  wd.astype(np.float32).view(np.int32))
    # Empty slots are (+inf, −1), and only they.
    np.testing.assert_array_equal(gi.numpy() < 0, ~np.isfinite(gd.numpy()))


# The path's tiles at Q = 32, n = 128, levels (8, 16), alphabet 10:
# subseq-1M's top-k (window 128, stride 4, k_sel 67) and serve-1M's
# (k_sel 9, and 12 for the served k bucket 8 plus the guard of 4).
PATH_TILES = [("subseq-1M", 67, 4), ("serve-1M", 9, 0), ("serve-1M", 12, 0)]


def topk_smem(k_sel: int, stride: int) -> int:
    if stride:
        return ops.subseq_smem_bytes(32, 128, stride, (8, 16), 10, Q=32,
                                     k_sel=k_sel)
    return ops.fused_smem_bytes(32, 128, (8, 16), 10, Q=32, k_sel=k_sel)


@pytest.mark.parametrize("cell,k_sel,stride", PATH_TILES)
def test_topk_tile_keeps_two_blocks_per_sm(cell, k_sel, stride):
    if stride:
        tile = ops.choose_subseq_blocks(32, 1_048_080, 128, stride, (8, 16),
                                        10, k=k_sel)
    else:
        tile = ops.choose_fused_blocks(32, 1 << 20, 128, (8, 16), 10,
                                       k_sel=k_sel)
    assert tile == (32, 4096)
    assert cost_model.blocks_per_sm(topk_smem(k_sel, stride)) == 2


def test_selection_adds_no_shared_memory():
    # The lists (Q·k_sel·8 bytes) and the candidates' section are all the
    # top-k form adds to the range form's layout (both with the streaming
    # loader's two ring stages): at subseq-1M that is 96,528 bytes,
    # 18,672 short of falling to one block per SM.
    smem = topk_smem(67, 4)
    assert smem == 96_528
    range_smem = ops.subseq_smem_bytes(32, 128, 4, (8, 16), 10, Q=32)
    lists = 2 * 32 * 67 * 4
    cand = 32 * ops.ROW_TILE * 4
    assert smem == range_smem + lists + cand
    assert cost_model.SMEM_PER_SM // (smem + 1024) == 2
    assert cost_model.SMEM_PER_SM // (smem + 18_672 + 1024) == 2
    assert cost_model.SMEM_PER_SM // (smem + 18_673 + 1024) == 1
