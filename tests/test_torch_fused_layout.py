"""The fused kernels' staging layout and query interface, on the CPU.

The CUDA kernels (``csrc/fused_query.cu``) stage the α × α MINDIST table
and each level's query words where the plain versions take the per-query
panels, and hold two ring stages of row tiles in shared memory.  What a
CPU can check of that: the table form of C10 is the panel cell bit for
bit, the shared-memory arithmetic (``ops._smem_bytes``, which the kernel's
``Layout`` must equal — ``tests/test_torch_gpu.py`` holds them together on
the card) leaves two blocks per SM at the path's tiles, the streaming
loader's stream-range copy (its 16-byte chunks, the clip at the buffer's
end, the window starts and the stream by multiply and shift) reads what
direct indexing reads, and the wrappers' CPU path, the plain versions fed
through the new interface, answers as the JAX package does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.fastsax import FastSAXConfig, build_index
from repro.kernels import fused_query as jfq
from repro.kernels import ops as jops
from repro_torch.core import cost_model
from repro_torch.core import engine as teng
from repro_torch.data.timeseries import make_wafer_like
from repro_torch.kernels import fused_query as tfq
from repro_torch.kernels import ops, ref

SERVE = dict(block_q=32, n=128, levels=(8, 16), alphabet=10, Q=32)


@pytest.mark.parametrize("alphabet", [3, 10, 16])
@pytest.mark.parametrize("N", [8, 16])
def test_table_form_of_c10_equals_the_panel_cell(alphabet, N):
    # The kernel reads the cell of row symbol a against query word qw as
    # tab[qw·α + a] (staged transposed, so the lanes of a warp read one
    # row of it); ops.query_panels puts tab[a, qw] in panels[q, a, i].
    rng = np.random.default_rng(alphabet * 100 + N)
    qwords = torch.as_tensor(rng.integers(0, alphabet, (5, N)),
                             dtype=torch.int32)
    panels = ops.query_panels(qwords, alphabet).numpy()
    tab = ops.mindist_table_cached(alphabet, "cpu").numpy()
    flat = tab.reshape(-1)
    tab_t = tab.T.copy().reshape(-1)
    for q in range(5):
        for i in range(N):
            qw = int(qwords[q, i])
            for a in range(alphabet):
                cell = panels[q, a, i]
                assert flat[qw * alphabet + a].view(np.int32) \
                    == cell.view(np.int32)
                assert tab_t[qw * alphabet + a].view(np.int32) \
                    == cell.view(np.int32)
    # Symmetric by construction, so the two readings agree everywhere.
    np.testing.assert_array_equal(tab.view(np.int32), tab.T.view(np.int32))
    # The kernel stages qw·α in 16 bits.
    assert (alphabet - 1) * alphabet < 1 << 16


def test_sixteen_bit_offsets_cover_the_largest_alphabet():
    assert (tfq.ALPHABET_MAX - 1) * tfq.ALPHABET_MAX < 1 << 16


@pytest.mark.parametrize("k_sel,quant,want", [
    (0, None, 98_320), (12, None, 109_584),
    (0, "int8", 40_976), (12, "int8", 52_240),
    (0, "bf16", 56_336), (12, "bf16", 67_600)])
def test_serve_tiles_keep_two_stages_and_two_blocks_per_sm(k_sel, quant,
                                                           want):
    s = SERVE
    stages = ops.ring_stages(s["block_q"], s["n"], s["levels"],
                             s["alphabet"], s["Q"], k_sel, quant)
    smem = ops.fused_smem_bytes(s["block_q"], s["n"], s["levels"],
                                s["alphabet"], s["Q"], k_sel, quant)
    assert stages == 2
    assert smem == want
    assert smem <= cost_model.SMEM_PER_SM // 2 - 1024
    assert cost_model.fused_blocks_per_sm(smem) == 2
    assert ops.choose_fused_blocks(s["Q"], 1 << 20, s["n"], s["levels"],
                                   s["alphabet"], k_sel=k_sel,
                                   quant=quant) == (32, 4096)


def test_stage_arithmetic():
    # A stage at serve shapes: norms 256 B, residuals 2 × 256 B, words
    # 64·(8 + 16)·4 B and the rows 64·128·4 B (f32); int8 adds the series
    # error, scale and zero and holds 1-byte codes, words and residuals
    # (each section 128-byte aligned).
    s = SERVE
    one, two = (ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, 0,
                                     stages=k) for k in (1, 2))
    assert two - one == 256 + 2 * 256 + 64 * 24 * 4 + 64 * 128 * 4 == 39_680
    one, two = (ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, 0, "int8",
                                     stages=k) for k in (1, 2))
    assert two - one == 4 * 256 + 2 * 128 + 64 * 24 + 64 * 128 == 11_008
    # The query side in place of the panels: the transposed queries,
    # ‖q‖², ε, ε², the residuals, the table and 16-bit query words.
    query = 128 * 32 * 4 + 3 * 128 + 2 * 128 + 400 + 24 * 32 * 2
    assert one == 11_008 + query
    assert s["alphabet"] * sum(s["levels"]) * s["block_q"] * 4 == 30_720


def test_subseq_topk_tile_keeps_two_blocks_per_sm():
    # subseq-1M's top-k (window 128, stride 4, k_sel 67): the streaming
    # loader's ring takes two stages and keeps two blocks per SM.
    smem = ops.subseq_smem_bytes(32, 128, 4, (8, 16), 10, Q=32, k_sel=67)
    assert smem == 96_528
    assert cost_model.fused_blocks_per_sm(smem) == 2
    assert ops.ring_stages(32, 128, (8, 16), 10, 32, 67,
                           seg_cap=ops.subseq_seg_cap(128, 4)) == 2
    assert ops.choose_subseq_blocks(32, 1_048_080, 128, 4, (8, 16), 10,
                                    k=67) == (32, 4096)


# subseq-1M's stream geometry (S, n_stream, window, stride) and the five of
# tests/test_torch_gpu.py's SUBSEQ_CASES: windows per stream not a
# multiple of 64 (sub-tiles across a stream boundary), a ragged last
# sub-tile, a stride of 1, fewer than 64 windows per stream (two
# boundaries in a sub-tile: read directly) and a stride too long for the
# segment buffer; then one whose buffer ends off a 16-byte boundary, so
# the last chunk of the last sub-tile is clipped.
SUBSEQ_1M = (16, 262_144, 128, 4)
STREAM_GEOMETRIES = [SUBSEQ_1M, (3, 1000, 64, 3), (2, 700, 128, 1),
                     (4, 300, 32, 4), (5, 120, 32, 2), (2, 40_000, 64, 150),
                     (1, 1001, 64, 1)]


def stream_divider(W_s):
    """The launcher's multiplier and shift for row / W_s (csrc
    fused_subseq_launch): ℓ = ⌈log2 W_s⌉, m = ⌈2^(31+ℓ) / W_s⌉."""
    ell = max(0, (W_s - 1).bit_length())
    m = ((1 << (31 + ell)) + W_s - 1) // W_s
    assert m < 1 << 32
    return m, 31 + ell


def window_offsets(rows, W_s, n_stream, stride):
    """Flat offset of each window's first sample (csrc window_offset:
    the stream by the multiplier, not by a divide)."""
    m, shift = stream_divider(W_s)
    rows = np.asarray(rows, np.uint64)
    s = ((rows * np.uint64(m)) >> np.uint64(shift)).astype(np.int64)
    rows = rows.astype(np.int64)
    return s * n_stream + (rows - s * W_s) * stride


@pytest.mark.parametrize("W_s", [1, 2, 3, 45, 267, 313, 938, 65_505,
                                 65_536, 65_537, 2 ** 31 - 1])
def test_stream_divider_is_floor_division(W_s):
    # Every row below 2^31 (the launcher's bound on S·n_stream): rows at
    # and around each multiple of W_s and a random sample.
    m, shift = stream_divider(W_s)
    k = np.arange(0, (2 ** 31 - 1) // W_s + 1,
                  max(1, (2 ** 31 - 1) // W_s // 100_000), dtype=np.uint64)
    rows = (k[:, None] * np.uint64(W_s) + np.array(
        [0, 1, W_s - 1], np.uint64)).ravel()
    rng = np.random.default_rng(W_s)
    rows = np.concatenate([rows, rng.integers(0, 2 ** 31, 100_000,
                                              dtype=np.uint64),
                           np.array([2 ** 31 - 1], np.uint64)])
    rows = rows[rows < 2 ** 31]
    got = (rows * np.uint64(m)) >> np.uint64(shift)
    np.testing.assert_array_equal(got, rows // np.uint64(W_s))


def stage_model(flat, row0, rows, W_s, n_stream, window, stride, seg_cap):
    """One sub-tile's streaming stage as the kernel's stage_windows fills
    it: ``(seg, woff, chunk_bytes)`` — the range copied in 16-byte chunks
    from a0 (the first sample rounded down to 4 floats), each clipped with
    src-size at the end of the flat buffer and zero-filled past it, and
    each window's start relative to a0 (or complemented, when the range
    exceeds the segment buffer and is not staged)."""
    n_samples = flat.size
    first, last = window_offsets(np.array([row0, row0 + rows - 1]), W_s,
                                 n_stream, stride)
    a0 = first & ~3
    need = last + window - a0
    staged = need <= seg_cap
    seg = np.zeros(ops._al128(seg_cap * 4) // 4, flat.dtype)
    chunk_bytes = np.zeros(0, np.int64)
    if staged:
        c = np.arange((need + 3) // 4)
        left = n_samples - (a0 + 4 * c)
        chunk_bytes = np.where(left >= 4, 16, np.where(left > 0, 4 * left, 0))
        assert 16 * c.size <= 4 * seg.size          # inside the section
        src = a0 + 4 * c[:, None] + np.arange(4)
        read = np.arange(4) < chunk_bytes[:, None] // 4
        assert np.all(src[read] < n_samples)        # nothing past the end
        seg[:4 * c.size] = np.where(read, flat[np.minimum(src, n_samples - 1)],
                                    0).ravel()
    tid = np.arange(ops.ROW_TILE)
    o = np.where(tid < rows, window_offsets(row0 + tid, W_s, n_stream,
                                            stride), 0)
    woff = o - a0 if staged else ~o
    return seg, woff, chunk_bytes


@pytest.mark.parametrize("geometry", STREAM_GEOMETRIES)
def test_range_copy_model_equals_direct_indexing(geometry):
    # Every sub-tile of the geometry: the z build's reads (seg[o + j] from
    # the staged range, or the stream at ~o + j) give each window's
    # samples as direct indexing of the streams does.  flat holds its own
    # index + 1, so a zero-filled or wrong element shows.
    S, n_stream, window, stride = geometry
    W_s = (n_stream - window) // stride + 1
    W = S * W_s
    seg_cap = ops.subseq_seg_cap(window, stride)
    flat = np.arange(1, S * n_stream + 1, dtype=np.int64)
    j = np.arange(window)
    seen = {"staged": 0, "direct": 0, "boundary": 0, "clipped": 0}
    for row0 in range(0, W, ops.ROW_TILE):
        rows = min(ops.ROW_TILE, W - row0)
        seg, woff, chunk_bytes = stage_model(flat, row0, rows, W_s,
                                             n_stream, window, stride,
                                             seg_cap)
        o = woff[:rows, None]
        got = np.where(o >= 0, seg[np.clip(o + j, 0, seg.size - 1)],
                       flat[np.clip(~o + j, 0, flat.size - 1)])
        want = flat[window_offsets(row0 + np.arange(rows), W_s, n_stream,
                                   stride)[:, None] + j]
        np.testing.assert_array_equal(got, want)
        # A staged sub-tile reads only copied elements: its windows lie
        # inside the chunks it issued.
        if chunk_bytes.size:
            assert np.all(o + window <= 4 * chunk_bytes.size)
        seen["staged" if chunk_bytes.size else "direct"] += 1
        seen["boundary"] += (row0 + rows - 1) // W_s != row0 // W_s
        seen["clipped"] += int(np.any(chunk_bytes % 16 != 0))
    if W % ops.ROW_TILE:
        assert rows < ops.ROW_TILE                  # the ragged last one
    if geometry == SUBSEQ_1M:
        assert seen["direct"] == 0 and seen["boundary"] == S - 1
    if S > 1 and W_s % ops.ROW_TILE and W_s >= ops.ROW_TILE:
        assert seen["boundary"] > 0
    if W_s < ops.ROW_TILE:                          # two boundaries: direct
        assert seen["direct"] > 0 and seen["staged"] > 0
    if stride == 150:                               # past the buffer
        assert seen["direct"] > 0
    if geometry == (1, 1001, 64, 1):
        assert seen["clipped"] == 1


def test_streaming_stage_arithmetic():
    # A streaming stage at subseq-1M: norms 256 B, residuals 2 × 256 B,
    # words 64·(8 + 16)·4 B, μ, σ and the window starts 3 × 256 B and the
    # stream range, 63·4 + 2·128 + 3 = 511 floats in a 128-byte-aligned
    # section; the 32 KB z tile lies outside the ring, once per block.
    assert ops.subseq_seg_cap(128, 4) == 511
    one, two = (ops.subseq_smem_bytes(32, 128, 4, (8, 16), 10, 32,
                                      stages=k) for k in (1, 2))
    stage = 256 + 2 * 256 + 64 * 24 * 4 + 3 * 256 + 2048
    assert two - one == stage == 9_728
    query = 128 * 32 * 4 + 3 * 128 + 2 * 128 + 400 + 24 * 32 * 2
    assert one == stage + 64 * 128 * 4 + query == 61_456
    assert two == 71_184
    # The top-k form adds the candidates and the lists, nothing shared.
    lists = 32 * 64 * 4 + 2 * 32 * 67 * 4
    assert ops.subseq_smem_bytes(32, 128, 4, (8, 16), 10, 32, 67,
                                 stages=2) == two + lists == 96_528
    # The quantized screen columns: 1-byte words and residual codes
    # (each section 128-byte aligned).
    q8 = (ops.subseq_smem_bytes(32, 128, 4, (8, 16), 10, 32, quant="int8",
                                stages=k) for k in (1, 2))
    assert -(next(q8) - next(q8)) == 256 + 2 * 128 + 64 * 24 + 3 * 256 \
        + 2048 == 4_864
    # The stride-150 geometry caps the range at SEG_MAX floats.
    assert ops.subseq_seg_cap(64, 150) == ops.SEG_MAX


@pytest.mark.parametrize("k_sel,stride,want", [
    (0, 4, 2), (67, 4, 2), (128, 4, 2), (128, 8, 2), (128, 12, 1),
    (0, 150, 1), (67, 150, 2)])
def test_streaming_ring_stages(k_sel, stride, want):
    # Two stages where they keep the blocks per SM one gives: subseq-1M's
    # range and top-k tiles; one where a second stage would cost a block
    # (k_sel 128 from stride 12, the range at stride 150's 32 KB stages);
    # two again where one stage already leaves one block.
    seg_cap = ops.subseq_seg_cap(128, stride)
    got = ops.ring_stages(32, 128, (8, 16), 10, 32, k_sel, None, seg_cap)
    assert got == want
    one, two = (ops.subseq_smem_bytes(32, 128, stride, (8, 16), 10, 32,
                                      k_sel, stages=k) for k in (1, 2))
    bps = cost_model.fused_blocks_per_sm
    assert (bps(two) >= bps(one)) == (want == 2)
    assert ops.subseq_smem_bytes(32, 128, stride, (8, 16), 10, 32,
                                 k_sel) == (two if want == 2 else one)


def test_large_k_sel_takes_one_stage():
    # Over 128-sample rows at k_sel 67 the lists leave no room for a
    # second stage at two blocks per SM: one stage keeps two blocks.
    one = ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, 67, stages=1)
    two = ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, 67, stages=2)
    assert cost_model.fused_blocks_per_sm(one) == 2
    assert cost_model.fused_blocks_per_sm(two) == 1
    assert ops.ring_stages(32, 128, (8, 16), 10, 32, 67) == 1
    assert ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, 67) == one
    # Two stages still fit up to k_sel 33 at serve shapes.
    assert ops.ring_stages(32, 128, (8, 16), 10, 32, 33) == 2
    assert ops.ring_stages(32, 128, (8, 16), 10, 32, 34) == 1


def test_smem_mirror_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="quant"):
        ops.fused_smem_bytes(32, 128, (8, 16), 10, 32, 0, quant="fp8")


# ---------------------------------------------------------------------------
# The wrappers' CPU path through the new interface.
# ---------------------------------------------------------------------------


def small_case(Q, B, levels, alphabet, seed=2):
    db = make_wafer_like(B, 128, seed=seed)
    idx = build_index(db, FastSAXConfig(n_segments=levels, alphabet=alphabet),
                      normalize=False)
    jdev = jeng.device_index_from_host(idx)
    rng = np.random.default_rng(seed)
    q = db[rng.integers(0, B, Q)] + 0.05 * rng.standard_normal((Q, 128))
    jqr = jeng.represent_queries(jnp.asarray(q, jnp.float32), levels,
                                 alphabet, normalize=False)
    tdev = teng.device_index_from_numpy(
        np.asarray(jdev.series), np.asarray(jdev.norms_sq),
        [np.asarray(w) for w in jdev.words],
        [np.asarray(r) for r in jdev.residuals], jdev.levels, jdev.alphabet,
        device="cpu")
    t = lambda a: torch.as_tensor(np.array(a))
    tqr = teng.QueryReprDev(q=t(jqr.q), words=tuple(t(w) for w in jqr.words),
                            residuals=tuple(t(r) for r in jqr.residuals))
    return jdev, jqr, tdev, tqr


@pytest.mark.parametrize("case", [(1, 64, (8,), 3), (4, 200, (8, 16), 10),
                                  (7, 513, (8, 16), 20)])
@pytest.mark.parametrize("stages", [None, 1, 2])
def test_word_interface_answers_as_the_reference(case, stages):
    # The query words through the wrapper (its plain version builds the
    # panels) against the reference's Pallas kernels in interpret mode on
    # their panels: equal answers and partials, d² within the f32 band.
    Q, B, levels, alphabet = case
    jdev, jqr, tdev, tqr = small_case(Q, B, levels, alphabet)
    eps = np.linspace(1.0, 3.0, Q).astype(np.float32)
    jp = tuple(jops.query_panels(w, alphabet) for w in jqr.words)
    want_a, want_d = jfq.fused_range_pallas(
        jdev.series, jdev.norms_sq, jdev.words, jdev.residuals, jqr.q, jp,
        jqr.residuals, jnp.asarray(eps), levels=levels, alphabet=alphabet,
        n=128, block_q=8, block_b=128, interpret=True)
    args = teng._fused_inputs(tdev, tqr, tdev.residuals, torch.as_tensor(eps))
    got_a, got_d = tfq.fused_range(**args, block_b=128, stages=stages)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    both = got_a.numpy()
    want_d = np.asarray(want_d)
    assert np.all(np.abs(got_d.numpy()[both] - want_d[both])
                  <= 1e-3 + 1e-5 * np.abs(want_d[both]))
    jidx, _ = jfq.fused_topk_pallas(
        jdev.series, jdev.norms_sq, jdev.words, jdev.residuals, jqr.q, jp,
        jqr.residuals, jnp.asarray(eps), levels=levels, alphabet=alphabet,
        n=128, k=5, block_q=8, block_b=128, interpret=True)
    tidx, _ = tfq.fused_topk(**args, k=5, block_b=128, stages=stages)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # The CPU path is the plain version on the panels, bit for bit.
    panels = tuple(ops.query_panels(w, alphabet) for w in tqr.words)
    pa, pd = ref.fused_range_ref(
        tdev.series, tdev.norms_sq, tdev.words, tdev.residuals, tqr.q,
        panels, tqr.residuals, torch.as_tensor(eps), levels, 128)
    assert torch.equal(pa, got_a) and torch.equal(pd, got_d)


def test_word_interface_rejects_what_the_kernel_does_not_take():
    _, _, tdev, tqr = small_case(4, 200, (8, 16), 10)
    good = teng._fused_inputs(tdev, tqr, tdev.residuals,
                              torch.full((4,), 2.0))
    with pytest.raises(TypeError, match="q_words"):
        tfq.fused_range(**dict(good, q_words=tuple(w.long()
                                                   for w in tqr.words)))
    with pytest.raises(ValueError, match="q_words"):
        tfq.fused_range(**dict(good, q_words=tqr.words[:1]))
    with pytest.raises(ValueError, match="shape"):
        tfq.fused_range(**dict(good, q_words=(tqr.words[0][:, :4],
                                              tqr.words[1])))
    with pytest.raises(ValueError, match="alphabet"):
        tfq.fused_range(**dict(good, alphabet=300))
    with pytest.raises(ValueError, match="stages"):
        tfq.fused_range(**good, stages=3)
    with pytest.raises(ValueError, match="stages"):
        tfq.fused_topk(**good, k=3, stages=0)
