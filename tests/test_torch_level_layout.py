"""The register-resident level kernels' schedules (``csrc/level_ops.cu``)
modelled in PyTorch on the CPU, and the word kernels' interface (the
MINDIST table read through the query word's offsets), against
``core/paa.row_sum`` and the reference's Pallas kernels.

A CUDA kernel cannot run here, so each of its reduction schedules is
written out below as the kernel runs it — the lanes of a warp as a
tensor axis, ``__shfl_down_sync`` as a shift along it (a lane past the
warp keeps its own value), ``tree_sum<W>`` and ``slice_sum`` as their
loops — in float32, one rounding per addition as ``__fadd_rn`` has it.
Every model must equal ``row_sum`` (and so the plain versions of
``kernels/ref.py``) bit for bit at every width its body takes, which is
the argument for the kernels' bit identity before the card holds them to
the plain versions (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Against the reference: its Pallas kernels run in interpret mode, as its
own tests run them, and sum in another order (matrix products), so the
tolerances are the reference's own for its kernels against its oracles
(``tests/test_kernels.py``: 5e-4 relative for linfit in f32, 1e-5 for
MINDIST); C10 decisions may differ only within the f32 band of ε².
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.fused_prune import fused_prune_level_pallas
from repro.kernels.linfit import linfit_residual_sq_pallas
from repro.kernels.mindist import mindist_sq_pallas
from repro_torch.core import polyfit as tpoly
from repro_torch.core.paa import row_sum
from repro_torch.data.timeseries import make_wafer_like
from repro_torch.kernels import level_ops as lo
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import mindist_table_cached

# The fast bodies' widths (csrc ``linfit_fast``, ``word_fast`` and
# ``sqdist_fast``).
LINFIT_FAST_L = (2, 4, 8, 16, 32)
LINFIT_FAST_N_MAX = 32
WORD_FAST_N = (1, 2, 4, 8, 16, 32, 64, 128)
SQDIST_N_MAX = 1024
SQDIST_FAST_N = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def sqdist_body(n: int, dtype=torch.float32, offset: int = 0) -> str:
    """Which body ``level_segment_launch`` gives kernel 11 (csrc
    ``sqdist_fast``): the register body for n a power of two up to
    SQDIST_N_MAX, the segment body otherwise.  Its lanes read single
    elements, so neither the dtype nor where the rows start (``offset``
    bytes past a 16-byte boundary, a multiple of the element size)
    enters."""
    del dtype, offset
    fast = 1 <= n <= SQDIST_N_MAX and n & (n - 1) == 0
    return "registers" if fast else "segment"


def spread(shape, seed):
    """float32 values over many binades, so that two summation orders
    almost surely round differently."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-12, 12, shape))
    return torch.as_tensor(v.astype(np.float32))


# ---------------------------------------------------------------------------
# The schedules, as the kernels run them.
# ---------------------------------------------------------------------------

def tree_sum(v):
    """``tree_sum<W>`` on the last axis (W = its length)."""
    while v.shape[-1] > 1:
        w = v.shape[-1]
        h = w // 2
        head = v[..., :h] + v[..., h:2 * h]
        v = torch.cat([head, v[..., 2 * h:]], dim=-1) if w & 1 else head
    return v[..., 0]


def slice_sum(v, w: int):
    """``slice_sum(v, w)``: a thread's own slice, halved in place."""
    v = v.clone()
    while w > 1:
        h = w >> 1
        for i in range(h):
            v[..., i] = v[..., i] + v[..., i + h]
        if w & 1:
            v[..., h] = v[..., 2 * h]
        w = h + (w & 1)
    return v[..., 0]


def shfl_down(v, h: int):
    """``__shfl_down_sync`` over the lane axis (axis 1, 32 lanes)."""
    out = v.clone()
    out[:, :32 - h] = v[:, h:]
    return out


def word_warp_model(cells, need):
    """``word_kernel<N>``'s warp pass over 32 rows of (32, N) squared
    cells: the lanes' loads, the shuffle steps, the in-lane tree and the
    hand-over of each row's sum to lane = row.  Rows whose ``need`` bit is
    clear contribute zeros.  Returns the 32 rows' sums."""
    N = cells.shape[1]
    V = min(N, 4)
    G, P = N // V, 32 // (N // V)
    lane = torch.arange(32)
    j, k = lane % G, lane // G
    md = torch.zeros(32)
    for st in range(G):
        rr = st * P + k
        c = cells[rr[:, None], (j * V)[:, None] + torch.arange(V)[None, :]]
        c = torch.where(need[rr][:, None], c, torch.zeros_like(c))
        c = c[None]                                   # one warp
        hl = G // 2
        while hl >= 1:
            c = c + shfl_down(c, hl)
            hl //= 2
        total = tree_sum(c[0])
        take = total[(lane % P) * G]
        md = torch.where(lane // P == st, take, md)
    return md


def linfit_warp_model(x, N: int, closed_form):
    """``linfit_kernel<L>`` over (rows, n) f32 rows: a warp holds 32 // N
    rows, lane r·N + s on segment s of row r; each lane's tree sums and
    closed form, then the odd-tail shuffle tree over the row's lanes.
    ``closed_form(sum_y, sum_y2, sxy, L)`` is the segment's residual² as
    the plain version computes it on this device."""
    rows, n = x.shape
    L = n // N
    per_warp = 32 // N
    lane = torch.arange(32)
    r, s = lane // N, lane % N
    out = torch.empty(rows)
    xc = torch.as_tensor((np.arange(L) - (L - 1) / 2.0).astype(np.float32))
    for r0 in range(0, rows, per_warp):
        row = r0 + r
        live = (r < per_warp) & (row < rows)
        seg = torch.zeros(32, L)
        seg[live] = x[row[live]].reshape(-1, N, L)[
            torch.arange(int(live.sum())), s[live]]
        v = closed_form(tree_sum(seg), tree_sum(seg * seg),
                        tree_sum(seg * xc), L)
        v = torch.where(live, v, torch.zeros_like(v))[None]
        w = N
        while w > 1:
            h = w >> 1
            o = shfl_down(v, h)
            v = torch.where((s < h)[None], v + o,
                            torch.where(((s == h) & bool(w & 1))[None], o, v))
            w = h + (w & 1)
        done = live & (s == 0)
        out[row[done]] = v[0, done]
    return out


def sqdist_steps(n: int) -> tuple:
    """``sqdist_kernel<n>``'s constants: (G lanes per row, V elements a
    lane, P rows per step, R steps, all loaded at once: 16 values a lane,
    at least one row, at most a step per lane)."""
    G = min(n, 32)
    V, P = n // G, 32 // G
    return G, V, P, min(G, max(1, 16 // V))


def sqdist_warp_model(x, q, G: int):
    """``sqdist_kernel<n>`` over (rows, n) rows against the (n,) query,
    with G = min(n, 32) lanes a row: a warp takes R·P consecutive rows;
    lane k·G + j loads elements j + v·G of its row r·P + k at every step r
    (zeros past the last row), squares each difference, sums its V values
    with ``tree_sum``, then the row's lanes by ``shfl_down`` (lane j adds
    lane j + h, h = G/2, …, 1) and hands the row's sum to the lane of that
    row.  Returns the rows' sums."""
    rows, n = x.shape
    x, q = x.to(torch.float32), q.to(torch.float32)
    Gn, V, P, R = sqdist_steps(n)
    assert G == Gn
    lane = torch.arange(32)
    j, k = lane % G, lane // G
    cols = j[:, None] + G * torch.arange(V)[None, :]      # (32, V)
    qv = q[cols]
    out = torch.empty(rows)
    for row0 in range(0, rows, R * P):
        live = min(R * P, rows - row0)
        d2 = torch.zeros(32)
        for r in range(R):
            rr = r * P + k
            inside = rr < live
            e = torch.zeros(32, V)
            e[inside] = x[row0 + rr[inside][:, None], cols[inside]]
            d = e - qv
            c = tree_sum(d * d)[None]                    # one warp
            h = G // 2
            while h >= 1:
                c = c + shfl_down(c, h)
                h //= 2
            take = c[0, (lane % P) * G]
            d2 = torch.where(lane // P == r, take, d2)
        out[row0:row0 + live] = d2[:live]
    return out


def plain_closed_form(sum_y, sum_y2, sxy, L):
    """``core/polyfit``'s closed form on this device (the CPU divides)."""
    xc = np.arange(L, dtype=np.float64) - (L - 1) / 2.0
    sxx = float(np.sum(xc * xc))
    mean = sum_y / L
    return torch.clamp(sum_y2 - L * mean * mean - (sxy * sxy) / sxx,
                       min=0.0)


def linfit_generic_model(x, N: int):
    """``linfit_generic_kernel``: one thread per row, each segment's three
    sums and then the row's segment values by ``slice_sum``."""
    rows, n = x.shape
    L = n // N
    if L == 1:
        return torch.zeros(rows)
    segs = x.reshape(rows, N, L)
    xc = torch.as_tensor((np.arange(L) - (L - 1) / 2.0).astype(np.float32))
    per = torch.stack([plain_closed_form(
        slice_sum(segs[:, i], L), slice_sum(segs[:, i] * segs[:, i], L),
        slice_sum(segs[:, i] * xc, L), L) for i in range(N)], dim=1)
    return slice_sum(per, N)


# ---------------------------------------------------------------------------
# Each schedule against row_sum, bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", list(range(1, 33)))
def test_tree_sum_is_row_sum(W):
    v = spread((64, W), W)
    assert torch.equal(tree_sum(v).view(torch.int32),
                       row_sum(v).view(torch.int32))


def test_slice_sum_is_row_sum_at_every_generic_width():
    # The generic bodies halve slices of any width (segment lengths,
    # segment counts, words): 1 to 128, and a long one.
    for w in list(range(1, 129)) + [200, 1024]:
        v = spread((16, w), w)
        assert torch.equal(slice_sum(v, w), row_sum(v)), w


@pytest.mark.parametrize("N", WORD_FAST_N)
def test_word_warp_schedule_is_row_sum(N):
    cells = spread((32, N), N)
    need = torch.ones(32, dtype=torch.bool)
    assert torch.equal(word_warp_model(cells, need), row_sum(cells))


@pytest.mark.parametrize("N", WORD_FAST_N)
def test_word_warp_skips_only_rows_it_does_not_need(N):
    # A row whose C9 (or incoming mask) failed is not read; the others'
    # sums do not change, whatever the skipped rows hold.
    cells = spread((32, N), 100 + N)
    rng = np.random.default_rng(N)
    need = torch.as_tensor(rng.random(32) < 0.5)
    got = word_warp_model(cells, need)
    assert torch.equal(got[need], row_sum(cells)[need])
    assert not got[~need].any()


@pytest.mark.parametrize("N", WORD_FAST_N)
def test_word_warp_lanes_tile_the_rows(N):
    # G steps of P rows take the warp's 32 rows once each, every lane
    # loads whole 4·V-byte runs of its row, and each row's sum reaches
    # the lane of that row.
    V = min(N, 4)
    G, P = N // V, 32 // (N // V)
    lane = np.arange(32)
    seen = np.zeros((32, N), dtype=int)
    for st in range(G):
        rows = st * P + lane // G
        for v in range(V):
            np.add.at(seen, (rows, (lane % G) * V + v), 1)
    assert (seen == 1).all()
    src = (lane % P) * G
    assert ((lane // P) * P + src // G == lane).all()


@pytest.mark.parametrize("n", SQDIST_FAST_N)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sqdist_warp_schedule_is_the_plain_version(n, dtype):
    # 70 rows: two whole warps and a ragged third; rows and query over many
    # binades, so that another summation order would show.
    x = spread((70, n), n).to(dtype)
    q = spread((n,), 1000 + n).to(dtype)
    got = sqdist_warp_model(x, q, min(n, 32))
    assert torch.equal(got.view(torch.int32),
                       tref.sqdist_ref(x, q).view(torch.int32))
    # A float32 query against the rows: both upcast, the same schedule.
    q32 = spread((n,), 2000 + n)
    assert torch.equal(sqdist_warp_model(x, q32, min(n, 32)),
                       tref.sqdist_ref(x, q32))


@pytest.mark.parametrize("n", SQDIST_FAST_N)
def test_sqdist_warp_lanes_tile_the_rows(n):
    # R steps take each of the warp's R·P rows once with all n elements,
    # 16 values a lane (a row's V where V > 16); a warp-wide load reads one
    # contiguous run of each of its P rows; each row's sum reaches the
    # lane of that row.
    G, V, P, R = sqdist_steps(n)
    assert R * V == max(16, V) or R == G
    lane = np.arange(32)
    j, k = lane % G, lane // G
    seen = np.zeros((R * P, n), dtype=int)
    for r in range(R):
        for v in range(V):
            np.add.at(seen, (r * P + k, j + v * G), 1)
            # one load instruction: P runs of G consecutive elements
            assert (np.diff((j + v * G)[:G]) == 1).all()
    assert (seen == 1).all()
    src = (lane % P) * G
    take = lane < R * P
    assert ((lane // P) * P + src // G == lane)[take].all()


def test_sqdist_contiguous_layout_needs_more_shuffles():
    # At n = 128 the strided layout (lane j holds j, j + 32, j + 64,
    # j + 96) runs row_sum's two top steps in the lane and its last five
    # as one value's shuffles; lane j holding 4j … 4j + 3 (one 16-byte
    # load) would shuffle all four values at the five steps h ≥ 4.
    n, G = 128, 32
    V = n // G
    steps = [n >> s for s in range(1, 8)]                # h = 64, …, 1
    strided = sum(1 for h in steps if h < G)             # one value each
    contiguous = sum(V for h in steps if h >= V)
    assert (strided, contiguous) == (5, 20)


@pytest.mark.parametrize("n", [1, 3, 16, 64, 96, 100, 128, 256, 1024])
def test_sqdist_dispatch_by_width(n):
    fast = n in SQDIST_FAST_N
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        for offset in (0, size, 4):
            assert sqdist_body(n, dtype, offset) == (
                "registers" if fast else "segment")
    assert sqdist_body(2 * SQDIST_N_MAX) == "segment"


@pytest.mark.parametrize("L", LINFIT_FAST_L)
@pytest.mark.parametrize("N", [1, 2, 3, 5, 8, 12, 16, 24, 31, 32])
def test_linfit_warp_schedule_is_the_plain_version(L, N):
    # Odd N leaves idle lanes at the end of the warp and odd tails in the
    # shuffle tree; rows past B are masked.
    x = torch.as_tensor(make_wafer_like(37, L * N, seed=L + N),
                        dtype=torch.float32)
    got = linfit_warp_model(x, N, plain_closed_form)
    assert torch.equal(got, tpoly.linfit_residual_sq(x, N))


@pytest.mark.parametrize("n,N", [(96, 8), (96, 32), (128, 1), (1024, 8),
                                 (128, 128), (384, 3), (64, 64)])
def test_linfit_generic_schedule_is_the_plain_version(n, N):
    # Segment lengths 12, 3, 128, 1 (an exact fit: 0) and N > 32.
    x = torch.as_tensor(make_wafer_like(19, n, seed=n + N),
                        dtype=torch.float32)
    assert torch.equal(linfit_generic_model(x, N),
                       tpoly.linfit_residual_sq(x, N))


# ---------------------------------------------------------------------------
# The interface: the table and the query word's offsets.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alphabet", list(range(3, 21)))
def test_table_form_is_the_panel_cell(alphabet):
    # The kernels read tab[w, q_i] as tabT[q_i·α + w] of the transposed
    # table; that is the panel's cell tq[w, i], bit for bit.
    rng = np.random.default_rng(alphabet)
    qword = rng.integers(0, alphabet, 16)
    qword[0], qword[-1] = 0, alphabet - 1
    tabT = mindist_table_cached(alphabet, "cpu").t().contiguous().flatten()
    qoff = lo.query_offsets(qword, alphabet)
    assert qoff.dtype == np.uint16
    assert (qoff == qword * alphabet).all()
    cells = tabT[torch.as_tensor(qoff.astype(np.int64))[None, :]
                 + torch.arange(alphabet)[:, None]]
    tq = lo.query_table(qword, alphabet)
    assert torch.equal(cells.view(torch.int32), tq.view(torch.int32))
    np.testing.assert_array_equal(
        tq.numpy(), np.asarray(jops.query_table(jnp.asarray(qword),
                                                alphabet)))


def level_words(B, N, alphabet, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, alphabet, (B, N)).astype(np.int32)
    words[0], words[-1] = 0, alphabet - 1
    return words, rng.integers(0, alphabet, N)


# Fast widths (powers of two up to 128) and generic ones (12, 200).
WORD_SHAPES = [(1, 10), (2, 5), (4, 20), (8, 10), (16, 10), (16, 3),
               (128, 7), (12, 10), (200, 20)]


@pytest.mark.parametrize("N,alphabet", WORD_SHAPES)
def test_mindist_sq_matches_pallas_interpret(N, alphabet):
    B, n = 256, 8 * N
    words, qword = level_words(B, N, alphabet, N)
    got = lo.mindist_sq(torch.as_tensor(words), qword, n, alphabet)
    tq = jnp.asarray(lo.query_table(qword, alphabet).numpy())
    want = np.asarray(mindist_sq_pallas(jnp.asarray(words), tq, n, alphabet,
                                        block_b=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,alphabet", WORD_SHAPES)
@pytest.mark.parametrize("eps", [0.5, 4.0])
def test_prune_level_matches_pallas_interpret(N, alphabet, eps):
    B, n = 256, 8 * N
    words, qword = level_words(B, N, alphabet, 7 * N)
    rng = np.random.default_rng(N)
    alive = rng.random(B) < 0.8
    res = (rng.random(B) * 3).astype(np.float32)
    res[5] = 1e30                                  # PAD_RESIDUAL dies
    qres = 1.25
    got = lo.prune_level(torch.as_tensor(alive), torch.as_tensor(res),
                         torch.as_tensor(words), qword, qres, eps, n,
                         alphabet).numpy()
    tq = jnp.asarray(lo.query_table(qword, alphabet).numpy())
    want = np.asarray(fused_prune_level_pallas(
        jnp.asarray(alive), jnp.asarray(res), jnp.asarray(words), tq,
        jnp.float32(qres), jnp.float32(eps), n, alphabet, block_b=128,
        interpret=True))
    assert not got[5] and not (got & ~alive).any()
    # Equal except rows whose C10 bound lies within the f32 band of ε²
    # (the two sums run in different orders).
    tab = mindist_table_cached(alphabet, "cpu").double().numpy()
    md2 = (n / N) * np.sum(tab[words, qword[None, :]] ** 2, -1)
    near = np.abs(md2 - eps * eps) <= 1e-5 * max(1.0, eps * eps)
    assert not ((got != want) & ~near).any()


@pytest.mark.parametrize("L", [1, 2, 3, 8, 12, 16, 32, 128])
def test_linfit_matches_pallas_interpret(L):
    # n = 384: every L above divides it; L = 16 and 32 (N = 24 and 12)
    # take the register body, the others (N > 32, or L not a power of two)
    # the generic one.
    n, B = 384, 256
    N = n // L
    x = make_wafer_like(B, n, seed=L).astype(np.float32)
    tx = torch.as_tensor(x)
    got = lo.linfit_residual_sq(tx, N)
    fast = L in LINFIT_FAST_L and N <= LINFIT_FAST_N_MAX
    model = (linfit_warp_model(tx, N, plain_closed_form) if fast
             else linfit_generic_model(tx, N))
    assert torch.equal(got, model)                 # bitwise: the plain version
    want = np.asarray(linfit_residual_sq_pallas(jnp.asarray(x), N,
                                                block_b=128, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-3)


def test_word_wrappers_check_the_query_word():
    words = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="leaves"):
        lo.query_offsets(np.full(8, 10), 10)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        lo.query_offsets(np.zeros((2, 4), np.int32), 10)
    with pytest.raises(ValueError, match="alphabet"):
        lo.mindist_sq(words, np.zeros(8, np.int32), 64, 21)
    # The kernels' cap on the word's length binds on the card only; the
    # plain version takes any length.
    long = torch.ones((2, lo.WORD_N_MAX + 1), dtype=torch.int32)
    got = lo.mindist_sq(long, np.full(lo.WORD_N_MAX + 1, 4), lo.WORD_N_MAX + 1,
                        10)
    cell = float(mindist_table_cached(10, "cpu")[1, 4])
    np.testing.assert_allclose(got.numpy(), cell * cell * (lo.WORD_N_MAX + 1),
                               rtol=1e-5)
    # A query word given as a tensor is read as the same word.
    qword = np.arange(8) % 10
    assert (lo.query_offsets(torch.as_tensor(qword), 10)
            == lo.query_offsets(qword, 10)).all()
