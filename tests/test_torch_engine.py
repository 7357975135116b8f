"""The port's query engine against the reference engine, on one index.

The reference's device index and query representation are carried across
as numpy arrays (``engine.device_index_from_numpy``), so the two engines
are compared on the same inputs, apart from anything in the build.  Both
run on the CPU; the reference's fused engine runs its Pallas kernels in
interpret mode.

Tolerances: k-NN indices must be equal (ties go to the lower index in
both).  d² within ``1e-3 + 1e-5·d²``, the order of the engine's top-k tie
window: the matmul-form verify cancels terms of size ~n for z-normalised
series, so two f32 summation orders differ there by ~1e-5.  Range answer
sets must be equal except on rows whose d² lies in that band around ε²;
such rows are counted and the grid must have none.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.fastsax import FastSAXConfig, build_index
from repro_torch.core import engine as teng
from repro_torch.core.options import SearchOptions
from repro_torch.data.timeseries import make_queries, make_wafer_like

# (Q, B, levels, alphabet): the FUSED_GRID of tests/test_kernels.py and
# the serving configuration at test size.
GRID = [
    (1, 64, (8,), 3),
    (4, 200, (8, 16), 10),
    (7, 513, (8, 16), 20),
    (8, 512, (8, 16), 10),
]


def band(d2):
    return 1e-3 + 1e-5 * np.abs(d2)


def make_case(Q, B, levels, alphabet, seed=2):
    db = make_wafer_like(B, 128, seed=seed)
    idx = build_index(db, FastSAXConfig(n_segments=levels, alphabet=alphabet),
                      normalize=False)
    jdev = jeng.device_index_from_host(idx)
    q = make_queries(db, Q, seed=seed + 1)
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


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_dense_range(got_a, got_d, want_a, want_d, eps):
    got_a, got_d, want_a, want_d = map(np_, (got_a, got_d, want_a, want_d))
    eps2 = np.broadcast_to(np.asarray(eps, np.float32) ** 2,
                           (got_a.shape[0],))[:, None]
    d_ref = np.where(np.isfinite(want_d), want_d, got_d)
    in_band = np.abs(d_ref - eps2) <= band(eps2)
    differ = got_a != want_a
    assert int((differ & ~in_band).sum()) == 0
    assert int((differ & in_band).sum()) == 0, "boundary rows on the grid"
    both = got_a & want_a
    assert np.all(np.abs(got_d[both] - want_d[both]) <= band(want_d[both]))


def answer_sets(idx, ans):
    idx, ans = np_(idx), np_(ans)
    return [sorted(idx[i][ans[i]].tolist()) for i in range(idx.shape[0])]


def assert_knn(got, want, k_check_exact=True):
    gi, gd, ge = map(np_, got)
    wi, wd, we = map(np_, want)
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    assert np.all(np.abs(gd[fin] - wd[fin]) <= band(wd[fin]))
    if k_check_exact:
        np.testing.assert_array_equal(ge, we)


@pytest.mark.parametrize("case", GRID)
def test_range_engines(case):
    jdev, jqr, tdev, tqr = make_case(*case)
    Q = case[0]
    eps = np.linspace(1.0, 3.0, Q).astype(np.float32)
    assert_dense_range(*teng.range_query(tdev, tqr, torch.as_tensor(eps)),
                       *jeng.range_query(jdev, jqr, jnp.asarray(eps)), eps)
    # Scalar ε, the compact two-phase form and its dense fallback.
    for cap in (8, 256):
        gi, ga, gd = teng.range_query_auto(tdev, tqr, 2.0, cap)
        wi, wa, wd = jeng.range_query_auto(jdev, jqr, jnp.float32(2.0), cap)
        assert np_(gi).shape == np_(wi).shape
        assert answer_sets(gi, ga) == answer_sets(wi, wa)
        gc = teng.range_query_compact(tdev, tqr, 2.0, cap)
        wc = jeng.range_query_compact(jdev, jqr, jnp.float32(2.0), cap)
        np.testing.assert_array_equal(np_(gc[3]), np_(wc[3]))
        np.testing.assert_array_equal(np_(gc[0]), np_(wc[0]))


@pytest.mark.parametrize("case", GRID)
@pytest.mark.parametrize("k", [1, 5])
def test_knn_engines(case, k):
    jdev, jqr, tdev, tqr = make_case(*case)
    assert_knn(teng.knn_query_auto(tdev, tqr, k),
               jeng.knn_query_auto(jdev, jqr, k))
    # A fixed capacity too small for the survivors: same certificates.
    assert_knn(teng.knn_query(tdev, tqr, k, capacity=k),
               jeng.knn_query(jdev, jqr, k, capacity=k))


@pytest.mark.parametrize("case", GRID[1:])
def test_mixed_engines(case):
    Q = case[0]
    jdev, jqr, tdev, tqr = make_case(*case)
    k = 3
    eps = np.linspace(1.0, 3.0, Q).astype(np.float32)
    is_knn = np.array([i % 2 == 0 for i in range(Q)])
    targs = (tdev, tqr, torch.as_tensor(eps), torch.as_tensor(is_knn), k)
    jargs = (jdev, jqr, jnp.asarray(eps), jnp.asarray(is_knn), k)
    outs = {
        "compact": (teng.mixed_query(*targs, 64), jeng.mixed_query(*jargs, 64)),
        "auto": (teng.mixed_query_auto(*targs), jeng.mixed_query_auto(*jargs)),
        "dense": (teng.mixed_query_dense(*targs),
                  jeng.mixed_query_dense(*jargs)),
    }
    for name, (got, want) in outs.items():
        np.testing.assert_array_equal(np_(got[3]), np_(want[3]))
        gki, gkd = teng.mixed_topk(got[0], got[2], k)
        wki, wkd = jeng.mixed_topk(want[0], want[2], k)
        gs, ws = answer_sets(got[0], got[1]), answer_sets(want[0], want[1])
        for i in range(Q):
            if is_knn[i]:
                np.testing.assert_array_equal(np_(gki)[i], np_(wki)[i])
                assert np.all(np.abs(np_(gkd)[i] - np_(wkd)[i])
                              <= band(np_(wkd)[i])), name
            else:
                assert gs[i] == ws[i], name


@pytest.mark.parametrize("case", GRID[1:3])
def test_fused_engines_match_pallas_engines(case):
    Q = case[0]
    jdev, jqr, tdev, tqr = make_case(*case)
    eps = np.linspace(1.0, 3.0, Q).astype(np.float32)
    # The port's CUDA tile shapes (block_b = 128) keep the reference's
    # top-k layout, so the certificates are comparable too.
    assert_dense_range(
        *teng.range_query_fused(tdev, tqr, torch.as_tensor(eps)),
        *jeng.range_query_pallas(jdev, jqr, jnp.asarray(eps), block_q=8,
                                 block_b=128, interpret=True), eps)
    for k in (1, 5):
        assert_knn(teng.knn_query_fused(tdev, tqr, k, block_b=128),
                   jeng.knn_query_pallas(jdev, jqr, k, block_q=8,
                                         block_b=128, interpret=True))
    k = 3
    is_knn = np.array([i % 2 == 1 for i in range(Q)])
    got = teng.mixed_query_fused(tdev, tqr, torch.as_tensor(eps),
                                 torch.as_tensor(is_knn), k, block_b=128)
    want = jeng.mixed_query_pallas(jdev, jqr, jnp.asarray(eps),
                                   jnp.asarray(is_knn), k, block_q=8,
                                   block_b=128, interpret=True)
    gki, _ = teng.mixed_topk(got[0], got[2], k)
    wki, _ = jeng.mixed_topk(want[0], want[2], k)
    np.testing.assert_array_equal(np_(gki)[is_knn], np_(wki)[is_knn])
    assert_dense_range(np_(got[1])[~is_knn], np_(got[2])[~is_knn],
                       np_(want[1])[~is_knn], np_(want[2])[~is_knn],
                       eps[~is_knn])
    assert not bool(got[3].any())


def test_compact_answers_matches_reference():
    jdev, jqr, tdev, tqr = make_case(4, 200, (8, 16), 10)
    ans, d2 = teng.range_query(tdev, tqr, 3.0)
    for cap in (2, 64):
        got = teng.compact_answers(ans, d2, cap)
        want = jeng.compact_answers(jnp.asarray(ans.numpy()),
                                    jnp.asarray(d2.numpy()), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np_(g), np_(w))


def test_backend_dispatch_and_options():
    _, _, tdev, tqr = make_case(4, 200, (8, 16), 10)
    assert teng.resolve_backend("auto", "cpu") == "torch"
    assert teng.resolve_backend("auto", "cuda") == "cuda"
    assert teng.resolve_backend("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError, match="backend"):
        teng.resolve_backend("pallas", "cpu")
    # The reference's demotion rule: k + 4 > 100 leaves the fused path.
    assert teng.resolve_knn_backend("cuda", 96, "cuda") == "cuda"
    assert teng.resolve_knn_backend("cuda", 97, "cuda") == "torch"
    eps = torch.full((4,), 2.0)
    is_knn = torch.tensor([True, False, True, False])
    for be in ("torch", "cuda"):
        opts = SearchOptions(backend=be)
        a, _ = teng.range_query_backend(tdev, tqr, eps, opts)
        i, _, e = teng.knn_query_backend(tdev, tqr, 3, opts)
        m = teng.mixed_query_backend(tdev, tqr, eps, is_knn, 3, opts)
        assert bool(e.all()) and a.shape == (4, 200)
        if be == "torch":
            base = (a, i, teng.mixed_topk(m[0], m[2], 3)[0])
        else:
            assert torch.equal(a, base[0]) and torch.equal(i, base[1])
            np.testing.assert_array_equal(
                teng.mixed_topk(m[0], m[2], 3)[0].numpy()[is_knn.numpy()],
                base[2].numpy()[is_knn.numpy()])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        teng.knn_query_backend(tdev, tqr, 3, backend="torch", capacity=8)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    with pytest.raises(NotImplementedError, match="quantized"):
        teng.knn_query_backend(tdev, tqr, 3, SearchOptions(quantization="int8"))
