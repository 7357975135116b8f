"""The port's LM serving path (``repro_torch.models``, ``configs`` and the
launcher's LM mode) against the reference ``repro.models`` on the CPU.

Every architecture runs at its smoke size, in f32 and in its own dtype,
bf16: the reference's ``init_params(PRNGKey(0))`` goes into the port
through ``params_from_numpy``, the same numpy tokens (and memory for
vlm/encdec) go through both packages, and ``forward_hidden``, the
``prefill`` logits and two ``decode_step``s must agree.  In f32 within
the reference's own serving tolerance, 2e-3 rtol/atol
(``tests/test_arch_smoke.py``); the observed gaps are ~1e-5, the two
packages summing in other orders.  In bf16 within the reference's own
gap between its serving path and its full forward (see
``test_serving_path_matches_reference_bf16``).  Attention and the SSD
scan are held at 2e-4, as the reference holds its own flash against its
naive attention; the MoE at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.runtime.sharding import single_device
from repro_torch import configs
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import make_test_parallelism
from repro_torch.models import layers, moe, ssm
from repro_torch.models import transformer as tf

PAR = single_device()
TOL = dict(rtol=2e-3, atol=2e-3)


def to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def f32_pair(arch, **changes):
    """The reference's and the port's smoke config of ``arch`` in f32."""
    ref_cfg = dataclasses.replace(ref_configs.smoke(arch), dtype="float32",
                                  remat="none", **changes)
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              remat="none", **changes)
    return ref_cfg, cfg


def shared_params(ref_cfg, cfg):
    """The reference's init as numpy, loaded into the port.  The VLM's
    cross-block gates start at 0 (tanh 0 = 0 hides the cross path), so
    they are set to ±0.5 in both."""
    tree = to_numpy(ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    if cfg.kind == "vlm":
        n = cfg.n_cross
        tree["cross_layers"]["gate_attn"] = np.full(n, 0.5, np.float32)
        tree["cross_layers"]["gate_mlp"] = np.full(n, -0.5, np.float32)
    return tree, tf.params_from_numpy(cfg, tree, "cpu")


def memory_for(cfg, B, rng):
    if cfg.kind == "encdec":
        return rng.standard_normal((B, cfg.enc_seq, cfg.d_model),
                                   dtype=np.float32)
    if cfg.kind == "vlm":
        return rng.standard_normal((B, cfg.img_tokens, cfg.d_model),
                                   dtype=np.float32)
    return None


def t(a):
    return None if a is None else torch.as_tensor(a)


def bf16_pair(arch):
    """The reference's and the port's smoke config of ``arch`` in their
    own dtype, bf16."""
    ref_cfg = dataclasses.replace(ref_configs.smoke(arch), remat="none")
    cfg = dataclasses.replace(configs.smoke(arch), remat="none")
    assert ref_cfg.dtype == cfg.dtype == "bfloat16"
    return ref_cfg, cfg


def as_reference_dtypes(ref_cfg, tree):
    """The numpy tree cast back to the dtypes of the reference's init
    (bf16 -> f32 -> bf16 is lossless)."""
    like = jax.eval_shape(lambda: ref_tf.init_params(jax.random.PRNGKey(0),
                                                     ref_cfg))
    return jax.tree_util.tree_map(
        lambda a, r: jnp.asarray(a).astype(r.dtype), tree, like)


def serve_both(ref_cfg, cfg, S=15, extra=2, B=2, compiler_options=None):
    """The same tokens (and memory) through both packages' serving paths:
    ``forward_hidden``, the ``prefill`` logits and ``extra`` decode steps.
    Returns ``(ref, port)``, each a dict of f32 numpy arrays: ``h`` the
    hidden states, ``full`` the logits of the full forward (B, S+extra,
    V), ``serve`` the prefill logits then each decode step's (B, V)."""
    tree, model = shared_params(ref_cfg, cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + extra)).astype(np.int32)
    mem = memory_for(cfg, B, rng)

    def reference(p, x, m):      # one compile for the whole serving path
        h = ref_tf.forward_hidden(ref_cfg, PAR, p, x, memory=m)[0]
        full = (h @ p["lm_head"]).astype(jnp.float32)
        lg, cache = ref_tf.prefill(ref_cfg, PAR, p, x[:, :S], memory=m,
                                   max_seq=S + extra)
        out = [lg]
        for j in range(extra):
            lg, cache = ref_tf.decode_step(ref_cfg, PAR, p, cache,
                                           x[:, S + j:S + j + 1])
            out.append(lg)
        return h, full, out

    p = as_reference_dtypes(ref_cfg, tree)
    want_h, want_full, want = jax.jit(reference).lower(p, toks, mem).compile(
        compiler_options=compiler_options)(p, toks, mem)
    ref = dict(h=np.asarray(want_h.astype(jnp.float32)),
               full=np.asarray(want_full),
               serve=[np.asarray(w) for w in want])

    tt = torch.as_tensor(toks, dtype=torch.long)
    with torch.inference_mode():
        h, aux = tf.forward_hidden(model, tt, t(mem))
        assert h.shape == (B, S + extra, cfg.d_model)
        assert str(h.dtype).removeprefix("torch.") == str(want_h.dtype)
        got = [tf.prefill(model, tt[:, :S], t(mem), max_seq=S + extra)]
        tcache = got[0][1]
        for j in range(extra):
            got.append(tf.decode_step(model, tcache, tt[:, S + j:S + j + 1]))
        port = dict(h=h.float().numpy(),
                    full=tf.logits_of(model, h).numpy(),
                    serve=[lg.numpy() for lg, _ in got])
    assert tcache["pos"] == S + extra
    for lg in port["serve"]:
        assert lg.shape == (B, cfg.vocab_size)
    return ref, port


@pytest.mark.parametrize("arch", configs.list_archs())
def test_serving_path_matches_reference(arch):
    S, extra = 15, 2
    ref, port = serve_both(*f32_pair(arch), S=S, extra=extra)
    assert port["h"].dtype == np.float32
    np.testing.assert_allclose(port["h"], ref["h"], **TOL)
    for j in range(extra + 1):
        np.testing.assert_allclose(port["serve"][j], ref["serve"][j], **TOL)
        # ... and the port's own serving path against its full forward
        np.testing.assert_allclose(port["serve"][j],
                                   port["full"][:, S - 1 + j], **TOL)


# The reference compiled so that it rounds wherever its code casts: by
# default XLA may keep a fused bf16 intermediate in f32, and then the
# reference no longer computes the function its code states.
EXACT_ROUNDING = {"xla_allow_excess_precision": False}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_serving_path_matches_reference_bf16(arch):
    """Each architecture in its own dtype, bf16, on the reference's
    weights: the port rounds where the reference rounds.

    The tolerance is the reference's own gap in bf16, measured here: its
    prefill and decode logits against its full forward at the same
    positions, over max |logit|.  Two bf16 paths through the same
    function differ by this much from summation order alone, so the port
    may differ from the reference by no more.  Measured on the CPU
    (``python tests/test_torch_lm.py`` prints them): the reference's gap
    6.0e-3 to 1.8e-2; the port's 0 for eight archs, 4.1e-3 for mixtral
    (a one-ulp bf16 flip in an expert's product), 6e-5 for the VLM, whose
    stack runs in f32 after its first gated cross block, as the
    reference's does.  The reference's default compile differs from this
    one by up to 0.2 (qwen3-moe: an expert chosen otherwise)."""
    S, extra = 15, 2
    ref, port = serve_both(*bf16_pair(arch), S=S, extra=extra,
                           compiler_options=EXACT_ROUNDING)
    scale = np.abs(ref["full"]).max()
    tol = max(np.abs(ref["serve"][j] - ref["full"][:, S - 1 + j]).max()
              for j in range(extra + 1)) / scale
    assert 0 < tol < 0.05, tol
    assert np.abs(port["full"] - ref["full"]).max() / scale <= tol
    assert np.abs(port["h"] - ref["h"]).max() / np.abs(ref["h"]).max() <= tol
    for j in range(extra + 1):
        assert np.abs(port["serve"][j] - ref["serve"][j]).max() / scale \
            <= tol, j
    assert all(np.isfinite(lg).all() for lg in port["serve"])


def test_sliding_window_cache_ring_buffer():
    """Mixtral-family SWA decode: the cache stays window-sized, and
    decoding 6 tokens past the window keeps matching the full forward and
    the reference (ring-buffer writes at slot pos % window)."""
    ref_cfg, cfg = f32_pair("mixtral-8x22b", sliding_window=8)
    tree, model = shared_params(ref_cfg, cfg)
    B, S, extra = 1, 12, 6
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + extra)).astype(np.int32)
    _, cache = ref_tf.prefill(ref_cfg, PAR, tree, toks[:, :S],
                              max_seq=S + extra)
    dec = jax.jit(lambda p, c, x: ref_tf.decode_step(ref_cfg, PAR, p, c, x))
    tt = torch.as_tensor(toks, dtype=torch.long)
    with torch.inference_mode():
        h, _ = tf.forward_hidden(model, tt)
        full = tf.logits_of(model, h).numpy()
        lg, tcache = tf.prefill(model, tt[:, :S], max_seq=S + extra)
        assert tcache["self_kv"][0].shape[2] == 8, "cache must be window-sized"
        np.testing.assert_allclose(tcache["kv_positions"].numpy(),
                                   np.asarray(cache["kv_positions"]))
        np.testing.assert_allclose(lg.numpy(), full[:, S - 1], **TOL)
        for j in range(extra):
            lg, tcache = tf.decode_step(model, tcache,
                                        tt[:, S + j:S + j + 1])
            want, cache = dec(tree, cache, toks[:, S + j:S + j + 1])
            np.testing.assert_allclose(lg.numpy(), full[:, S + j], **TOL)
            np.testing.assert_allclose(lg.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tcache["kv_positions"].numpy(),
                                  np.asarray(cache["kv_positions"]))


@pytest.mark.parametrize("causal,window,skip", [
    (True, None, False), (True, 64, False), (False, None, False),
    (False, 64, False), (True, None, True)])
def test_flash_attention_matches_naive_and_reference(causal, window, skip):
    rng = np.random.default_rng(2)
    B, S, H, Dh, K = 2, 256, 4, 32, 2
    q = rng.standard_normal((B, S, H, Dh), dtype=np.float32)
    k = rng.standard_normal((B, S, K, Dh), dtype=np.float32)
    v = rng.standard_normal((B, S, K, Dh), dtype=np.float32)
    kw = dict(causal=causal, sliding_window=window)
    got = layers.flash_attention(
        t(q), t(k), t(v), q_positions=torch.arange(S),
        kv_positions=torch.arange(S), kv_chunk=64, q_chunk=128,
        causal_skip=skip, **kw).numpy()
    naive = layers.naive_attention(t(q), t(k), t(v),
                                   q_positions=torch.arange(S),
                                   kv_positions=torch.arange(S), **kw).numpy()
    want = np.asarray(ref_layers.flash_attention(
        q, k, v, q_positions=jnp.arange(S), kv_positions=jnp.arange(S),
        kv_chunk=64, q_chunk=128, causal_skip=skip, **kw))
    np.testing.assert_allclose(got, naive, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_gqa_head_h_reads_kv_head_h_over_rep():
    """Head h attends with kv head h // (H / K) in both attention forms
    and in decode's grouped form: a kv head of zeros leaves exactly its
    query heads at zero output."""
    rng = np.random.default_rng(3)
    B, S, H, Dh, K = 1, 8, 4, 8, 2
    q = torch.as_tensor(rng.standard_normal((B, S, H, Dh), dtype=np.float32))
    k = torch.as_tensor(rng.standard_normal((B, S, K, Dh), dtype=np.float32))
    v = torch.as_tensor(rng.standard_normal((B, S, K, Dh), dtype=np.float32))
    v[:, :, 1] = 0.0                           # kv head 1 -> heads 2 and 3
    pos = torch.arange(S)
    for fn in (layers.flash_attention, layers.naive_attention):
        o = fn(q, k, v, causal=True, q_positions=pos, kv_positions=pos)
        assert (o[:, :, 2:] == 0).all() and (o[:, :, :2] != 0).all()


@pytest.mark.parametrize("mode", ["ep", "tp"])
@pytest.mark.parametrize("router", ["random", "ties", "capacity"])
def test_moe_matches_reference(mode, router):
    """The single-device MoE against the reference's, and ep against tp.
    ``ties``: a zero router gives every expert the same probability, so
    top-k must take the lower ids first; ``capacity``: 128 tokens x top-2
    past a one-block capacity drop the same assignments."""
    d, T = 32, 128
    cf = 0.4 if router == "capacity" else 2.0
    ref_cfg = ref_moe.MoEConfig(n_experts=4, top_k=2, d_ff=64, mode=mode,
                                token_chunk=128, capacity_factor=cf)
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_ff=64, mode=mode,
                        token_chunk=128, capacity_factor=cf)
    p = to_numpy(ref_moe.init_moe(jax.random.PRNGKey(4), d, ref_cfg,
                                  dtype=jnp.float32))
    if router == "ties":
        p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(5).standard_normal((2, T // 2, d),
                                                 dtype=np.float32)
    want, want_aux = jax.jit(lambda pp, xx: ref_moe.moe_forward(
        pp, xx, ref_cfg))(p, x)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    got, aux = moe.moe_forward(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    other = dataclasses.replace(cfg, mode="tp" if mode == "ep" else "ep")
    np.testing.assert_array_equal(moe.moe_forward(tp, torch.as_tensor(x),
                                                  other)[0].numpy(),
                                  got.numpy())
    # Over a (1, 2) mesh: the shard_map branch, each model shard with half
    # the experts (ep) or half of d_ff (tp), summed.  Its capacity is per
    # shard (the reference's too), so ep past capacity drops other rows.
    par = make_test_parallelism(1, 2, device="cpu")
    y2, aux2 = moe.moe_forward(tp, torch.as_tensor(x), cfg, par)
    if mode == "tp" or router != "capacity":
        np.testing.assert_allclose(y2.numpy(), got.numpy(), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(float(aux2), float(aux), rtol=1e-6)


def test_ssd_chunk_invariance_and_reference():
    """SSD output must not depend on the chunk size (the dual-form
    identity), and matches the reference's, initial state included."""
    B, S, H, P, N = 1, 64, 2, 8, 4
    rng = np.random.default_rng(6)
    xh = rng.standard_normal((B, S, H, P), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.array([0.5, 2.0], np.float32)
    Bc = rng.standard_normal((B, S, 1, N), dtype=np.float32) * 0.5
    Cc = rng.standard_normal((B, S, 1, N), dtype=np.float32) * 0.5
    s0 = rng.standard_normal((B, H, P, N), dtype=np.float32)
    outs = [ssm.ssd_chunked(t(xh), t(dt), t(A), t(Bc), t(Cc), chunk)
            for chunk in (8, 16, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0][0].numpy(), o[0].numpy(),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(outs[0][1].numpy(), o[1].numpy(),
                                   rtol=2e-4, atol=2e-4)
    y, fin = ssm.ssd_chunked(t(xh), t(dt), t(A), t(Bc), t(Cc), 16,
                             initial_state=t(s0))
    wy, wfin = ref_ssm.ssd_chunked(xh, dt, A, Bc, Cc, 16, initial_state=s0)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(fin.numpy(), np.asarray(wfin), rtol=2e-4,
                               atol=2e-4)


def test_mamba2_block_and_decode_step_match_reference():
    """One Mamba2 block: the chunked forward with its cache, a decode step
    from ``mamba2_init_cache`` and one from the forward's cache."""
    kw = dict(head_dim=8, expand=2, state=4)
    d, B, S = 16, 2, 12
    p = to_numpy(ref_ssm.init_mamba2(jax.random.PRNGKey(7), d,
                                     dtype=jnp.float32, **kw))
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = np.random.default_rng(8).standard_normal((B, S + 1, d),
                                                 dtype=np.float32)
    want, want_c = jax.jit(lambda pp, xx: ref_ssm.mamba2_forward(
        pp, xx, chunk=4, return_cache=True, **kw))(p, x[:, :S])
    got, got_c = ssm.mamba2_forward(tp, t(x[:, :S]), chunk=4,
                                    return_cache=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(got_c[key].numpy(),
                                   np.asarray(want_c[key]), rtol=2e-4,
                                   atol=2e-4)
    zero = ssm.mamba2_init_cache(B, d, **kw)
    ref_zero = ref_ssm.mamba2_init_cache(B, d, **kw)
    assert {k: v.shape for k, v in zero.items()} == \
        {k: v.shape for k, v in ref_zero.items()}
    ref_step = jax.jit(lambda pp, xx, cc: ref_ssm.mamba2_decode_step(
        pp, xx, cc, **kw))
    for cache, ref_cache in ((zero, ref_zero), (got_c, want_c)):
        y, nc = ssm.mamba2_decode_step(tp, t(x[:, S:]), cache, **kw)
        wy, wc = ref_step(p, x[:, S:], ref_cache)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(nc["ssm"].numpy(), np.asarray(wc["ssm"]),
                                   rtol=2e-4, atol=2e-4)


def _as_dict(cfg):
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_full_config_matches_assignment(arch):
    cfg = configs.get(arch)
    spec = {
        "qwen3-32b": (64, 5120, 64, 8, 25600, 151936),
        "phi3-medium-14b": (40, 5120, 40, 10, 17920, 100352),
        "granite-3-2b": (40, 2048, 32, 8, 8192, 49155),
        "granite-8b": (36, 4096, 32, 8, 14336, 49152),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
        "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151936),
        "llama-3.2-vision-11b": (40, 4096, 32, 8, 14336, 128256),
        "whisper-medium": (24, 1024, 16, 16, 4096, 51865),
        "mamba2-2.7b": (64, 2560, 0, 0, 0, 50280),
    }[arch]
    n_layers, d, H, kv, ff, V = spec
    assert cfg.n_layers == n_layers and cfg.d_model == d
    assert cfg.vocab_size == V
    if H:
        assert cfg.n_heads == H and cfg.n_kv_heads == kv
    if arch == "zamba2-1.2b":
        assert cfg.ssm.state == 64 and cfg.kind == "hybrid"
    if arch == "mamba2-2.7b":
        assert cfg.ssm.state == 128 and cfg.kind == "ssm"
    if arch == "mixtral-8x22b":
        assert cfg.moe.n_experts == 8 and cfg.moe.top_k == 2
        assert cfg.sliding_window == 4096
    if arch == "qwen3-moe-235b-a22b":
        assert cfg.moe.n_experts == 128 and cfg.moe.top_k == 8
        assert cfg.qk_norm
    if ff and not cfg.moe:
        assert cfg.d_ff == ff
    if cfg.moe:
        assert cfg.moe.d_ff == ff
    # Field for field the reference's, full and smoke.
    assert _as_dict(cfg) == _as_dict(ref_configs.get(arch))
    assert _as_dict(configs.smoke(arch)) == _as_dict(ref_configs.smoke(arch))


@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_counts_match_reference(arch):
    """Meta-device counts, nothing allocated."""
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    if arch == "granite-3-2b":
        assert cfg.param_count() == 2_634_201_088
    if arch == "qwen3-moe-235b-a22b":
        assert cfg.param_count() == 235_093_634_560


def test_params_from_numpy_checks_the_tree():
    ref_cfg, cfg = f32_pair("granite-3-2b")
    tree = to_numpy(ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    bad = dict(tree, lm_head=tree["lm_head"][:, :-1])
    with pytest.raises(ValueError, match="lm_head"):
        tf.params_from_numpy(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="final_norm"):
        tf.params_from_numpy(cfg, {k: v for k, v in tree.items()
                                   if k != "final_norm"}, "cpu")


def test_model_takes_no_default_device():
    """The caller names the device: ``Model`` has no default, and the
    launcher picks the card unless told ``--device cpu``."""
    _, cfg = f32_pair("granite-3-2b")
    with pytest.raises(TypeError, match="device"):
        tf.Model(cfg)
    assert tf.Model(cfg, "meta").lm_head.device.type == "meta"


def test_launcher_lm_mode_on_the_cpu(capsys):
    res = launcher.main(["--device", "cpu", "--smoke", "--gen", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[serve] arch=granite-3-2b-smoke batch=4 prompt=32"
    assert out[1].startswith("[serve] prefill ") and "ms/token" in out[1]
    assert out[2].startswith("[serve] sample generation (first row): [")
    assert res["logits"].shape == (4, 3, 256)
    assert res["generated"].shape == (4, 2)
    # Greedy: each generated token is the argmax of the step before it.
    np.testing.assert_array_equal(res["generated"].numpy(),
                                  res["logits"][:, :2].argmax(-1).numpy())
    assert torch.isfinite(res["logits"]).all()


def bf16_gaps(arch, S=15, extra=2) -> dict:
    """The figures behind the bf16 test, each over the reference's max
    |logit|: the reference's serving path against its full forward (the
    test's tolerance), the port's serving path and full forward against
    the reference's, and the reference's default XLA compile against its
    compile without excess precision."""
    ref_cfg, cfg = bf16_pair(arch)
    ref, port = serve_both(ref_cfg, cfg, S=S, extra=extra,
                           compiler_options=EXACT_ROUNDING)
    default, _ = serve_both(ref_cfg, cfg, S=S, extra=extra)
    scale = np.abs(ref["full"]).max()

    def serve_gap(a):
        return max(np.abs(x - y).max()
                   for x, y in zip(a["serve"], ref["serve"])) / scale

    return {"reference_self": max(
                np.abs(ref["serve"][j] - ref["full"][:, S - 1 + j]).max()
                for j in range(extra + 1)) / scale,
            "port_serve": serve_gap(port),
            "port_full": np.abs(port["full"] - ref["full"]).max() / scale,
            "reference_default_compile": serve_gap(default)}


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm.py
    for name in configs.list_archs():
        print(name, {k: float(f"{v:.3g}")
                     for k, v in bf16_gaps(name).items()}, flush=True)
