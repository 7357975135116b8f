"""The port's training path (``models.transformer.train_loss`` and its
gradients, ``training/``, ``launch/train.py``) against the reference's on
the CPU.

The reference's ``init_params(PRNGKey(0))`` goes into the port through
``params_from_numpy``, and the same numpy tokens (and memory, for the
encdec and vlm kinds) go through both packages.  In f32 the loss is held
to ``jax.value_and_grad`` of the reference's ``train_loss`` at rtol 1e-5
and each gradient leaf at max |Δg| / max |g| ≤ 1e-4; the gaps measured
(``python tests/test_torch_train.py`` prints them) are at most 1.6e-7
for the loss and 8.9e-6 for a leaf (the VLM's gates; the SSM's ``A_log``
6.1e-6, every other leaf below 1.5e-6).  AdamW steps are held to
``apply_updates`` on the same parameters, gradients and state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro.runtime.sharding import single_device
from repro.training import optimizer as ref_opt
from repro.training.compress import compress_decompress as ref_compress
from repro_torch import configs
from repro_torch.checkpoint import state_to_tree
from repro_torch.launch import train as launcher
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt
from repro_torch.training.compress import (compress_decompress,
                                           init_error_feedback)
from repro_torch.training.step import loss_and_grads, make_train_step, trainable

PAR = single_device()
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), tree)


def f32_pair(arch, **changes):
    ref_cfg = dataclasses.replace(ref_configs.smoke(arch), dtype="float32",
                                  remat="none", **changes)
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              remat="none", **changes)
    return ref_cfg, cfg


def shared_tree(ref_cfg):
    """The reference's init as numpy; the VLM's gates (0 at init, which
    hides the cross path) set to ±0.5."""
    tree = to_numpy(ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg))
    if ref_cfg.kind == "vlm":
        n = ref_cfg.n_cross
        tree["cross_layers"]["gate_attn"] = np.full(n, 0.5, np.float32)
        tree["cross_layers"]["gate_mlp"] = np.full(n, -0.5, np.float32)
    return tree


def numpy_batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    n = {"encdec": cfg.enc_seq, "vlm": cfg.img_tokens}.get(cfg.kind)
    if n:
        batch["memory"] = rng.standard_normal((B, n, cfg.d_model),
                                              dtype=np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def reference_loss_and_grads(ref_cfg, tree, batch):
    p = jax.tree_util.tree_map(jnp.asarray, tree)
    b = jax.tree_util.tree_map(jnp.asarray, batch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda pp, bb: ref_tf.train_loss(ref_cfg, PAR, pp, bb)))(p, b)
    return float(loss), to_numpy(grads)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def grad_gaps(want: dict, got: dict) -> dict:
    """max |Δg| / max |g| per leaf path (the absolute gap where the
    reference's gradient is all zero)."""
    want, got = leaves(want), leaves(got)
    assert set(want) == set(got)
    out = {}
    for k in want:
        assert want[k].shape == got[k].shape, k
        scale = np.abs(want[k]).max()
        gap = np.abs(want[k] - got[k]).max()
        out[k] = gap / scale if scale > 0 else gap
    return out


def port_loss_and_grads(cfg, tree, batch):
    model = tf.params_from_numpy(cfg, tree, "cpu")
    params = trainable(model)
    loss, grads = loss_and_grads(model, params, torch_batch(batch))
    stacked = tf.stack_layers({k: g.float() for k, g in grads.items()})
    return float(loss), jax.tree_util.tree_map(lambda t: t.numpy(), stacked)


def loss_grad_gaps(arch, **changes):
    ref_cfg, cfg = f32_pair(arch, **changes)
    tree = shared_tree(ref_cfg)
    batch = numpy_batch(cfg)
    want_loss, want = reference_loss_and_grads(ref_cfg, tree, batch)
    got_loss, got = port_loss_and_grads(cfg, tree, batch)
    return abs(got_loss - want_loss) / abs(want_loss), grad_gaps(want, got)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_train_loss_and_grads_match_reference(arch):
    loss_gap, gaps = loss_grad_gaps(arch)
    assert loss_gap <= LOSS_RTOL, loss_gap
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_TOL, (worst, gaps[worst])


@pytest.mark.parametrize("arch", ["granite-3-2b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """The reference's bf16 init, widened to f32, goes in and comes back
    bit for bit."""
    tree = shared_tree(ref_configs.smoke(arch))
    model = tf.params_from_numpy(configs.smoke(arch), tree, "cpu")
    assert model["lm_head"].dtype == torch.bfloat16
    back, want = leaves(tf.params_to_numpy(model)), leaves(tree)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("remat", ["full", "selective"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b",
                                  "zamba2-1.2b", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_remat_equals_none(arch, remat):
    """Checkpointed blocks recompute the same forward: the loss and every
    gradient equal the un-checkpointed ones (measured: bit for bit)."""
    _, cfg = f32_pair(arch)
    tree = shared_tree(dataclasses.replace(ref_configs.smoke(arch),
                                           dtype="float32"))
    batch = numpy_batch(cfg)
    base_loss, base = port_loss_and_grads(cfg, tree, batch)
    loss, got = port_loss_and_grads(dataclasses.replace(cfg, remat=remat),
                                    tree, batch)
    assert loss == base_loss
    assert max(grad_gaps(base, got).values()) == 0.0


def test_remat_only_while_autograd_records():
    cfg = dataclasses.replace(configs.smoke("granite-3-2b"), remat="full")
    fn = tf._dense_block_full
    assert tf._remat(cfg, fn) is not fn
    with torch.no_grad():
        assert tf._remat(cfg, fn) is fn
    with torch.inference_mode():
        assert tf._remat(cfg, fn) is fn
    assert tf._remat(dataclasses.replace(cfg, remat="none"), fn) is fn


@pytest.mark.parametrize("mode", ["ep", "tp"])
def test_moe_gradients_match_reference(mode):
    """The MoE's in-place writes (the grouped products' slice assignment,
    the combine's and the aux loss's ``index_add_``) under autograd: the
    gradients of Σ y·r + aux with respect to the input, the router and
    the experts equal ``jax.grad``'s, in both router modes."""
    cfg = dataclasses.replace(configs.smoke("mixtral-8x22b").moe, mode=mode)
    ref_cfg = dataclasses.replace(ref_configs.smoke("mixtral-8x22b").moe,
                                  mode=mode)
    d = 64
    p = to_numpy(ref_moe.init_moe(jax.random.PRNGKey(1), d, ref_cfg,
                                  dtype=jnp.float32))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, d), dtype=np.float32)
    r = rng.standard_normal((2, 24, d), dtype=np.float32)

    def ref_fn(pp, xx):
        y, aux = ref_moe.moe_forward(pp, xx, ref_cfg, PAR)
        return jnp.sum(y * r) + aux
    want_x, want_p = jax.grad(lambda pp, xx: ref_fn(pp, xx),
                              argnums=(1, 0))(p, x)

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_forward(tp, tx, cfg)
    (torch.sum(y * torch.as_tensor(r)) + aux).backward()
    gaps = grad_gaps({"x": np.asarray(want_x), **to_numpy(want_p)},
                     {"x": tx.grad.numpy(),
                      **{k: t.grad.numpy() for k, t in tp.items()}})
    assert max(gaps.values()) <= GRAD_TOL, gaps


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def opt_trees(seed=0):
    """A parameter tree in the reference's layout covering the cases:
    f32 and bf16 leaves, a stacked 1-D leaf (decays in the reference), a
    plain 1-D leaf (does not), last axes that pad to the int8 block, one
    below a block, and a scalar."""
    rng = np.random.default_rng(seed)
    def r(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    ref = {"embed": {"table": r(40, 300)},
           "final_norm": {"scale": 1 + 0.1 * r(300)},
           "layers": {"w": r(2, 24, 520), "scale": 1 + 0.1 * r(2, 300),
                      "small": r(2, 8, 64)},
           "gate": r()}
    bf16 = {"layers/w"}
    return ref, bf16


def ref_params(ref, bf16):
    out = jax.tree_util.tree_map(jnp.asarray, ref)
    out["layers"]["w"] = out["layers"]["w"].astype(jnp.bfloat16)
    return out


def port_params(ref, bf16):
    named = {"embed.table": ref["embed"]["table"],
             "final_norm.scale": ref["final_norm"]["scale"], "gate": ref["gate"]}
    for key in ("w", "scale", "small"):
        for i in range(2):
            named[f"layers.{i}.{key}"] = ref["layers"][key][i]
    out = {k: torch.tensor(v) for k, v in named.items()}
    out["layers.0.w"] = out["layers.0.w"].to(torch.bfloat16)
    out["layers.1.w"] = out["layers.1.w"].to(torch.bfloat16)
    return out


def as_np(tree):
    return jax.tree_util.tree_map(
        lambda t: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if isinstance(t, torch.Tensor)
        else np.asarray(jnp.asarray(t).astype(jnp.float32)
                        if jnp.asarray(t).dtype == jnp.bfloat16 else t), tree)


def two_steps(int8: bool):
    """Two AdamW steps in both packages on the same parameters and
    gradients; returns (reference, port) as numpy trees in the
    reference's layout."""
    cfg = opt.AdamWConfig(lr=1e-2, int8_moments=int8, warmup_steps=1,
                          decay_steps=10)
    rcfg = ref_opt.AdamWConfig(lr=1e-2, int8_moments=int8, warmup_steps=1,
                               decay_steps=10)
    ref, bf16 = opt_trees()
    rp = ref_params(ref, bf16)
    pp = port_params(ref, bf16)
    rs = ref_opt.init_state(rcfg, rp)
    ps = opt.init_state(cfg, pp)
    for seed in (1, 2):
        g, _ = opt_trees(seed)
        rg = jax.tree_util.tree_map(lambda a, p: jnp.asarray(a).astype(p.dtype),
                                    g, rp)
        pg = {k: torch.tensor(np.asarray(jnp.asarray(v).astype(jnp.float32)))
              .to(pp[k].dtype) for k, v in
              tf.unstack_layers(g, list(pp)).items()}
        rp, rs = jax.jit(lambda a, b, c: ref_opt.apply_updates(rcfg, a, b, c))(
            rp, rg, rs)
        opt.apply_updates(cfg, pp, pg, ps, tf.decayed_names(pp))
    return ({"params": as_np(rp), "opt": as_np(rs)},
            {"params": as_np(tf.stack_layers(pp)),
             "opt": as_np(state_to_tree(ps))})


def ulps_bf16(a, b):
    """|Δ| in bf16 units in the last place of the larger value."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    exp = np.floor(np.log2(np.maximum(np.maximum(abs(a), abs(b)), 1e-30)))
    return np.abs(a - b) / 2.0 ** (exp - 7)


@pytest.mark.parametrize("int8", [False, True])
def test_apply_updates_matches_reference(int8):
    """Two steps (the second on non-zero moments).  Measured: f32
    parameters within 9.2e-8 relative, bf16 ones equal (one ulp
    allowed), f32 moments within 1.1e-7 relative (1e-6 allowed), int8
    codes equal in all but 3 of 75,720 (|Δcode| ≤ 1, at most 8 allowed),
    block scales within 1.2e-7."""
    want, got = two_steps(int8)
    w, g = leaves(want), leaves(got)
    assert set(w) == set(g)
    flips = 0
    for k in w:
        assert w[k].shape == g[k].shape, k
        if k == "params/layers/w":
            assert ulps_bf16(w[k], g[k]).max() <= 1, k
        elif k.endswith(("m_q", "v_q")):
            d = np.abs(w[k].astype(np.int32) - g[k].astype(np.int32))
            assert d.max() <= 1, k
            flips += int((d > 0).sum())
        elif k == "opt/step":
            assert int(w[k]) == int(g[k]) == 2
        else:
            scale = max(np.abs(w[k]).max(), 1e-30)
            assert np.abs(w[k] - g[k]).max() / scale <= 1e-6, k
    assert flips <= 8, flips
    assert any(k.endswith("m_q") for k in w) == int8


def test_schedule_matches_reference():
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=100,
                          min_lr_frac=0.1)
    rcfg = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=100,
                               min_lr_frac=0.1)
    steps = (0, 1, 5, 9, 10, 11, 50, 99, 100, 1000)
    got = [float(opt.schedule(cfg, s)) for s in steps]
    want = [float(ref_opt.schedule(rcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # tests/test_training.py's values
    assert got[0] == 0.0
    assert abs(got[2] - 5e-4) < 1e-9
    assert abs(got[4] - 1e-3) < 1e-4
    assert abs(got[8] - 1e-4) < 1e-6
    assert got[9] == got[8]


def test_quantize_matches_reference_and_round_trips():
    x = np.random.default_rng(0).standard_normal((3, 1000)).astype(
        np.float32) * 3.0
    codes, scales = opt.quantize_i8(torch.tensor(x))
    rcodes, rscales = ref_opt.quantize_i8(jnp.asarray(x))
    assert codes.shape == x.shape and scales.shape == (3, 4)
    assert np.abs(codes.numpy().astype(int)
                  - np.asarray(rcodes).astype(int)).max() <= 1
    np.testing.assert_allclose(scales.numpy(), np.asarray(rscales),
                               rtol=1e-6)
    y = opt.dequantize_i8(codes, scales, x.shape).numpy()
    assert np.abs(x - y).max() <= np.abs(x).max() / 127 + 1e-6


def quadratic_problem():
    target = torch.tensor(np.linspace(-1, 1, 512), dtype=torch.float32)
    params = {"w": torch.zeros(512)}

    def loss_and_grad(p):
        w = p["w"].clone().requires_grad_(True)
        loss = torch.mean((w - target) ** 2)
        loss.backward()
        return loss.item(), {"w": w.grad}
    return params, loss_and_grad


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_optimises(int8):
    params, loss_and_grad = quadratic_problem()
    cfg = opt.AdamWConfig(lr=3e-2, weight_decay=0.0, int8_moments=int8,
                          warmup_steps=5, decay_steps=400)
    state = opt.init_state(cfg, params)
    losses = []
    for _ in range(200):
        loss, grads = loss_and_grad(params)
        opt.apply_updates(cfg, params, grads, state, set())
        losses.append(loss)
    assert losses[-1] < 0.01 * losses[0]


def test_int8_moments_track_fp32():
    pa, loss_and_grad = quadratic_problem()
    pb = {k: v.clone() for k, v in pa.items()}
    ca = opt.AdamWConfig(lr=1e-2, weight_decay=0.0, warmup_steps=1,
                         decay_steps=1000)
    cb = dataclasses.replace(ca, int8_moments=True)
    sa, sb = opt.init_state(ca, pa), opt.init_state(cb, pb)
    for _ in range(50):
        opt.apply_updates(ca, pa, loss_and_grad(pa)[1], sa, set())
        opt.apply_updates(cb, pb, loss_and_grad(pb)[1], sb, set())
    diff = float((pa["w"] - pb["w"]).abs().max())
    assert diff < 0.10 * float(pa["w"].abs().max())
    la, lb = loss_and_grad(pa)[0], loss_and_grad(pb)[0]
    assert lb < 1.3 * la + 1e-4, (la, lb)


def test_clip_by_global_norm():
    clipped, norm = opt.clip_by_global_norm({"a": torch.full((10,), 10.0)},
                                            1.0)
    assert abs(float(norm) - 10.0 * np.sqrt(10)) < 1e-3
    assert abs(float(torch.sqrt(torch.sum(clipped["a"] ** 2))) - 1.0) < 1e-5
    bf = {"b": torch.full((4,), 3.0, dtype=torch.bfloat16)}
    out, _ = opt.clip_by_global_norm(bf, 1.0)
    assert out["b"].dtype == torch.bfloat16


def test_error_feedback_converges_and_matches_reference():
    g = torch.tensor(np.random.default_rng(0).standard_normal(512),
                     dtype=torch.float32)
    err = init_error_feedback({"g": g})["g"]
    acc = torch.zeros_like(g)
    for _ in range(20):
        deq, err = compress_decompress(g, err)
        acc = acc + deq
    np.testing.assert_allclose((acc / 20).numpy(), g.numpy(), rtol=0.02,
                               atol=1e-3)
    deq, e1 = compress_decompress(g, torch.zeros_like(g))
    rdeq, re1 = ref_compress(jnp.asarray(g.numpy()), jnp.zeros(512))
    np.testing.assert_allclose(deq.numpy(), np.asarray(rdeq), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The train step, the launcher
# ---------------------------------------------------------------------------

def test_grad_accum_matches_full_batch():
    """grad_accum 4 against 1 on the same batch, as
    tests/test_training.py holds the reference (measured: the loss within
    1e-7 and the grad norm within 1e-6 relative)."""
    cfg = dataclasses.replace(configs.smoke("granite-3-2b"),
                              dtype="float32", remat="none")
    ocfg = opt.AdamWConfig(lr=0.0, weight_decay=0.0)   # lr 0: compare
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 32),
                                     generator=torch.Generator().manual_seed(0))}
    metrics = {}
    for accum in (1, 4):
        model = tf.init_params(cfg, "cpu", seed=0)
        state = opt.init_state(ocfg, trainable(model))
        _, _, metrics[accum] = make_train_step(ocfg, grad_accum=accum)(
            model, state, batch)
    np.testing.assert_allclose(float(metrics[1]["loss"]),
                               float(metrics[4]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics[1]["grad_norm"]),
                               float(metrics[4]["grad_norm"]), rtol=1e-4)


def test_grad_accum_sums_bf16_gradients_in_f32(monkeypatch):
    """A bf16 model's microbatch gradients are summed in a separate f32
    tree: the accumulated gradient handed to the clip is f32."""
    import repro_torch.training.step as step_mod

    seen = {}
    real = step_mod.clip_by_global_norm

    def spy(grads, max_norm):
        seen.update({k: g.dtype for k, g in grads.items()})
        return real(grads, max_norm)
    monkeypatch.setattr(step_mod, "clip_by_global_norm", spy)
    cfg = configs.smoke("granite-3-2b")
    model = tf.init_params(cfg, "cpu", seed=0)
    state = opt.init_state(opt.AdamWConfig(), trainable(model))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16))}
    make_train_step(opt.AdamWConfig(), grad_accum=2)(model, state, batch)
    assert set(seen.values()) == {torch.float32}
    assert all(p.grad is None for p in model.parameters())


def test_launcher_trains_and_loss_decreases(capsys):
    losses = launcher.main(["--arch", "granite-3-2b", "--smoke", "--steps",
                            "30", "--global-batch", "8", "--seq-len", "64",
                            "--lr", "1e-3", "--log-every", "10",
                            "--device", "cpu"])
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    out = capsys.readouterr().out
    assert "[train] step 0 loss" in out and "[train] done: first loss" in out


def test_launcher_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        launcher.main(["--arch", "granite-3-2b", "--smoke", "--steps", "1",
                       "--mesh-devices", "2,2"])


def test_launcher_mesh_matches_its_single_device_run(tmp_path, capsys):
    """--mesh-devices 2,2 against the launcher's own single-device run on
    the same tokens (the smoke config in bf16, f32 moments): every loss and
    grad norm; a checkpoint written from the mesh resumes on (4, 1) and on
    one device."""
    import shutil

    base = ["--arch", "granite-3-2b", "--smoke", "--steps", "3",
            "--seq-len", "32", "--device", "cpu", "--log-every", "1"]
    one = launcher.run(launcher.parse_args(base))
    mesh = launcher.run(launcher.parse_args(
        base + ["--mesh-devices", "2,2", "--ckpt-dir", str(tmp_path)]))
    assert type(mesh["model"]).__name__ == "ShardedModel"
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(mesh["grad_norms"], one["grad_norms"],
                               rtol=1e-5)
    for i, extra in enumerate((["--mesh-devices", "4,1"], [])):
        d = tmp_path.parent / f"{tmp_path.name}_{i}"
        shutil.copytree(tmp_path, d)
        res = launcher.run(launcher.parse_args(
            base[:4] + ["4"] + base[5:] + ["--ckpt-dir", str(d),
                                           "--resume"] + extra))
        assert res["start"] == 3 and len(res["losses"]) == 1
    assert capsys.readouterr().out.count("[train] resumed from step 3") == 2


if __name__ == "__main__":
    for arch in configs.list_archs():
        loss_gap, gaps = loss_grad_gaps(arch)
        worst = max(gaps, key=gaps.get)
        print(f"{arch}: loss {loss_gap:.2e}, worst leaf {worst} "
              f"{gaps[worst]:.2e}")
