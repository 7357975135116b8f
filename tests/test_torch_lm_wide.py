"""mamba2-2.7b at its published width (d_model 2560, 80 heads of 64,
state 128, vocab 50280) with its depth cut to 2 of 64 layers, in its own
dtype, bf16, against the reference on the CPU: the serving path and the
training loss.  The reference is compiled with XLA's excess precision
off, so that it rounds where its code casts (as
``tests/test_torch_lm.py`` does at smoke width).

The MoE configs at published width are not here: a layer holds about
2.4 B expert parameters (8 × 3 × 6144 × 16384 for mixtral, 128 × 3 ×
4096 × 1536 for qwen3-moe), about 4.8 GB in bf16 for each package, too
large for a CPU test; their f32 run on the card (``chip_smoke.py`` phase
18) carries them.  ``test_torch_train_bf16.py`` holds every arch's
gradients at smoke size the same way as the gradients here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import transformer as ref_tf
from repro.runtime.sharding import single_device
from repro_torch import configs
from repro_torch.models import transformer as tf
from repro_torch.training.step import loss_and_grads, trainable
from test_torch_train import grad_gaps

PAR = single_device()
EXACT_ROUNDING = {"xla_allow_excess_precision": False}
ARCH = "mamba2-2.7b"


def test_mamba2_published_width_bf16_matches_reference():
    """The tolerance is the reference's own bf16 gap between its serving
    path and its full forward over max |logit| (as in
    ``test_torch_lm.py``).  Measured: the reference's own gap 9.0e-3 of
    max |logit|; the port's hidden states 7.5e-3 of max |h| from the
    reference's, the full forward's logits 6.0e-3, the prefill and decode
    logits 3.2e-3, 3.0e-3 and 4.5e-3, the loss 3.7e-5 relative (at
    smoke width the two are equal bit for bit; at this width some bf16
    roundings fall apart with the order of the sums).  About 12 s and 3.6 GB on the CPU."""
    ref_cfg = dataclasses.replace(ref_configs.get(ARCH), n_layers=2,
                                  remat="none")
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=2, remat="none")
    assert (cfg.d_model, cfg.vocab_size, cfg.ssm.state) == (2560, 50280, 128)
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    model = tf.params_from_numpy(cfg, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), params), "cpu")
    B, S, extra = 1, 12, 2
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + extra)).astype(np.int32)

    def reference(p, x):
        h = ref_tf.forward_hidden(ref_cfg, PAR, p, x)[0]
        full = (h @ p["lm_head"]).astype(jnp.float32)
        lg, cache = ref_tf.prefill(ref_cfg, PAR, p, x[:, :S],
                                   max_seq=S + extra)
        out = [lg]
        for j in range(extra):
            lg, cache = ref_tf.decode_step(ref_cfg, PAR, p, cache,
                                           x[:, S + j:S + j + 1])
            out.append(lg)
        loss = ref_tf.train_loss(ref_cfg, PAR, p, {"tokens": x})
        return h.astype(jnp.float32), full, out, loss

    want_h, want_full, want, want_loss = jax.jit(reference).lower(
        params, toks).compile(compiler_options=EXACT_ROUNDING)(params, toks)
    want_full = np.asarray(want_full)
    scale = np.abs(want_full).max()
    tol = max(np.abs(np.asarray(want[j]) - want_full[:, S - 1 + j]).max()
              for j in range(extra + 1)) / scale
    assert 0 < tol < 0.05, tol

    tt = torch.as_tensor(toks, dtype=torch.long)
    with torch.inference_mode():
        h, _ = tf.forward_hidden(model, tt)
        full = tf.logits_of(model, h).numpy()
        got = [tf.prefill(model, tt[:, :S], max_seq=S + extra)]
        cache = got[0][1]
        for j in range(extra):
            got.append(tf.decode_step(model, cache, tt[:, S + j:S + j + 1]))
        loss = float(tf.train_loss(model, {"tokens": tt}))
    assert h.dtype == torch.bfloat16
    assert np.abs(h.float().numpy() - np.asarray(want_h)).max() \
        / np.abs(np.asarray(want_h)).max() <= tol
    assert np.abs(full - want_full).max() / scale <= tol
    for j in range(extra + 1):
        assert np.abs(got[j][0].numpy() - np.asarray(want[j])).max() \
            / scale <= tol, j
    # The loss: f32 logits from the same bf16 hidden states; held at the
    # same ratio of the loss.
    assert abs(loss - float(want_loss)) / float(want_loss) <= tol
    assert np.isfinite(loss)


def test_mamba2_published_width_bf16_gradients_match_reference():
    """``train_loss``'s gradients at the same width, bf16 against the
    reference compiled with excess precision off.  The reference's own
    bf16 error, its bf16 gradient against its f32 gradient of the same
    weights and tokens, sets the tolerance, leaf by leaf.  At this width
    the two packages' f32 sums (over 2,560 and more terms) run in other
    orders, so many bf16 roundings fall apart and the port's gradient is
    a second bf16 evaluation of the function rather than a copy of the
    reference's: two evaluations each within e of the f32 gradient lie
    within 2e of each other, and that is the bound (at smoke size,
    ``test_torch_train_bf16.py`` holds them within e).  Measured (about
    21 s and 9 GB on the CPU): the port's gaps 0.41 to 1.13 of the
    reference's own error (``ssm/in_proj`` 1.44e-2 against 1.27e-2), the
    loss 3.7e-5 relative against the reference's own 1.4e-4."""
    ref_cfg = dataclasses.replace(ref_configs.get(ARCH), n_layers=2,
                                  remat="none")
    cfg = dataclasses.replace(configs.get(ARCH), n_layers=2, remat="none")
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  params)
    toks = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 14)).astype(np.int32)}

    def reference(rc, p, options):
        fn = jax.jit(jax.value_and_grad(
            lambda pp, bb: ref_tf.train_loss(rc, PAR, pp, bb)))
        loss, g = fn.lower(p, toks).compile(compiler_options=options)(p, toks)
        return float(loss), jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), g)

    want_loss, want = reference(ref_cfg, params, EXACT_ROUNDING)
    f32_loss, f32 = reference(dataclasses.replace(ref_cfg, dtype="float32"),
                              jax.tree_util.tree_map(jnp.asarray, tree), None)
    model = tf.params_from_numpy(cfg, tree, "cpu")
    loss, grads = loss_and_grads(model, trainable(model),
                                 {"tokens": torch.as_tensor(toks["tokens"])})
    got = jax.tree_util.tree_map(lambda t: t.numpy(), tf.stack_layers(
        {k: g.float() for k, g in grads.items()}))
    assert abs(float(loss) - want_loss) <= abs(want_loss - f32_loss)
    port, own = grad_gaps(want, got), grad_gaps(f32, want)
    for k in port:
        assert own[k] > 0, k
        assert port[k] <= 2 * own[k], (k, port[k], own[k])
