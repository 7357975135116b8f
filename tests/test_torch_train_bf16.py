"""The port's training gradients in the configs' own dtype, bf16, against
the reference's on the CPU.

The reference is compiled with XLA's excess precision off, so that it
rounds where its code casts (as ``tests/test_torch_lm.py`` does for
serving).  Two kinds of test:

* The activations, element by element: ``layers.silu`` and
  ``layers.gelu_tanh`` carry JAX's own backward, op by op in bf16, and
  must equal the reference's.  Autograd through their expansions rounds
  elsewhere: before they had it, the dense archs' gradients were 1.4e-2
  of max |g| from the reference's, now 1.7e-3.
* Each of the ten archs at smoke size: the loss and every gradient leaf
  of ``train_loss``.  Here f32 summation order inside the backward flips
  bf16 roundings now and then, and a flip travels on; the tolerance is
  the reference's own bf16 error, its bf16 gradient against its f32
  gradient of the same weights and batch, leaf by leaf (and the loss
  likewise).  The reference's other gaps against itself measure no such
  noise: its remat "full" against "none" is 0, and its default compile
  against this one is 0 for the VLM, whose stack runs in f32.
  ``python tests/test_torch_train_bf16.py`` prints the gaps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.models import layers
from test_torch_lm import EXACT_ROUNDING, as_reference_dtypes, bf16_pair
from test_torch_train import (PAR, f32_pair, grad_gaps, numpy_batch,
                              port_loss_and_grads, reference_loss_and_grads,
                              shared_tree)


def reference_bf16_loss_and_grads(ref_cfg, tree, batch):
    p = as_reference_dtypes(ref_cfg, tree)
    b = jax.tree_util.tree_map(jnp.asarray, batch)
    fn = jax.jit(jax.value_and_grad(
        lambda pp, bb: ref_tf.train_loss(ref_cfg, PAR, pp, bb)))
    loss, grads = fn.lower(p, b).compile(compiler_options=EXACT_ROUNDING)(
        p, b)
    return float(loss), jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), grads)


def model_gaps(arch) -> dict:
    """The port's bf16 loss and gradients against the reference's, and
    the reference's bf16 ones against its f32 ones: ``{"loss": (port,
    reference), "leaves": {path: (port, reference)}}``, each gap
    relative (the loss) or over max |g| of the leaf."""
    ref_cfg, cfg = bf16_pair(arch)
    tree = shared_tree(ref_cfg)
    batch = numpy_batch(cfg)
    want_loss, want = reference_bf16_loss_and_grads(ref_cfg, tree, batch)
    f32_loss, f32 = reference_loss_and_grads(f32_pair(arch)[0], tree, batch)
    got_loss, got = port_loss_and_grads(cfg, tree, batch)
    port, own = grad_gaps(want, got), grad_gaps(f32, want)
    return {"loss": (abs(got_loss - want_loss) / abs(want_loss),
                     abs(want_loss - f32_loss) / abs(f32_loss)),
            "leaves": {k: (port[k], own[k]) for k in port}}


@pytest.mark.parametrize("arch", configs.list_archs())
def test_train_grads_match_reference_bf16(arch):
    """Measured: the port's gaps are at most 0.80 of the reference's own
    bf16 error in any leaf (zamba2's; the dense archs 0.12), its loss
    within 1.5e-5 relative against the reference's own 6.9e-5 to 4.2e-3.
    In the MoE archs the reference's own error reaches 0.56 of max |g|
    (bf16 routes a token to another expert than f32 does); the port's
    gaps there are at most 2.0e-3, 0.01 of the reference's own."""
    gaps = model_gaps(arch)
    port, own = gaps["loss"]
    assert port <= own, (port, own)
    for k, (port, own) in gaps["leaves"].items():
        assert own > 0, k
        assert port <= own, (k, port, own)


# ---------------------------------------------------------------------------
# The activations' backward, element by element
# ---------------------------------------------------------------------------

ACTIVATIONS = {
    "silu": (jax.nn.silu, layers.silu),
    "gelu_tanh": (lambda v: jax.nn.gelu(v, approximate=True),
                  layers.gelu_tanh),
}


def activation_flips(name, n=1 << 16) -> tuple:
    """The activation and its vector-Jacobian product on ``n`` bf16
    values through both packages: (elements whose forward differs,
    elements whose backward differs)."""
    ref_fn, port_fn = ACTIVATIONS[name]
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal(n)).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    jx, jg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    fn = jax.jit(lambda a, b: (ref_fn(a), jax.vjp(ref_fn, a)[1](b)[0]))
    want_y, want_g = fn.lower(jx, jg).compile(
        compiler_options=EXACT_ROUNDING)(jx, jg)
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    y = port_fn(tx)
    y.backward(torch.tensor(g).to(torch.bfloat16))
    return (int((y.detach().float().numpy()
                 != np.asarray(want_y.astype(jnp.float32))).sum()),
            int((tx.grad.float().numpy()
                 != np.asarray(want_g.astype(jnp.float32))).sum()))


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_backward_rounds_where_the_reference_rounds(name):
    """JAX differentiates ``x * logistic(x)`` and the tanh formula by its
    own rules (logistic's ``g·(s·(1 − s))``, tanh's ``w + w·t``,
    ``x ** 3``'s ``g·(3·x²)``), each op rounded in bf16; ``layers.silu``
    and ``layers.gelu_tanh`` carry that backward.  Measured: the forward
    and the backward equal the reference's in all 65,536 elements;
    autograd through the expansions differed in 31,071 (silu) and 31,359
    (gelu) of them.  At most 0.1 % may differ, for an f32 ``exp`` or
    ``tanh`` one ulp apart next to a bf16 boundary."""
    fwd, bwd = activation_flips(name)
    assert fwd <= 65 and bwd <= 65, (fwd, bwd)


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_bf16.py
    for name in sorted(ACTIVATIONS):
        print(f"{name}: elements differing (forward, backward) "
              f"{activation_flips(name)}", flush=True)
    for arch in configs.list_archs():
        gaps = model_gaps(arch)
        ratio = {k: p / o for k, (p, o) in gaps["leaves"].items()}
        worst = max(ratio, key=ratio.get)
        print(f"{arch}: loss {gaps['loss'][0]:.2e} (own "
              f"{gaps['loss'][1]:.2e}); worst leaf {worst} "
              f"{gaps['leaves'][worst][0]:.2e} of its own "
              f"{gaps['leaves'][worst][1]:.2e}", flush=True)
