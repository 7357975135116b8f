"""The port's mesh pieces against the reference's, on the CPU.

The reference's mesh pieces (``repro.runtime.sharding``,
``repro.training.step`` over a GSPMD mesh, the MoE's ``shard_map``,
``repro.training.compress``, the sharded checkpoint) need several
devices, so they run once per module in a subprocess with
``--xla_force_host_platform_device_count=8`` (as ``tests/test_torch_dist.py``
runs its engines), on inputs this file makes with numpy from a seed and
passes as ``.npz``; results come back as ``.npz`` and JSON.  The
reference's meshes are ``repro.launch.mesh.make_test_parallelism``'s with
JAX's ``Auto`` axis types, the ones its code was written for (this JAX's
``make_mesh`` defaults to ``Explicit`` axes, under which the reference's
own GSPMD test, ``tests/test_distributed_train.py``, fails).  The port
runs the same calls on ``make_test_parallelism(..., device="cpu")``.

Held, each at its tolerance: ``spec_for`` / ``param_specs`` /
``opt_specs`` equal the reference's for every leaf of the ten smoke
configs on (2, 2) and (4, 2) meshes, f32 and int8 moments; the 2 × 2
train step (granite smoke in f32, qwen3-moe smoke, and int8 moments)
equals the reference's GSPMD step (loss rtol 1e-4, every leaf 2e-3, the
reference test's), and the int8 one also the reference's single-device
step; the MoE's ``ep`` / ``tp`` branches equal the reference's
``shard_map`` (y 2e-4, aux 1e-5: the same per-shard estimator); the
compressed DP gradients equal the reference's round by round over its
16-round loop; checkpoints reshard both ways (reference 8 devices → port
4 shards and 1 device; port 8 shards → reference 4 devices).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import (params_to_tree, restore_pytree,
                                    save_pytree)
from repro_torch.checkpoint.layout import stacked_path
from repro_torch.launch.mesh import make_parallelism, make_test_parallelism
from repro_torch.models import moe
from repro_torch.models.transformer import (Model, _layer_split,
                                            init_params, params_from_numpy,
                                            params_to_numpy)
from repro_torch.runtime import collectives
from repro_torch.runtime.sharding import (NamedSharding, P, ShardedTensor,
                                          gather, param_specs, psum,
                                          reduce_scatter, shard)
from repro_torch.training.compress import (init_error_feedback,
                                           make_compressed_dp_grad_fn)
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.step import (init_sharded_state, make_train_step,
                                       opt_specs, shard_model, trainable)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = ((2, 2), (4, 2))
STEP_CASES = (("granite-3-2b", False), ("granite-3-2b", True),
              ("qwen3-moe-235b-a22b", False))
MOE_CASES = (("ep", "qwen3-moe-235b-a22b"), ("tp", "mixtral-8x22b"))
CKPT_ARCH = "granite-3-2b"

REF_SCRIPT = r"""
import dataclasses, functools, json, pathlib, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro import configs
from repro.checkpoint import restore_pytree, save_pytree
from repro.models.moe import init_moe, moe_forward
from repro.models.transformer import init_params
from repro.runtime.sharding import (Parallelism, param_shardings,
                                    param_specs, single_device)
from repro.training.compress import (init_error_feedback,
                                     make_compressed_dp_grad_fn)
from repro.training.optimizer import AdamWConfig, init_state
from repro.training.step import make_train_step, opt_shardings, opt_specs

assert len(jax.devices()) == 8
out = pathlib.Path(sys.argv[1])
inp = dict(np.load(out / "inputs.npz"))
res, specs = {}, {}
KEY = jax.random.PRNGKey(0)

def make_test_parallelism(d, m):
    mesh = jax.make_mesh((d, m), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                       fsdp_axis="data")

def path_of(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)

def flat(tree, is_leaf=None):
    return {path_of(kp): v for kp, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}

def spec_json(s):
    return [list(d) if isinstance(d, tuple) else d for d in s]

def put(prefix, tree):
    for k, v in flat(tree).items():
        res[prefix + k] = np.asarray(jnp.asarray(v).astype(
            jnp.float32 if v.dtype == jnp.bfloat16 else v.dtype))

is_p = lambda x: isinstance(x, P)
# 1. sharding specs
for arch in configs.list_archs():
    cfg = configs.smoke(arch)
    ps = jax.eval_shape(functools.partial(init_params, cfg=cfg),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    for d, m in ((2, 2), (4, 2)):
        par = make_test_parallelism(d, m)
        e = {"params": {k: spec_json(v) for k, v in
                        flat(param_specs(ps, par), is_p).items()}}
        for name, int8 in (("f32", False), ("int8", True)):
            os_ = jax.eval_shape(functools.partial(
                init_state, AdamWConfig(int8_moments=int8)), ps)
            e[name] = {k: spec_json(v) for k, v in
                       flat(opt_specs(ps, os_, par), is_p).items()}
        specs[f"{arch}|{d},{m}"] = e

# 2. the 2x2 GSPMD train step (and single-device with int8 moments)
par = make_test_parallelism(2, 2)
batch = {"tokens": jnp.asarray(inp["tokens"])}
for arch, int8 in (("granite-3-2b", False), ("granite-3-2b", True),
                   ("qwen3-moe-235b-a22b", False)):
    tag = f"{arch}|{int(int8)}|"
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              remat="none")
    ocfg = AdamWConfig(lr=1e-3, int8_moments=int8)
    p = init_params(KEY, cfg)
    put(tag + "p0/", p)
    s = init_state(ocfg, p)
    pshape, sshape = jax.eval_shape(lambda: p), jax.eval_shape(lambda: s)
    pshard = param_shardings(pshape, par)
    oshard = opt_shardings(pshape, sshape, par)
    step = jax.jit(make_train_step(cfg, par, ocfg),
                   in_shardings=(pshard, oshard, None),
                   out_shardings=(pshard, oshard, None))
    pn, sn, mt = step(jax.device_put(p, pshard), jax.device_put(s, oshard),
                      batch)
    put(tag + "p1/", pn)
    put(tag + "s1/", sn["moments"])
    res[tag + "loss"] = np.float32(mt["loss"])
    res[tag + "gnorm"] = np.float32(mt["grad_norm"])
    if int8:
        pn, sn, mt = jax.jit(make_train_step(cfg, single_device(), ocfg))(
            p, s, batch)
        put(tag + "single_p1/", pn)
        res[tag + "single_loss"] = np.float32(mt["loss"])

# 3. the MoE's shard_map branches against the local path
for mode, arch in (("ep", "qwen3-moe-235b-a22b"), ("tp", "mixtral-8x22b")):
    mcfg = configs.smoke(arch).moe
    p = init_moe(jax.random.PRNGKey(1), 64, mcfg, dtype=jnp.float32)
    put(f"moe_{mode}/p/", p)
    x = jnp.asarray(inp["moe_x"])
    y2, aux2 = jax.jit(lambda p, x: moe_forward(p, x, mcfg, par))(p, x)
    res[f"moe_{mode}/y"], res[f"moe_{mode}/aux"] = np.asarray(y2), \
        np.float32(aux2)

# 4. compressed DP gradients over 4 data shards, 1 + 16 rounds
mesh = jax.make_mesh((4,), ("data",))
params = {"w": jnp.zeros((32, 8), jnp.float32)}
xs, ys = jnp.asarray(inp["xs"]), jnp.asarray(inp["ys"])
def loss_fn(p, batch):
    x, y = batch
    return jnp.mean((x @ p["w"] - y) ** 2)
grad_fn = jax.jit(make_compressed_dp_grad_fn(loss_fn, mesh))
err = init_error_feedback(params)
for r in range(17):
    loss, g, err = grad_fn(params, (xs, ys), err)
    res[f"dp/g{r}"], res[f"dp/loss{r}"] = np.asarray(g["w"]), np.float32(loss)
res["dp/exact"] = np.asarray(jax.grad(loss_fn)(params, (xs, ys))["w"])

# 5. checkpoints: reference 8 devices -> port; port 8 shards -> here (4)
cfg = configs.smoke("granite-3-2b")
ps = jax.eval_shape(functools.partial(init_params, cfg=cfg),
                    jax.ShapeDtypeStruct((2,), jnp.uint32))
p = init_params(jax.random.PRNGKey(2), cfg)
p8 = jax.device_put(p, param_shardings(ps, make_test_parallelism(4, 2)))
save_pytree({"params": p8}, out / "ref_ckpt", 1)
put("ckpt_ref/", p)
par4 = make_test_parallelism(2, 2)
got = restore_pytree({"params": ps}, out / "port_ckpt", 1,
                     {"params": param_shardings(ps, par4)})
want = dict(np.load(out / "port_params.npz"))
ok = True
for k, v in flat(got["params"]).items():
    ok &= len(v.sharding.device_set) == 4 and np.array_equal(
        np.asarray(v.astype(jnp.float32)), want[k])
res["ckpt_port_ok"] = np.bool_(ok)
np.savez(out / "results.npz", **res)
(out / "specs.json").write_text(json.dumps(specs))
print("OK")
"""


def tree_of(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        *head, last = k[len(prefix):].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_mesh")
    rng = np.random.default_rng(0)
    W = rng.standard_normal((32, 8)).astype(np.float32)
    xs = rng.standard_normal((16, 32)).astype(np.float32)
    np.savez(out / "inputs.npz",
             tokens=rng.integers(0, 256, (4, 32)).astype(np.int32),
             moe_x=rng.standard_normal((4, 16, 64)).astype(np.float32),
             xs=xs, ys=xs @ W)
    # the port's 8-shard checkpoint, for the reference to restore on 4
    cfg = configs.smoke(CKPT_ARCH)
    model = init_params(cfg, "cpu", seed=3)
    np.savez(out / "port_params.npz", **{
        "/".join(_layer_split(n)[0]): a for n, a in
        flat_np(params_to_numpy(model)).items()})
    sm = shard_model(model, make_test_parallelism(4, 2, device="cpu"))
    save_pytree({"params": params_to_tree(sm)}, out / "port_ckpt", 1)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=900)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    res = dict(np.load(out / "results.npz"))
    res["specs"] = json.loads((out / "specs.json").read_text())
    res["dir"] = out
    return res


def flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_np(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def norm_spec(s) -> list:
    return [list(d) if isinstance(d, tuple) else d for d in s]


# ---------------------------------------------------------------------------
# The mesh, the gather and the sum
# ---------------------------------------------------------------------------


def test_mesh_places_shards_and_refuses_without_a_card(monkeypatch):
    par = make_test_parallelism(2, 3, device="cpu")
    assert par.mesh.shape == {"data": 2, "model": 3}
    assert par.data_size == 2 and par.model_size == 3
    assert {d.type for d in par.mesh.devices.flat} == {"cpu"}
    row = par.data_rows([1])
    assert row.data_size == 1 and row.model_size == 3
    assert par.data_rows([0, 1]).mesh.shape == par.mesh.shape
    multi = make_parallelism(multi_pod=True, device="meta").data_rows(
        [3, 5, 7])
    assert multi.mesh.shape == {"pod": 1, "data": 3, "model": 16}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_test_parallelism(2, 2)


@pytest.mark.parametrize("spec", [P("data", "model"), P("model", None),
                                  P(None, ("data", "model")), P(None, None)])
def test_shard_gather_round_trip_and_gradients(spec):
    par = make_test_parallelism(2, 2, device="cpu")
    sh = NamedSharding(par.mesh, spec)
    t = torch.randn(8, 12, generator=torch.Generator().manual_seed(0))
    blocks = shard(t, sh)
    assert len(blocks) == int(np.prod(sh.counts(2)))
    for b, idx in zip(blocks, sh.indices(t.shape)):
        torch.testing.assert_close(b, t[idx[0][0]:idx[0][1],
                                        idx[1][0]:idx[1][1]])
    leaves = [b.requires_grad_(True) for b in blocks]
    with collectives.recording() as stats:
        full = gather(leaves, sh)
    torch.testing.assert_close(full, t)
    # differentiable: each block gets its slice of the gradient
    w = torch.randn(8, 12, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad((full * w).sum(), leaves)
    for g, want in zip(grads, reduce_scatter(w, sh)):
        torch.testing.assert_close(g, want)
    n = len(blocks)
    assert stats.bytes_by_kind.get("all-gather", 0) == (
        t.numel() * 4 * par.mesh.size if n > 1 else 0)
    assert ShardedTensor(blocks, sh).shape == (8, 12)


def test_psum_is_an_f32_sum_and_records_a_ring_all_reduce():
    parts = [torch.full((3,), float(i), dtype=torch.bfloat16)
             for i in range(4)]
    with collectives.recording() as stats:
        out = psum(parts)
    assert out.dtype == torch.float32 and torch.equal(out, torch.full((3,),
                                                                      6.0))
    assert stats.bytes_by_kind == {"all-reduce": 2 * 12 * 4}
    assert collectives.count_op(["aten.mm", "aten.add.Tensor", "aten.mm"],
                                "mm") == 2


# ---------------------------------------------------------------------------
# Sharding specs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_and_opt_specs_match_reference(ref, arch, mesh):
    want = ref["specs"][f"{arch}|{mesh[0]},{mesh[1]}"]
    par = make_test_parallelism(*mesh, device="cpu")
    named = dict(Model(configs.smoke(arch), "meta").named_parameters())
    got = param_specs(named, par, stacked_path)
    seen = set()
    for name, spec in got.items():
        path, layer = _layer_split(name)
        w = want["params"]["/".join(path)]
        assert norm_spec(spec) == (w if layer is None else w[1:]), name
        seen.add("/".join(path))
    assert seen == set(want["params"])
    for opt, int8 in (("f32", False), ("int8", True)):
        like = init_state(AdamWConfig(int8_moments=int8), named)
        ospecs = opt_specs(named, like, par)
        assert norm_spec(ospecs["step"]) == want[opt]["step"]
        for name, st in ospecs["moments"].items():
            path, layer = _layer_split(name)
            for k, spec in st.items():
                w = want[opt]["/".join(("moments",) + path + (k,))]
                assert norm_spec(spec) == (w if layer is None else w[1:]), \
                    (opt, name, k)


# ---------------------------------------------------------------------------
# The 2 x 2 train step against the reference's GSPMD step
# ---------------------------------------------------------------------------


def port_mesh_step(ref, arch, int8):
    tag = f"{arch}|{int(int8)}|"
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              remat="none")
    ocfg = AdamWConfig(lr=1e-3, int8_moments=int8)
    model = params_from_numpy(cfg, tree_of(ref, tag + "p0/"), "cpu")
    par = make_test_parallelism(2, 2, device="cpu")
    sm = shard_model(model, par)
    state = init_sharded_state(ocfg, sm)
    batch = {"tokens": torch.as_tensor(
        np.load(ref["dir"] / "inputs.npz")["tokens"]).long()}
    _, state, m = make_train_step(ocfg, par=par)(sm, state, batch)
    got = params_to_numpy(sm.full("cpu"))
    return tag, sm, state, m, flat_np(got)


@pytest.mark.parametrize("arch,int8", STEP_CASES)
def test_mesh_train_step_matches_reference_gspmd(ref, arch, int8):
    tag, sm, state, m, got = port_mesh_step(ref, arch, int8)
    np.testing.assert_allclose(float(m["loss"]), ref[tag + "loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), ref[tag + "gnorm"],
                               rtol=1e-4)
    want = flat_np(tree_of(ref, tag + "p1/"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3,
                                   err_msg=k)
    # the moments, restacked as the reference's
    from repro_torch.checkpoint import state_to_tree
    mom = flat_np({k: v.full("cpu") if isinstance(v, ShardedTensor) else v
                   for k, v in flat_np(state_to_tree(state)["moments"])
                   .items()})
    wm = flat_np(tree_of(ref, tag + "s1/"))
    assert set(mom) == set(wm)
    for k, w in wm.items():
        g = mom[k].numpy()
        if g.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, k
        else:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-6,
                                       err_msg=k)
    if int8:
        # the reference's single-device step: GSPMD's global update
        single = flat_np(tree_of(ref, tag + "single_p1/"))
        for k in single:
            np.testing.assert_allclose(got[k], single[k], rtol=2e-3,
                                       atol=2e-3, err_msg=k)


def test_mesh_step_equals_port_single_device_step():
    """The mesh step is the single-device function: loss and every leaf
    of the port's own single-device step, in f32 with grad_accum 2."""
    cfg = dataclasses.replace(configs.smoke("granite-3-2b"), dtype="float32",
                              remat="none")
    ocfg = AdamWConfig(lr=1e-3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 16),
                                     generator=torch.Generator()
                                     .manual_seed(0))}
    one = init_params(cfg, "cpu", seed=1)
    sm = shard_model(one, make_test_parallelism(2, 2, device="cpu"))
    _, _, m1 = make_train_step(ocfg, grad_accum=2)(
        one, init_state(ocfg, trainable(one)), batch)
    _, _, m2 = make_train_step(ocfg, grad_accum=2, par=sm.par)(
        sm, init_sharded_state(ocfg, sm), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    full = dict(sm.full("cpu").named_parameters())
    for k, p in one.named_parameters():
        np.testing.assert_allclose(full[k].numpy(), p.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b"])
def test_mesh_step_with_rows_on_two_devices_equals_one_device(arch):
    """Data rows on two devices ("cpu" and "cpu:0" are two keys of one
    host) run one pass each, their f32 gradients summed: the same step as
    the rows together (one pass, the MoE splitting its batch over them),
    with two microbatches too."""
    from repro_torch.runtime.sharding import Parallelism, make_mesh

    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              remat="none")
    ocfg = AdamWConfig(lr=1e-3, int8_moments=True)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 16),
                                     generator=torch.Generator()
                                     .manual_seed(2))}
    two = Parallelism(mesh=make_mesh((2, 2), ("data", "model"),
                                     ["cpu", "cpu", "cpu:0", "cpu:0"]))
    assert len(set(two.devices_by_data()[:, 0])) == 2
    out = []
    for par in (make_test_parallelism(2, 2, device="cpu"), two):
        sm = shard_model(init_params(cfg, "cpu", seed=4), par)
        _, _, m = make_train_step(ocfg, grad_accum=2, par=par)(
            sm, init_sharded_state(ocfg, sm), batch)
        out.append((m, dict(sm.full("cpu").named_parameters())))
    (m1, p1), (m2, p2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b"])
def test_mesh_step_with_uneven_device_groups_equals_one_device(arch):
    """Four data rows on two devices as 3 + 1 ("cpu" holds rows 0, 2, 3,
    "cpu:0" row 1): each group weighs its share of the rows, so the loss,
    the MoE aux and the gradient are the mean over all four rows, as the
    rows together give them."""
    from repro_torch.runtime.sharding import Parallelism, make_mesh

    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                              remat="none")
    ocfg = AdamWConfig(lr=1e-3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 16),
                                     generator=torch.Generator()
                                     .manual_seed(3))}
    uneven = Parallelism(mesh=make_mesh((4, 1), ("data", "model"),
                                        ["cpu", "cpu:0", "cpu"]))
    groups = {}
    for i, dev in enumerate(uneven.devices_by_data()[:, 0]):
        groups.setdefault(dev, []).append(i)
    assert sorted(map(len, groups.values())) == [1, 3]
    out = []
    for par in (make_test_parallelism(4, 1, device="cpu"), uneven):
        sm = shard_model(init_params(cfg, "cpu", seed=5), par)
        _, _, m = make_train_step(ocfg, grad_accum=2, par=par)(
            sm, init_sharded_state(ocfg, sm), batch)
        out.append((m, dict(sm.full("cpu").named_parameters())))
    (m1, p1), (m2, p2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The MoE's mesh branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,arch", MOE_CASES)
def test_moe_mesh_branch_matches_reference_shard_map(ref, mode, arch):
    cfg = configs.smoke(arch).moe
    assert cfg.mode == mode
    p = {k: torch.as_tensor(v) for k, v in
         tree_of(ref, f"moe_{mode}/p/").items()}
    x = torch.as_tensor(np.load(ref["dir"] / "inputs.npz")["moe_x"])
    par = make_test_parallelism(2, 2, device="cpu")
    y, aux = moe.moe_forward(p, x, cfg, par)
    np.testing.assert_allclose(y.numpy(), ref[f"moe_{mode}/y"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux), ref[f"moe_{mode}/aux"],
                               rtol=1e-5, atol=1e-5)
    # the per-shard estimator: the mean over the data rows of each row's
    # local aux
    want = np.mean([float(moe.moe_forward(p, x[i:i + 2], cfg)[1])
                    for i in (0, 2)])
    np.testing.assert_allclose(float(aux), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Compressed DP gradients
# ---------------------------------------------------------------------------


def test_compressed_dp_gradients_match_reference_over_16_rounds(ref):
    from repro_torch.runtime.sharding import make_mesh

    inp = np.load(ref["dir"] / "inputs.npz")
    xs, ys = torch.as_tensor(inp["xs"]), torch.as_tensor(inp["ys"])
    mesh = make_mesh((4,), ("data",), ["cpu"])

    def loss_fn(p, batch):
        x, y = batch
        return torch.mean((x @ p["w"] - y) ** 2)

    params = {"w": torch.zeros(32, 8)}
    grad_fn = make_compressed_dp_grad_fn(loss_fn, mesh)
    err = [init_error_feedback(params) for _ in range(4)]
    exact = ref["dp/exact"]
    scale = np.abs(exact).max()
    acc = np.zeros_like(exact)
    for r in range(17):
        loss, g, err = grad_fn(params, (xs, ys), err)
        assert len(err) == 4          # one residual per data shard
        np.testing.assert_allclose(g["w"].numpy(), ref[f"dp/g{r}"],
                                   rtol=0, atol=1e-6 * scale, err_msg=r)
        np.testing.assert_allclose(float(loss), ref[f"dp/loss{r}"],
                                   rtol=1e-6)
        if r == 0:
            assert np.abs(g["w"].numpy() - exact).max() / scale < 0.05
        else:
            acc += g["w"].numpy()
    assert np.abs(acc / 16 - exact).max() / scale < 0.01


# ---------------------------------------------------------------------------
# Elastic reshard, both ways
# ---------------------------------------------------------------------------


def test_reference_checkpoint_restores_on_4_shards_and_one_device(ref):
    cfg = configs.smoke(CKPT_ARCH)
    want = flat_np(tree_of(ref, "ckpt_ref/"))
    sm = shard_model(Model(cfg, "meta").to_empty(device="cpu"),
                     make_test_parallelism(2, 2, device="cpu"))
    tree = params_to_tree(sm)

    def shardings(t):
        return {k: shardings(v) if isinstance(v, dict) else v.sharding
                for k, v in t.items()}

    def meta(t):
        return {k: meta(v) if isinstance(v, dict) else
                torch.empty(v.shape, device="meta") for k, v in t.items()}

    like = {"params": meta(tree)}
    got4 = restore_pytree(like, ref["dir"] / "ref_ckpt", 1,
                          {"params": shardings(tree)})
    got1 = restore_pytree(like, ref["dir"] / "ref_ckpt", 1, device="cpu")
    manifest = json.loads((ref["dir"] / "ref_ckpt" / "step_00000001" /
                           "manifest.json").read_text())
    assert max(len(m["shards"]) for m in manifest["leaves"].values()) == 8
    f4, f1 = flat_np(got4["params"]), flat_np(got1["params"])
    assert set(f4) == set(want)
    for k, w in want.items():
        assert isinstance(f4[k], ShardedTensor)
        assert {b.device.type for b in f4[k].shards} == {"cpu"}
        assert torch.equal(f4[k].full(), f1[k]), k
        np.testing.assert_array_equal(f1[k].float().numpy(), w, err_msg=k)


def test_port_checkpoint_restores_on_reference_4_devices(ref):
    assert bool(ref["ckpt_port_ok"])
    manifest = json.loads((ref["dir"] / "port_ckpt" / "step_00000001" /
                           "manifest.json").read_text())
    wq = manifest["leaves"]["params/layers/attn/wq"]
    assert len(wq["shards"]) == 8 and wq["shards"][0]["index"][0] == [0, 2]
