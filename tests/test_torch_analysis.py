"""The port's analysis tools against the reference's, on the CPU.

``configs/shapes.py`` (input specs on ``meta``), ``runtime/roofline.py``
(the H100's peaks), ``runtime/collectives.py`` and ``runtime/op_cost.py``
(the counterparts of ``hlo.py`` and ``jaxpr_cost.py``), the dry run and
``obs/calibration.h100_bound_s``.  ``op_cost`` is exact on a matmul and on
a loop of 16, and its FLOPs are within 15 % of ``jaxpr_cost``'s on the
smoke train step (the reference's own tolerance against XLA).  The dry
run's per-device argument bytes equal the sum of the reference's
``NamedSharding.shard_shape`` sizes on a (2, 2) mesh, which the reference
builds in one subprocess with ``--xla_force_host_platform_device_count=4``
(tokens are int64 in the port, int32 in the reference: 4 bytes a token
apart).
"""
import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro.runtime import roofline as ref_rl
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_parallelism,
                                     make_production_mesh,
                                     make_test_parallelism)
from repro_torch.models.transformer import Model
from repro_torch.obs.calibration import h100_bound_s
from repro_torch.runtime import collectives
from repro_torch.runtime import roofline as rl
from repro_torch.runtime.op_cost import op_cost
from repro_torch.runtime.sharding import Parallelism, spec_for
from repro_torch.training.optimizer import AdamWConfig, init_state
from repro_torch.training.step import make_train_step, trainable

ROOT = pathlib.Path(__file__).resolve().parents[1]

REF_SCRIPT = r"""
import functools, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs
from repro.configs.shapes import SHAPES, input_specs
from repro.models.transformer import init_params
from repro.runtime.sharding import Parallelism, param_shardings
from repro.training.optimizer import AdamWConfig, init_state
from repro.training.step import opt_shardings

assert len(jax.devices()) == 4
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
par = Parallelism(mesh=mesh, data_axes=("data",), model_axis="model",
                  fsdp_axis="data")
from repro.launch import dryrun   # after the devices: its XLA_FLAGS is moot
from repro.launch.dryrun import _INT8_OPT, batch_shardings

def dev_bytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(shardings)
    return int(sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
                   for l, s in zip(leaves, shs)))

out = {}
for arch in configs.list_archs():
    cfg = configs.get(arch)
    ps = jax.eval_shape(functools.partial(init_params, cfg=cfg),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    os_ = jax.eval_shape(functools.partial(
        init_state, AdamWConfig(int8_moments=arch in _INT8_OPT)), ps)
    specs = input_specs(cfg, "train_4k")
    out[arch] = {
        "params": dev_bytes(ps, param_shardings(ps, par)),
        "opt": dev_bytes(os_, opt_shardings(ps, os_, par)),
        "batch": dev_bytes(specs, batch_shardings(cfg, specs, par, 256)),
        "tokens": int(np.prod(specs["tokens"].shape)) // 2,
        "depth_units": list(dryrun._depth_units(cfg)),
        "reduced": [getattr(dryrun._reduced_cfg(cfg, 3), f) for f in
                    ("n_layers", "enc_layers", "attn_kv_chunk",
                     "attn_q_chunk", "unroll_scans")],
        "grad_accum": {f"{n}|{d}": dryrun.default_grad_accum(
            cfg, SHAPES[n], type("P", (), {"data_size": d})())
            for n in SHAPES for d in (16, 32)}}
out["_int8_opt"] = sorted(_INT8_OPT)
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_bytes():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=600)
    assert r.returncode == 0 and "JSON" in r.stdout, r.stderr[-4000:]
    return json.loads(r.stdout.split("JSON", 1)[1])


# ---------------------------------------------------------------------------
# configs/shapes.py
# ---------------------------------------------------------------------------


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("shape", shapes.SHAPE_NAMES)
@pytest.mark.parametrize("arch", configs.list_archs())
def test_input_specs_match_reference(arch, shape):
    cfg, ref_cfg = configs.get(arch), ref_configs.get(arch)
    assert shapes.applicable(cfg, shape) == ref_shapes.applicable(ref_cfg,
                                                                  shape)
    assert shapes.is_subquadratic(cfg) == ref_shapes.is_subquadratic(ref_cfg)
    got = leaves(shapes.input_specs(cfg, shape))
    want = leaves(ref_shapes.input_specs(ref_cfg, shape))
    # the cache's position is a Python int in the port (a 0-d int32 there)
    assert isinstance(got.pop("cache/pos", 0), int)
    want.pop("cache/pos", None)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "meta" and tuple(g.shape) == tuple(w.shape), k
        if k == "tokens":
            assert g.dtype == torch.int64
        else:
            assert str(g.dtype).split(".")[1] == str(w.dtype), k
    assert shapes.SHAPES[shape] == shapes.ShapeSpec(
        **dataclasses.asdict(ref_shapes.SHAPES[shape]))


# ---------------------------------------------------------------------------
# runtime/roofline.py, obs/calibration.py
# ---------------------------------------------------------------------------


def test_roofline_terms_and_dominance_at_h100_peaks():
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 * 2}
    t = rl.terms_from_analysis(cost, collective_bytes=450e9 * 3, chips=4,
                               model_flops=4 * 989e12 * 0.5)
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 2.0) < 1e-9
    assert abs(t.collective_s - 3.0) < 1e-9
    assert t.dominant == "collective" and t.bound_s == t.collective_s
    assert abs(t.roofline_fraction - 0.5 / 3.0) < 1e-9
    assert abs(t.useful_ratio - 0.5) < 1e-9
    assert set(t.as_dict()) == set(ref_rl.RooflineTerms(
        1, 1, 1, 1, 1, 1, 1).as_dict())
    cfg, ref_cfg = configs.get("qwen3-moe-235b-a22b"), ref_configs.get(
        "qwen3-moe-235b-a22b")
    for fn in ("model_flops_train", "model_flops_decode",
               "model_flops_prefill"):
        assert getattr(rl, fn)(cfg, 1024) == getattr(ref_rl, fn)(ref_cfg,
                                                                 1024)


@pytest.mark.parametrize("flops,nbytes", [(0.0, 0.0), (1e9, 1e6),
                                          (1e6, 1e9), (123456789.0,
                                                       987654321.0),
                                          (6.7e13, 3.35e12)])
def test_h100_bound_s_unchanged_through_the_roofline(flops, nbytes):
    """The same value as before it priced through terms_from_analysis: f32
    work at 67 TFLOP/s, bytes at 3.35 TB/s."""
    assert h100_bound_s(flops, nbytes) == max(flops / (67.0 * 1e12),
                                              nbytes / (3350.0 * 1e9))


# ---------------------------------------------------------------------------
# runtime/op_cost.py and runtime/collectives.py
# ---------------------------------------------------------------------------


def test_op_cost_matmul_exact():
    M, K, N = 128, 64, 32
    c = op_cost(lambda a, b: a @ b, torch.empty(M, K), torch.empty(K, N))
    assert c.flops == 2 * M * K * N
    # the dot's operands and result, then the program's inputs and output
    assert c.bytes == 2 * 4 * (M * K + K * N + M * N)
    assert collectives.count_op(c.ops, "mm") == 1


def test_op_cost_loop_of_16_is_traced_whole():
    M, K = 64, 64

    def loop(a, ws):
        for w in ws:
            a = a @ w
        return a
    c = op_cost(loop, torch.empty(M, K), torch.empty(16, K, K))
    assert c.flops == 16 * 2 * M * K * K
    assert collectives.count_op(c.ops, "aten.mm") == 16


def test_op_cost_counts_the_mesh_collectives():
    par = make_test_parallelism(2, 2, device="meta")
    cfg = configs.smoke("granite-3-2b")
    fn, args, meta = dryrun.build_cell("granite-3-2b", "train_4k", False,
                                       grad_accum=1, par=par,
                                       cfg_override=dataclasses.replace(
                                           cfg, n_layers=1))
    c = op_cost(fn, *args)
    assert c.collective_bytes > 0 and c.flops > 0
    # every leaf gathered once for the step's rows on the one device and
    # its gradient cut back: params' bytes x 4 receivers, twice
    named = dict(args[0].model.named_parameters())
    sharded = sum(t.numel() * t.element_size() for k, t in named.items()
                  if len(args[0].params[k].shards) > 1)
    assert c.collective_bytes >= 2 * 4 * sharded


def test_op_cost_within_15_percent_of_jaxpr_cost_on_the_smoke_step():
    from repro.models.transformer import init_params as ref_init
    from repro.runtime.jaxpr_cost import jaxpr_cost
    from repro.runtime.sharding import single_device
    from repro.training.optimizer import (AdamWConfig as RefOpt,
                                          init_state as ref_state)
    from repro.training.step import make_train_step as ref_step

    ref_cfg = dataclasses.replace(ref_configs.smoke("granite-3-2b"),
                                  remat="none")
    ps = jax.eval_shape(functools.partial(ref_init, cfg=ref_cfg),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    os_ = jax.eval_shape(functools.partial(ref_state, RefOpt()), ps)
    want = jaxpr_cost(ref_step(ref_cfg, single_device(), RefOpt()), ps, os_,
                      {"tokens": jax.ShapeDtypeStruct((4, 64), jnp.int32)})
    cfg = dataclasses.replace(configs.smoke("granite-3-2b"), remat="none")
    model = Model(cfg, "meta")
    ocfg = AdamWConfig()
    got = op_cost(make_train_step(ocfg), model,
                  init_state(ocfg, trainable(model)),
                  {"tokens": torch.empty(4, 64, dtype=torch.int64)})
    assert abs(got.flops - want.flops) / want.flops < 0.15
    assert got.collective_bytes == 0 == want.collective_bytes


def test_collective_stats_summary():
    with collectives.recording() as outer:
        with collectives.recording() as inner:
            collectives.record("all-reduce", torch.empty(8), 4)
        collectives.record("all-gather", torch.empty(2, dtype=torch.int8), 3)
    assert inner.summary() == {"total_bytes": 256.0,
                               "by_kind": {"all-reduce": 256.0},
                               "counts": {"all-reduce": 1}}
    assert outer.total_bytes == 262.0
    collectives.record("all-reduce", torch.empty(8), 4)   # no block open


# ---------------------------------------------------------------------------
# The meshes, the rules and the dry run
# ---------------------------------------------------------------------------


def test_production_meshes_need_their_devices_or_meta(monkeypatch):
    par = make_parallelism(multi_pod=True, device="meta")
    assert par.mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert par.data_axes == ("pod", "data") and par.data_size == 32
    assert make_production_mesh(device="meta").shape == {"data": 16,
                                                         "model": 16}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="256 devices"):
        make_production_mesh()


def test_sharding_rules_as_the_reference_test_holds_them():
    par = Parallelism(mesh=None)
    assert tuple(spec_for("layers/attn/wq", (4, 64, 128), par)) == \
        (None, "data", "model")
    assert tuple(spec_for("embed/table", (1024, 64), par)) == \
        ("model", "data")
    assert tuple(spec_for("layers/moe_ep/w_gate", (2, 8, 64, 128), par)) \
        == (None, "model", "data", None)
    assert tuple(spec_for("final_norm/scale", (64,), par)) == (None,)
    par = make_test_parallelism(2, 2, device="meta")
    assert tuple(spec_for("embed/table", (49155, 64), par)) == \
        (None, "data")


@pytest.mark.parametrize("arch", configs.list_archs())
def test_dryrun_rules_match_reference(ref_bytes, arch):
    w = ref_bytes[arch]
    cfg = configs.get(arch)
    assert list(dryrun._depth_units(cfg)) == w["depth_units"]
    r = dryrun._reduced_cfg(cfg, 3)
    assert [r.n_layers, r.enc_layers, r.attn_kv_chunk, r.attn_q_chunk,
            r.unroll_scans] == w["reduced"]
    for mp in (False, True):
        par = make_parallelism(multi_pod=mp, device="meta")
        for name in shapes.SHAPE_NAMES:
            assert dryrun.default_grad_accum(cfg, shapes.SHAPES[name], par) \
                == w["grad_accum"][f"{name}|{par.data_size}"]
    assert sorted(dryrun._INT8_OPT) == ref_bytes["_int8_opt"]


@pytest.mark.parametrize("arch", configs.list_archs())
def test_dryrun_argument_bytes_match_reference_shard_shapes(ref_bytes, arch):
    par = make_test_parallelism(2, 2, device="meta")
    _, args, meta = dryrun.build_cell(arch, "train_4k", False, par=par,
                                      grad_accum=1)
    w = ref_bytes[arch]
    assert meta["argument_size_in_bytes"] == (
        w["params"] + w["opt"] + w["batch"] + 4 * w["tokens"])


def test_dryrun_cells_run_and_write_their_json(tmp_path, capsys):
    rc = dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                      "--mesh", "both", "--out", str(tmp_path)])
    rc2 = dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                       "--mesh", "single", "--out", str(tmp_path)])
    assert rc == 0 == rc2
    out = capsys.readouterr().out
    assert "2 ok, 0 skipped, 0 errors" in out and "1 skipped" in out
    cell = json.loads((tmp_path / "granite-3-2b__decode_32k__multi.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["chips"] == 512
    assert cell["memory"]["fits"]
    assert cell["roofline"]["dominant"] == "memory"
    assert cell["analysis"]["flops_global"] > 0
    assert cell["model_flops"] == rl.model_flops_decode(
        configs.get("granite-3-2b"), 128)
    skip = json.loads((tmp_path / "granite-3-2b__long_500k__single.json")
                      .read_text())
    assert skip["status"] == "skipped"
