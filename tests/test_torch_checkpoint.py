"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
reference's tests of ``repro.checkpoint`` (round trip, integrity, async
retention, an invisible ``.tmp``, kill and resume through the launcher,
bitwise), and checkpoints that cross-load both ways between the packages
with sha256 verification on, bf16 parameters and int8 moments included.
The elastic resharding restore comes with the device mesh."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import restore_pytree as ref_restore
from repro.checkpoint import save_pytree as ref_save
from repro.models import transformer as ref_tf
from repro.training import optimizer as ref_opt
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    params_to_tree, restore_pytree,
                                    save_pytree, state_from_tree,
                                    state_to_tree)
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt
from repro_torch.training.step import trainable

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((16, 8), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.randn((3,), generator=g).to(torch.bfloat16)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = torch.as_tensor(fa[k]), torch.as_tensor(fb[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert torch.equal(x, y), k


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path, step=7)
    assert latest_step(tmp_path) == 7
    like = {"a": torch.empty((16, 8), device="meta"),
            "nested": {"b": np.zeros(10), "c": torch.empty(3)},
            "step": torch.empty(())}
    assert_trees_equal(restore_pytree(like, tmp_path, 7, device="cpu"), t)
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert man["leaves"]["nested/c"]["dtype"] == "bfloat16"
    assert man["leaves"]["step"]["shape"] == []


def test_integrity_check(tmp_path):
    t = _tree()
    d = save_pytree(t, tmp_path, step=1)
    victim = sorted(d.glob("*.npy"))[0]
    arr = np.load(victim).copy()
    arr.reshape(-1)[0] += 1
    np.save(victim, arr)
    with pytest.raises(IOError, match="checksum"):
        restore_pytree(t, tmp_path, 1, device="cpu")
    with pytest.raises(KeyError, match="missing leaf"):
        restore_pytree({"zz": torch.empty(1)}, tmp_path, 1, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_pytree({**t, "a": torch.empty(2)}, tmp_path, 1, verify=False,
                       device="cpu")


def test_manager_async_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        live = _tree(s)
        mgr.save_async(live, s)
        live["a"].add_(100.0)   # training goes on in place
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1])
                   for p in pathlib.Path(tmp_path).glob("step_*"))
    assert steps == [3, 4], "retention must keep the newest 2"
    restored, step = mgr.restore_latest(_tree(0), device="cpu")
    assert step == 4
    assert_trees_equal(restored, _tree(4))


def test_manager_reraises_a_writer_error(tmp_path):
    mgr = CheckpointManager(tmp_path / "file")
    (tmp_path / "file").write_text("not a directory")
    mgr.save_async(_tree(), 1)
    with pytest.raises(OSError):
        mgr.wait()


def test_tmp_dir_never_visible_as_checkpoint(tmp_path):
    (pathlib.Path(tmp_path) / "step_00000009.tmp").mkdir(parents=True)
    save_pytree(_tree(), tmp_path, step=3)
    assert latest_step(tmp_path) == 3
    assert latest_step(tmp_path / "absent") is None


def test_kill_resume_bitwise_identical(tmp_path):
    """Train 6 steps; separately train 3, then resume for 3 more, each in
    its own process through the port's launcher on the CPU: the resumed
    losses equal the uninterrupted run's bit for bit."""
    code = """
        from repro_torch.launch.train import main
        losses = main(["--arch", "granite-3-2b", "--smoke", "--steps",
                       "{steps}", "--global-batch", "4", "--seq-len", "32",
                       "--ckpt-dir", "{ckpt}", "--ckpt-every", "3",
                       "--log-every", "100", "--warmup-steps", "2",
                       "--decay-steps", "6", "--device", "cpu"{resume}])
        print("LOSSES", repr(losses))
    """
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"]}

    def run(steps, ckpt, resume=False):
        r = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(code).format(
                steps=steps, ckpt=ckpt,
                resume=', "--resume"' if resume else "")],
            capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout, eval(r.stdout.split("LOSSES")[1])

    _, a = run(6, tmp_path / "full")
    run(3, tmp_path / "split")
    out, b = run(6, tmp_path / "split", resume=True)
    assert "[train] resumed from step 3" in out
    assert len(a) == 6 and len(b) == 3
    assert a[3:] == b, (a, b)
    # the resumed run's final checkpoint equals the uninterrupted one's
    like = _flat_like(tmp_path / "full", 6)
    assert_trees_equal(restore_pytree(like, tmp_path / "full", 6,
                                      device="cpu"),
                       restore_pytree(like, tmp_path / "split", 6,
                                      device="cpu"))


def _flat_like(directory, step):
    """A tree_like of meta tensors from a checkpoint's manifest."""
    man = json.loads((pathlib.Path(directory) / f"step_{step:08d}"
                      / "manifest.json").read_text())
    tree: dict = {}
    for path, meta in man["leaves"].items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.empty(meta["shape"], device="meta")
    return tree


# ---------------------------------------------------------------------------
# Cross-loading between the packages
# ---------------------------------------------------------------------------

def wide_pair():
    """granite's smoke config widened so that per-layer leaves reach the
    int8 block (last axes of 256 and more), in bf16."""
    kw = dict(d_model=256, d_ff=512)
    return (dataclasses.replace(ref_configs.smoke("granite-3-2b"), **kw),
            dataclasses.replace(configs.smoke("granite-3-2b"), **kw))


def ref_state_after_a_step(ref_cfg, int8: bool):
    params = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    ocfg = ref_opt.AdamWConfig(int8_moments=int8, warmup_steps=1)
    state = ref_opt.init_state(ocfg, params)
    grads = jax.tree_util.tree_map(
        lambda p: jax.random.normal(jax.random.PRNGKey(3), p.shape, p.dtype),
        params)
    return ref_opt.apply_updates(ocfg, params, grads, state)


def as_torch(tree):
    def leaf(a):
        a = jnp.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.tensor(np.asarray(a.astype(jnp.float32))).to(
                torch.bfloat16)
        return torch.tensor(np.asarray(a))
    return jax.tree_util.tree_map(leaf, tree)


@pytest.mark.parametrize("int8", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, int8):
    ref_cfg, cfg = wide_pair()
    params, state = ref_state_after_a_step(ref_cfg, int8)
    ref_save({"params": params, "opt": state}, tmp_path, step=1)
    model = tf.init_params(cfg, "cpu", seed=0)
    ocfg = opt.AdamWConfig(int8_moments=int8)
    pstate = opt.init_state(ocfg, trainable(model))
    like = {"params": params_to_tree(model),
            "opt": state_to_tree(pstate)}
    restored = restore_pytree(like, tmp_path, 1, verify=True, device="cpu")
    model = tf.params_from_numpy(cfg, restored["params"], "cpu")
    pstate = state_from_tree(restored["opt"],
                             opt.init_state(ocfg, trainable(model)))
    assert_trees_equal({"params": params_to_tree(model),
                        "opt": state_to_tree(pstate)},
                       as_torch({"params": params, "opt": state}))
    assert model["lm_head"].dtype == torch.bfloat16
    if int8:
        st = pstate["moments"]["layers.1.mlp.w_down"]
        assert st["m_q"].dtype == torch.int8 and st["m_q"].any()


@pytest.mark.parametrize("int8", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, int8):
    ref_cfg, cfg = wide_pair()
    model = tf.init_params(cfg, "cpu", seed=0)
    ocfg = opt.AdamWConfig(int8_moments=int8, warmup_steps=1)
    params = trainable(model)
    state = opt.init_state(ocfg, params)
    g = torch.Generator().manual_seed(3)
    grads = {k: torch.randn(p.shape, generator=g).to(p.dtype)
             for k, p in params.items()}
    opt.apply_updates(ocfg, params, grads, state, tf.decayed_names(params))
    tree = {"params": params_to_tree(model),
            "opt": state_to_tree(state)}
    save_pytree(tree, tmp_path, step=1)
    like = jax.eval_shape(lambda: dict(zip(("params", "opt"),
                                           ref_state_after_a_step(ref_cfg,
                                                                  int8))))
    restored = ref_restore(like, tmp_path, 1, verify=True)
    assert restored["params"]["lm_head"].dtype == jnp.bfloat16
    assert restored["opt"]["step"].dtype == jnp.int32
    assert_trees_equal(as_torch(restored), tree)
