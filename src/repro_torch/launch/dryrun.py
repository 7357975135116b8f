"""Multi-pod dry run: every (architecture × input shape × mesh) cell built
on the ``meta`` device over the production mesh, with its per-device
argument bytes, cost and collective traffic, and the H100 roofline — the
proof that the distribution config is coherent without the hardware.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell with XLA over 256 / 512 forced host devices (its
``XLA_FLAGS`` line has no counterpart here); the port runs the same step
functions eagerly on ``meta`` tensors over ``make_parallelism(...,
device="meta")``, where nothing is allocated or computed:

  * per-device argument bytes from the specs — parameters, optimizer
    state (``opt_shardings``) and ``batch_shardings`` /
    ``cache_shardings`` — the reference's ``memory_analysis`` figure;
  * FLOPs, bytes and collective bytes from ``runtime.op_cost`` at two
    reduced depths (``_reduced_cfg``), extrapolated linearly in depth
    units (``_depth_units``) to the full depth, as the reference's
    ``analysis_metrics`` does; a train cell's microbatch loop likewise,
    from two and three microbatches to ``default_grad_accum``'s count;
  * the roofline of ``runtime.roofline`` (H100 SXM peaks), with 80 GB
    per device as the memory limit (the reference: 16 GB per TPU chip).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh both [--jobs 4]
Results: one JSON per cell under --out (default experiments/dryrun_torch/).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch

from .. import configs
from ..checkpoint.layout import stacked_path
from ..configs.shapes import SHAPES, applicable, input_specs
from ..launch.mesh import make_parallelism
from ..models.transformer import Model, ModelConfig, decode_step, prefill
from ..runtime import roofline as rl
from ..runtime.op_cost import op_cost
from ..runtime.sharding import (NamedSharding, P, Parallelism, ShardedTensor,
                                param_shardings)
from ..training.optimizer import AdamWConfig
from ..training.step import (ShardedModel, init_sharded_state,
                             make_train_step)

# Archs whose optimizer state is int8-quantised (the reference's set, sized
# for 16 GB per TPU chip).
_INT8_OPT = {"qwen3-moe-235b-a22b", "mixtral-8x22b", "qwen3-32b"}
DEVICE_MEMORY = 80e9          # bytes per H100 80GB


def cache_shardings(cfg: ModelConfig, cache_like: dict, batch: int,
                    par: Parallelism) -> dict:
    """Sharding policy for decode caches: batch over the data axes when it
    divides; KV heads over model when they divide, otherwise the cache
    sequence dim goes over model (flash-decode style sharded-KV
    attention); batch=1 long-context shards the sequence over every
    axis.  Keyed as ``cache_like`` (``pos``, a Python int, gets none)."""
    dp = par.data_spec
    heads_div = cfg.n_kv_heads % par.model_size == 0
    b_div = batch % par.data_size == 0 and batch >= par.data_size
    bs = dp if b_div else None

    def kv_spec():
        # (L, B, S, K, Dh)
        if batch == 1:
            return P(None, None, tuple(par.all_axes), None, None)
        if heads_div:
            return P(None, bs, None, par.model_axis, None)
        return P(None, bs, par.model_axis, None, None)

    def spec_for(name: str, leaf):
        if name == "kv_positions":
            if batch == 1:
                return P(None, tuple(par.all_axes))
            return P(bs, None if heads_div else par.model_axis)
        if "cross_kv" in name:
            return P(None, bs, None,
                     par.model_axis if heads_div else None, None)
        if "self_kv" in name or "shared_kv" in name:
            return kv_spec()
        if name.endswith("ssm/ssm"):      # (L, B, H, P, N)
            return P(None, bs, par.model_axis, None, None)
        if name.endswith("ssm/conv"):     # (L, B, k-1, conv_dim)
            return P(None, bs, None, par.model_axis)
        return P(*([None] * leaf.ndim))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, f"{path}/{i}") for i, v in enumerate(node))
        if not isinstance(node, torch.Tensor):
            return None
        return NamedSharding(par.mesh, spec_for(path, node))

    return walk(cache_like, "")


def batch_shardings(cfg, specs: dict, par: Parallelism, batch: int) -> dict:
    dp = par.data_spec
    b_div = batch % par.data_size == 0 and batch >= par.data_size
    bs = dp if b_div else None
    out = {}
    for k, v in specs.items():
        if k == "tokens":
            out[k] = NamedSharding(par.mesh, P(bs, None))
        elif k == "memory":
            out[k] = NamedSharding(par.mesh, P(bs, None, None))
        elif k == "cache":
            out[k] = cache_shardings(cfg, v, batch, par)
        else:
            raise KeyError(k)
    return out


def default_grad_accum(cfg: ModelConfig, sh, par: Parallelism,
                       budget_bytes: float = 3e9) -> int:
    """Microbatch count sizing the per-device live-activation footprint
    (one (B_micro, S, d) residual per layer) to ~3 GB."""
    tokens_chip = sh.global_batch * sh.seq_len // par.data_size
    mult = 3 if cfg.kind in ("ssm", "hybrid") else 1
    total = (cfg.n_layers + cfg.enc_layers) * cfg.d_model * 2 * \
        tokens_chip * mult
    a = 1
    a_max = max(1, sh.global_batch // par.data_size)
    while total / a > budget_bytes and a < a_max:
        a *= 2
    return a


_CFG_TWEAKS: dict = {}   # set by --causal-skip / --q-chunk CLI flags


def _tweaked(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, **_CFG_TWEAKS) if _CFG_TWEAKS else cfg


def _device_bytes(tree, shardings) -> int:
    """Per-device bytes of ``tree``'s tensors under ``shardings`` (a tree
    of the same keys; None: replicated): each device holds one block."""
    if isinstance(tree, dict):
        return sum(_device_bytes(v, None if shardings is None
                                 else shardings.get(k))
                   for k, v in tree.items())
    if isinstance(tree, tuple):
        return sum(_device_bytes(v, None if shardings is None
                                 else shardings[i])
                   for i, v in enumerate(tree))
    if isinstance(tree, ShardedTensor):
        return tree.shards[0].numel() * tree.shards[0].element_size()
    if not isinstance(tree, torch.Tensor):
        return 0
    n = tree.numel() if shardings is None else \
        int(torch.tensor(shardings.shard_shape(tree.shape)).prod())
    return n * tree.element_size()


def _meta_sharded(cfg: ModelConfig, par: Parallelism) -> ShardedModel:
    """The model's parameters as ``ShardedTensor``s of ``meta`` blocks."""
    skel = Model(cfg, device="meta")
    named = dict(skel.named_parameters())
    shardings = param_shardings(named, par, stacked_path)
    params = {}
    for k, t in named.items():
        sh = shardings[k]
        params[k] = ShardedTensor(
            [torch.empty(sh.shard_shape(t.shape), dtype=t.dtype,
                         device="meta") for _ in sh.devices(t.ndim)], sh)
    return ShardedModel(skel, params, par)


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               remat: str | None = None, grad_accum: int | None = None,
               cfg_override: ModelConfig | None = None,
               par: Parallelism | None = None) -> tuple:
    """One dry-run cell on ``meta``: ``(fn, args, meta)`` with ``fn(*args)``
    the cell's step.  ``meta`` holds the per-device argument bytes.
    ``par``: another mesh on ``meta`` (default: the production one)."""
    cfg = _tweaked(cfg_override if cfg_override is not None
                   else configs.get(arch))
    sh = SHAPES[shape_name]
    par = par or make_parallelism(multi_pod=multi_pod, device="meta")
    chips = par.mesh.size
    if sh.step == "train":
        cfg = dataclasses.replace(cfg, remat=remat or "full")
    specs = input_specs(cfg, shape_name)
    bshard = batch_shardings(cfg, specs, par, sh.global_batch)
    n_tokens = sh.global_batch * sh.seq_len

    if sh.step == "train":
        sm = _meta_sharded(cfg, par)
        ocfg = AdamWConfig(int8_moments=arch in _INT8_OPT)
        opt_state = init_sharded_state(ocfg, sm)
        accum = grad_accum or default_grad_accum(configs.get(arch), sh, par)
        fn = make_train_step(ocfg, grad_accum=accum, par=par)
        args = (sm, opt_state, specs)
        arg_bytes = (_device_bytes(sm.params, None)
                     + _device_bytes(opt_state["moments"], None)
                     + opt_state["step"].element_size()
                     + _device_bytes(specs, bshard))
        model_flops = rl.model_flops_train(cfg, n_tokens)
    else:
        model = Model(cfg, device="meta")
        pbytes = _device_bytes(dict(model.named_parameters()),
                               param_shardings(dict(model.named_parameters()),
                                               par, stacked_path))
        if sh.step == "prefill":
            def fn(model, batch):
                return prefill(model, batch["tokens"],
                               memory=batch.get("memory"),
                               max_seq=sh.seq_len, par=par)
            model_flops = rl.model_flops_prefill(cfg, n_tokens)
        else:
            specs["cache"]["pos"] = sh.seq_len - 1

            def fn(model, batch):
                return decode_step(model, batch["cache"], batch["tokens"],
                                   par=par)
            model_flops = rl.model_flops_decode(cfg, sh.global_batch)
        args = (model, specs)
        arg_bytes = pbytes + _device_bytes(specs, bshard)

    meta = {"arch": arch, "shape": shape_name,
            "mesh": "pod2x16x16" if multi_pod else "16x16",
            "chips": chips, "step": sh.step,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "model_flops": model_flops,
            "argument_size_in_bytes": int(arg_bytes)}
    if sh.step == "train":
        meta["grad_accum"] = accum
        meta["remat"] = cfg.remat
    return fn, args, meta


# ---------------------------------------------------------------------------
# Analysis pass: two REDUCED-DEPTH variants of the same cell, extrapolated
# linearly in depth units (layers; groups for hybrid/vlm; enc+dec layer
# pairs for enc-dec).
# ---------------------------------------------------------------------------


def _depth_units(cfg: ModelConfig):
    """(unit-size-in-layers, full-unit-count, [L1, L2])."""
    if cfg.kind == "hybrid":
        e = cfg.hybrid_attn_every
        return e, cfg.n_layers / e, [e, 2 * e]
    if cfg.kind == "vlm":
        e = cfg.cross_attn_every
        return e, cfg.n_layers / e, [e, 2 * e]
    return 1, float(cfg.n_layers), [2, 4]


def _reduced_cfg(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    repl = dict(n_layers=n_layers, unroll_scans=True,
                attn_kv_chunk=8192, attn_q_chunk=32768)
    if cfg.kind == "encdec":
        repl["enc_layers"] = n_layers
    return dataclasses.replace(cfg, **repl)


def analysis_metrics(arch: str, shape_name: str, multi_pod: bool,
                     remat: str | None = None,
                     grad_accum: int | None = None,
                     cfg_base: ModelConfig | None = None) -> dict:
    cfg_full = cfg_base if cfg_base is not None else configs.get(arch)
    _, full_units, depths = _depth_units(cfg_full)
    sh = SHAPES[shape_name]
    accum = grad_accum
    if sh.step == "train" and accum is None:
        accum = default_grad_accum(
            cfg_full, sh, make_parallelism(multi_pod=multi_pod,
                                           device="meta"))
    points = []
    for L in depths:
        cfg_r = _reduced_cfg(cfg_full, L)
        if sh.step != "train":
            fn, args, _ = build_cell(arch, shape_name, multi_pod,
                                     remat=remat, cfg_override=cfg_r)
            cost = op_cost(fn, *args)
            points.append({"flops": cost.flops, "bytes": cost.bytes,
                           "coll": cost.collective_bytes})
            continue
        # The microbatch loop is linear in its count, as the depth is:
        # two and three microbatches of the cell's size (both sum their
        # gradients in f32), then a line to ``accum`` (the reference
        # multiplies its scan body instead); one or two are traced whole.
        mb = sh.global_batch // accum
        ks = (accum,) if accum <= 2 else (2, 3)
        c = []
        for k in ks:
            fn, (sm, state, batch), _ = build_cell(
                arch, shape_name, multi_pod, remat=remat, grad_accum=k,
                cfg_override=cfg_r)
            c.append(op_cost(fn, sm, state,
                             {n: v[:k * mb] for n, v in batch.items()}))
        slope = (lambda a: 0.0) if len(c) == 1 else (
            lambda a: getattr(c[1], a) - getattr(c[0], a))
        points.append({key: getattr(c[0], a) + (accum - ks[0]) * slope(a)
                       for key, a in (("flops", "flops"), ("bytes", "bytes"),
                                      ("coll", "collective_bytes"))})
    u1, u2 = 1.0, 2.0   # depths are [unit, 2·unit]
    if depths == [2, 4]:
        u1, u2 = 2.0, 4.0
    out = {}
    for k in ("flops", "bytes", "coll"):
        m1, m2 = points[0][k], points[1][k]
        out[k] = m1 + (m2 - m1) / (u2 - u1) * (full_units - u1)
    out["depth_points"] = {str(d): p for d, p in zip(depths, points)}
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path):
    mesh_name = "multi" if multi_pod else "single"
    cell = f"{arch}__{shape_name}__{mesh_name}"
    out_path = out_dir / f"{cell}.json"
    cfg = configs.get(arch)
    ok, reason = applicable(cfg, shape_name)
    if not ok:
        out_path.write_text(json.dumps(
            {"cell": cell, "status": "skipped", "reason": reason}, indent=2))
        print(f"[dryrun] {cell}: SKIP ({reason})")
        return "skipped"
    t0 = time.time()
    try:
        _, _, meta = build_cell(arch, shape_name, multi_pod)
        t_build = time.time() - t0
        t1 = time.time()
        walked = analysis_metrics(arch, shape_name, multi_pod,
                                  grad_accum=meta.get("grad_accum"))
        chips = meta["chips"]
        per_dev = {"flops": walked["flops"] / chips,
                   "bytes accessed": walked["bytes"] / chips}
        terms = rl.terms_from_analysis(per_dev, walked["coll"] / chips,
                                       chips, meta["model_flops"])
        analysis = {"flops_global": walked["flops"],
                    "bytes_global": walked["bytes"],
                    "collective_bytes_global": walked["coll"],
                    "depth_points": walked["depth_points"],
                    "method": "op_cost on meta at two depths, extrapolated "
                              "(collectives: the mesh's recorded gathers "
                              "and sums)",
                    "seconds": round(time.time() - t1, 1)}
        arg = meta.pop("argument_size_in_bytes")
        result = {
            "cell": cell, "status": "ok", **meta,
            "build_s": round(t_build, 1),
            "memory": {"argument_size_in_bytes": arg,
                       "device_memory_bytes": DEVICE_MEMORY,
                       "fits": arg <= DEVICE_MEMORY},
            "analysis": analysis,
            "roofline": terms.as_dict(),
        }
        out_path.write_text(json.dumps(result, indent=2))
        print(f"[dryrun] {cell}: OK build={t_build:.1f}s analysis="
              f"{analysis['seconds']:.1f}s args/device={arg / 1e9:.2f} GB "
              f"dominant={terms.dominant} "
              f"frac={terms.roofline_fraction:.3f}")
        return "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        out_path.write_text(json.dumps(
            {"cell": cell, "status": "error", "error": repr(e),
             "traceback": traceback.format_exc()[-4000:]}, indent=2))
        print(f"[dryrun] {cell}: ERROR {e!r}")
        return "error"


def _run_cell_tweaked(arch, shape, mp, out_dir, tweaks):
    _CFG_TWEAKS.update(tweaks)
    return run_cell(arch, shape, mp, out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--causal-skip", action="store_true",
                    help="enable flash-attention causal block skipping")
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells built in parallel processes")
    args = ap.parse_args(argv)
    if args.causal_skip:
        _CFG_TWEAKS["attn_causal_skip"] = True
    if args.q_chunk:
        _CFG_TWEAKS["attn_q_chunk"] = args.q_chunk
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = configs.list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    statuses, todo = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cell = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                if args.skip_existing and (out_dir / f"{cell}.json").exists():
                    prev = json.loads((out_dir / f"{cell}.json").read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        statuses.append(prev["status"])
                        continue
                todo.append((arch, shape, mp, out_dir))
    if args.jobs > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            statuses += pool.starmap(_run_cell_tweaked,
                                     [t + (dict(_CFG_TWEAKS),) for t in todo])
    else:
        statuses += [run_cell(*t) for t in todo]
    n_err = statuses.count("error")
    print(f"[dryrun] done: {statuses.count('ok')} ok, "
          f"{statuses.count('skipped')} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
