"""Training launcher: the end-to-end loop with checkpoint and restart,
the step watchdog, preemption handling and the deterministic token
pipeline.

Counterpart of ``repro/launch/train.py``, with the same flags::

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --steps 200 --ckpt-dir /tmp/run1 [--resume]

It trains on the card unless ``--device cpu``, and raises when there is
no card and no ``--device cpu``.  Without ``--smoke`` it trains the full
published config.  ``--mesh-devices d,m`` trains over a (data, model)
test mesh placed round robin on the cards (all on the CPU with
``--device cpu``); ``prod`` / ``prod-multipod`` ask for the 256- / 512-
device production mesh, which raises with fewer devices.  The parameters
and moments are then sharded (``training.step``), and checkpoints are
written and restored with their shardings, onto whatever mesh the
resuming run has.  Checkpoints are the reference's format, so a run of
either package resumes the other's.
"""
from __future__ import annotations

import argparse

from .. import configs
from ..runtime.fault_tolerance import PreemptionHandler, StepWatchdog


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="0 → min(100, steps/10+1)")
    ap.add_argument("--decay-steps", type=int, default=0,
                    help="0 → --steps.  Set explicitly so a resumed run "
                         "keeps the original schedule horizon")
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-devices", default="",
                    help="'data,model' counts for a test mesh; 'prod' / "
                         "'prod-multipod' for the 256/512-device mesh")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to train on "
                         "the CPU)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Train as the flags say.  Returns the losses and grad norms of the
    steps run, each step's seconds (the host clock around a step that
    ends in reading its loss), the step resumed from, and the model and
    optimizer state after the last step."""
    import torch

    from ..checkpoint import (CheckpointManager, params_to_tree,
                              sharded_checkpoint_like, state_from_tree,
                              state_to_tree)
    from ..data.tokens import TokenPipeline, TokenPipelineConfig
    from ..models.transformer import init_params, params_from_numpy
    from ..runtime.sharding import single_device
    from ..training.optimizer import AdamWConfig, init_state
    from ..training.step import (init_sharded_state, make_train_step,
                                 shard_model, sharded_from_tree, trainable)
    from .mesh import make_parallelism, make_test_parallelism

    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to train on the CPU")
    if args.mesh_devices in ("prod", "prod-multipod"):
        par = make_parallelism(multi_pod=args.mesh_devices != "prod",
                               device=args.device)
    elif args.mesh_devices:
        d, m = (int(x) for x in args.mesh_devices.split(","))
        par = make_test_parallelism(d, m, device=args.device)
    else:
        par = single_device()
    device = (par.mesh.devices.flat[0] if par.mesh is not None
              else torch.device(args.device or "cuda"))
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    opt = AdamWConfig(lr=args.lr, int8_moments=args.int8_opt,
                      warmup_steps=(args.warmup_steps
                                    or min(100, args.steps // 10 + 1)),
                      decay_steps=args.decay_steps or args.steps)
    step_fn = make_train_step(opt, grad_accum=args.grad_accum, par=par)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, global_batch=args.global_batch,
        seq_len=args.seq_len, seed=args.seed), device)

    model = init_params(cfg, device, seed=args.seed)
    if par.mesh is not None:
        model = shard_model(model, par)
        opt_state = init_sharded_state(opt, model)
    else:
        opt_state = init_state(opt, trainable(model))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if ckpt and args.resume:
        if par.mesh is not None:
            like, shardings = sharded_checkpoint_like(model, opt_state)
        else:
            like = {"params": params_to_tree(model),
                    "opt": state_to_tree(opt_state)}
            shardings = None
        restored, step0 = ckpt.restore_latest(like, shardings, device)
        if restored is not None:
            model = (sharded_from_tree(cfg, restored["params"], par)
                     if par.mesh is not None else
                     params_from_numpy(cfg, restored["params"], device))
            opt_state = state_from_tree(restored["opt"], opt_state)
            start = step0
            print(f"[train] resumed from step {start}")

    def tree():
        return {"params": params_to_tree(model),
                "opt": state_to_tree(opt_state)}

    watchdog = StepWatchdog(on_slow=lambda ev: print(
        f"[watchdog] slow step {ev.step}: {ev.seconds:.2f}s "
        f"(median {ev.median:.2f}s) — cutting early checkpoint"))
    losses, norms, seconds = [], [], []
    step = start - 1
    with PreemptionHandler() as pre:
        for step in range(start, args.steps):
            watchdog.start(step)
            batch = pipe.batch_at(step)
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            losses.append(float(metrics["loss"]))
            dt = watchdog.stop()
            seconds.append(dt)
            norms.append(float(metrics["grad_norm"]))
            if step % args.log_every == 0:
                print(f"[train] step {step} loss {losses[-1]:.4f} "
                      f"gnorm {norms[-1]:.3f} {dt:.2f}s")
            slow = watchdog.events and watchdog.events[-1].step == step
            if ckpt and (step % args.ckpt_every == args.ckpt_every - 1
                         or pre.preempted or slow):
                ckpt.save_async(tree(), step + 1, {"loss": losses[-1]})
            if pre.preempted:
                print("[train] preemption requested — checkpointed, exiting")
                break
    if ckpt and losses:
        ckpt.save_sync(tree(), step + 1, {"loss": losses[-1]})
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} "
              f"last loss {losses[-1]:.4f}")
    return {"losses": losses, "grad_norms": norms, "step_s": seconds,
            "start": start, "model": model,
            "opt_state": opt_state, "opt_cfg": opt, "pipeline": pipe}


def main(argv=None):
    """Returns the losses of the steps run."""
    return run(parse_args(argv))["losses"]


if __name__ == "__main__":
    main()
