"""Training driver: real training at container scale, production-mesh
training over a launched process group (the port of
``repro/launch/train.py``, the same flags, plus ``--device``).

Examples:
    # ~20M-param llama-style model, 200 steps, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
        --steps 200 --batch 8 --seq 256

    # fault-tolerance demo: inject failures, auto-restart from checkpoint
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --smoke \\
        --steps 60 --fail-at 25 --checkpoint-every 10

    # on the CPU
    ... --device cpu

    # the production mesh: one rank per card, 256 (pod1) or 512 (pod2)
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch llama3.2-3b --mesh pod1 --device-order sharedmap

``--mesh pod1``/``pod2`` builds ``make_production_mesh`` over the launched
process group (``torchrun``'s environment; NCCL on the card, gloo on the
CPU), with ``--device-order sharedmap`` ordering its ranks, and trains as
eager SPMD: params and moments placed by ``launch/shardings.py``, the batch
over the batch axes, the ctx passed to ``make_train_step``. Under another
world size, or with no process group, it raises with the size needed.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..configs.registry import ARCHS, get_config, get_smoke_config
from ..core.graph import resolve_device
from ..data.pipeline import DataConfig, make_batch
from ..train.checkpoint import Checkpointer
from ..train.fault_tolerance import FailureInjector, StepWatchdog, run_with_restarts
from ..train.optimizer import AdamWConfig
from ..models.sharding import ShardCtx
from ..train.train_step import init_train_state, make_train_step
from . import shardings as SH


def _join_group(dev) -> None:
    """Join the process group ``torchrun`` launched this rank into (its
    environment names it); without one, nothing (the mesh then raises)."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")


def build(args, dev=None):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    ctx = None
    if args.mesh != "none":
        from .mesh import make_production_mesh
        dev = dev if dev is not None else resolve_device(args.device)
        _join_group(dev)
        mesh = make_production_mesh(multi_pod=(args.mesh == "pod2"),
                                    device_order=args.device_order,
                                    device_type=dev.type)
        ctx = ShardCtx(mesh=mesh,
                       batch_axes=("pod", "data") if args.mesh == "pod2" else ("data",))
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5))
    return cfg, ctx, opt_cfg


def main(argv=None) -> dict:
    """Runs the driver; returns ``{"restarts", "first_loss", "final_loss"}``
    (the first loss of the last run, as the ``[done]`` line prints it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "pod1", "pod2"], default="none")
    ap.add_argument("--device-order", choices=["default", "sharedmap"], default="default")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--checkpoint-dir", default="ckpts/run")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--restore-dir", default="")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="simulate node failures at these steps")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, ctx, opt_cfg = build(args, dev)
    dc = DataConfig(seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    ckpt = Checkpointer(args.restore_dir or args.checkpoint_dir)
    injector = FailureInjector(fail_at_steps=tuple(args.fail_at))
    watchdog = StepWatchdog()
    train_step = make_train_step(cfg, opt_cfg, ctx)
    summary = {"restarts": 0}

    def run(start_step: int) -> int:
        state = init_train_state(cfg, args.seed, dev, V=ctx.model_size if ctx else 1)
        if ctx is not None:   # a restore below keeps these placements
            state = SH.shard_state(state, ctx.mesh)
        step0 = 0
        ckpt.wait()   # a save still in flight from before the failure lands first
        latest = ckpt.latest_step()
        if start_step == -1 or (args.restore_dir and latest is not None):
            if latest is not None:
                restored = ckpt.restore(latest, {"params": state.params, "opt": state.opt})
                state = state._replace(params=restored["params"], opt=restored["opt"])
                step0 = latest
                print(f"[restore] resumed from step {latest}", flush=True)

        losses = []
        for step in range(step0, args.steps):
            injector.check(step)
            batch = make_batch(cfg, dc, step, dev)
            if ctx is not None:
                batch = SH.place_tree(batch, SH.batch_specs(cfg, batch, ctx), ctx.mesh)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if watchdog.observe(step, dt):
                print(f"[straggler] step {step} took {dt:.2f}s", flush=True)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                toks = args.batch * args.seq / dt
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:7.1f} ms/step {toks:9.0f} tok/s", flush=True)
            if step > 0 and step % args.checkpoint_every == 0:
                ckpt.save(step, {"params": state.params, "opt": state.opt},
                          meta={"arch": cfg.name})
        ckpt.save(args.steps, {"params": state.params, "opt": state.opt},
                  meta={"arch": cfg.name}, blocking=True)
        print(f"[done] final loss {losses[-1]:.4f} (start {losses[0]:.4f})", flush=True)
        summary.update(first_loss=losses[0], final_loss=losses[-1])
        return args.steps

    def on_restart(n, e):
        summary["restarts"] = n
        print(f"[restart #{n}] {e}", flush=True)

    run_with_restarts(run, max_restarts=5, on_restart=on_restart)
    return summary


if __name__ == "__main__":
    main()
