"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of the JAX package's ``launch/train.py`` (on the card unless
``--device cpu``): builds the mesh, builds the train state sharded by
``launch/sharding.py``'s rules, restores the newest checkpoint if there
is one (whatever mesh wrote it), installs the preemption handler, and
train-loops with periodic atomic checkpoints and straggler heartbeats.
Every config of ``configs.ARCHS`` trains: the synthetic batch carries
whisper's ``frames`` and qwen2-vl's ``embeds`` as the reference's does.

Run alone it trains on one device. Under ``torch.distributed.run``
(``WORLD_SIZE`` > 1) every rank joins the world (``mesh.init_from_env``)
and ``--mesh`` lays it out: ``auto`` is every rank a data index, ``DxM``
must hold the world's ranks (``ValueError``). Every rank draws the
global synthetic batch and trains on its rows (``train_loop``'s mesh
step); rank 0 prints. At a published width the state must fit the card
(params, grads, m and v: 16 bytes a parameter in float32; over a mesh
each rank holds the whole params and grads in a step and its blocks of
the rest); ``chip_smoke.py`` cuts the depth of those that do not.

    python -m repro_torch.launch.train --arch gemma2-9b --reduced \\
        --device cpu --steps 3 --ckpt-dir ckpt               # on the host
    python -m repro_torch.launch.train --arch rwkv6-3b        # on the card
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch rwkv6-3b --reduced \\
        --device cpu --steps 3 --mesh 2x1                    # two ranks
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding
from repro_torch.training import checkpoint, fault_tolerance
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def synthetic_batch(cfg, B: int, S: int, step: int, seed: int = 0,
                    device: str | torch.device = "cpu") -> dict:
    """The reference's synthetic batch, drawn with numpy from ``seed +
    step`` in its order: tokens and labels uniform in [1, vocab); the
    encdec family's ``frames [B, enc_seq, d_model]`` and the vision
    frontend's ``embeds [B, S, d_model]`` standard normal in bfloat16,
    the latter in place of ``tokens``."""
    rng = np.random.default_rng(seed + step)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab, (B, S)))
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model))).to(torch.bfloat16)
    if cfg.frontend == "vision":
        batch["embeds"] = torch.from_numpy(rng.normal(
            size=(B, S, cfg.d_model))).to(torch.bfloat16)
        batch.pop("tokens")
    return {k: v.to(device) for k, v in batch.items()}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--reduced", action="store_true",
                   help="shrink the config for CPU runs")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--mesh", default="auto",
                   help="'auto' (every rank a data index) or 'DxM' (data x "
                        "model; D·M ranks of torch.distributed.run)")
    p.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def adamw_config(args: argparse.Namespace) -> opt.AdamWConfig:
    """The reference driver's optimizer: ``--lr``, a warmup of 10 steps,
    cosine decay over ``max(--steps, 100)``."""
    return opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                           decay_steps=max(args.steps, 100))


def setup(args: argparse.Namespace, mesh=None):
    """``(cfg, state, step_fn, start_step)``: the train state on the
    device (this rank's shards over ``mesh``; restored from
    ``--ckpt-dir``'s newest checkpoint when there is one, with a
    ``# resumed`` line) and the train step."""
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    n_data = mesh.n_data if mesh is not None else 1
    if args.batch % (args.accum * n_data):
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"--accum {args.accum} microbatches over {n_data} "
                         "data ranks")
    ocfg = adamw_config(args)
    specs = sharding.state_shardings(cfg, mesh) if mesh is not None \
        else None
    state = train_loop.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0),
        dtype=DTYPES[args.dtype], opt_cfg=ocfg, device=dev, mesh=mesh,
        specs=specs)
    start_step = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, manifest = checkpoint.restore(args.ckpt_dir, state,
                                             mesh=mesh, specs=specs)
        run = fault_tolerance.RunState.from_dict(manifest.get("extra", {}))
        start_step = run.step + 1
        if mesh is None or mesh.rank == 0:
            print(f"# resumed from step {run.step} "
                  f"(data_position {run.data_position})")
    step_fn = train_loop.make_train_step(cfg, opt_cfg=ocfg,
                                         accum_steps=args.accum, mesh=mesh,
                                         specs=specs)
    return cfg, state, step_fn, start_step


def join(args: argparse.Namespace):
    """The mesh of the world ``torch.distributed.run`` started (``--mesh``
    laid over it), or None for one process. ``--mesh`` must hold the
    world's ranks either way."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    shape = meshlib.train_mesh_shape(world, args.mesh)
    if world == 1:
        return None
    w = meshlib.init_from_env(args.device)
    mesh = meshlib.make_debug_mesh(*shape, device=w.device)
    if w.rank == 0:
        print(f"# mesh {shape[0]}x{shape[1]} on {w.device} (data x model, "
              f"{w.size} ranks over {w.backend})", flush=True)
    return mesh


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Train ``--steps`` steps, printing every tenth and the last."""
    args = parse_args(argv)
    mesh = join(args)
    try:
        train(args, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def train(args: argparse.Namespace, mesh=None) -> None:
    """The loop of ``main`` on this rank of ``mesh`` (None: one
    device)."""
    cfg, state, step_fn, start_step = setup(args, mesh)
    dev = mesh.device if mesh is not None else torch.device(args.device)
    rank = mesh.rank if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    specs = sharding.state_shardings(cfg, mesh) if mesh is not None \
        else None
    handler = fault_tolerance.PreemptionHandler().install()
    monitor = fault_tolerance.StragglerMonitor()

    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = synthetic_batch(cfg, args.batch, args.seq, step,
                                device=dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])         # waits for the device
        dt = time.perf_counter() - t0
        monitor.beat(f"host{rank}", dt)
        if step % 10 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / dt
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"{dt*1e3:.0f} ms ({tok_s:.0f} tok/s)", flush=True)
        preempted = handler.agreed(mesh) if mesh is not None \
            else handler.preempted()
        want_ckpt = args.ckpt_dir and (
            step % args.ckpt_every == 0 or preempted
            or step == args.steps - 1)
        if want_ckpt:
            run = fault_tolerance.RunState(
                step=step, data_position=(step + 1) * args.batch)
            checkpoint.save(args.ckpt_dir, step, state,
                            extra=run.to_dict(), mesh=mesh, specs=specs)
        if preempted:
            say(f"# preempted at step {step}; checkpointed and exiting")
            return
    say("# done")


if __name__ == "__main__":
    main()
