"""Training driver: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of the JAX package's ``launch/train.py`` on one device (the
card unless ``--device cpu``): builds the train state, restores the
newest checkpoint if there is one, installs the preemption handler, and
train-loops with periodic atomic checkpoints and straggler heartbeats.
Every config of ``configs.ARCHS`` trains: the synthetic batch carries
whisper's ``frames`` and qwen2-vl's ``embeds`` as the reference's does.
``--mesh`` other than one device is ROADMAP A11b (the training half of
the multi-GPU slice: sharding rules over a mesh) and raises. At a published width the state must fit
the card (params, grads, m and v: 16 bytes a parameter in float32);
``chip_smoke.py`` cuts the depth of those that do not.

    python -m repro_torch.launch.train --arch gemma2-9b --reduced \\
        --device cpu --steps 3 --ckpt-dir ckpt               # on the host
    python -m repro_torch.launch.train --arch rwkv6-3b        # on the card
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import configs, resolve_device
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
                   help="'auto' or '1x1': the one device")
    p.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def adamw_config(args: argparse.Namespace) -> opt.AdamWConfig:
    """The reference driver's optimizer: ``--lr``, a warmup of 10 steps,
    cosine decay over ``max(--steps, 100)``."""
    return opt.AdamWConfig(lr=args.lr, warmup_steps=10,
                           decay_steps=max(args.steps, 100))


def setup(args: argparse.Namespace):
    """``(cfg, state, step_fn, start_step)``: the train state on the
    device (restored from ``--ckpt-dir``'s newest checkpoint when there
    is one, with a ``# resumed`` line) and the train step."""
    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    if args.mesh not in ("auto", "1x1"):
        d, m = (int(x) for x in args.mesh.split("x"))
        raise NotImplementedError(
            f"--mesh {d}x{m}: the port trains on one device; sharding "
            "over a mesh is ROADMAP A11b")
    dev = resolve_device(args.device)
    ocfg = adamw_config(args)
    state = train_loop.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0),
        dtype=DTYPES[args.dtype], opt_cfg=ocfg, device=dev)
    start_step = 0
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir) is not None:
        state, manifest = checkpoint.restore(args.ckpt_dir, state)
        run = fault_tolerance.RunState.from_dict(manifest.get("extra", {}))
        start_step = run.step + 1
        print(f"# resumed from step {run.step} "
              f"(data_position {run.data_position})")
    step_fn = train_loop.make_train_step(cfg, opt_cfg=ocfg,
                                         accum_steps=args.accum)
    return cfg, state, step_fn, start_step


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Train ``--steps`` steps, printing every tenth and the last."""
    args = parse_args(argv)
    cfg, state, step_fn, start_step = setup(args)
    dev = torch.device(args.device)
    handler = fault_tolerance.PreemptionHandler().install()
    monitor = fault_tolerance.StragglerMonitor()

    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = synthetic_batch(cfg, args.batch, args.seq, step,
                                device=dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])         # waits for the device
        dt = time.perf_counter() - t0
        monitor.beat("host0", dt)
        if step % 10 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq / dt
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:.0f} ms ({tok_s:.0f} tok/s)", flush=True)
        want_ckpt = args.ckpt_dir and (
            step % args.ckpt_every == 0 or handler.preempted()
            or step == args.steps - 1)
        if want_ckpt:
            run = fault_tolerance.RunState(
                step=step, data_position=(step + 1) * args.batch)
            checkpoint.save(args.ckpt_dir, step, state,
                            extra=run.to_dict())
        if handler.preempted():
            print(f"# preempted at step {step}; checkpointed and exiting")
            return
    print("# done")


if __name__ == "__main__":
    main()
