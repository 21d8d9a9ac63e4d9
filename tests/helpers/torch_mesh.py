"""Ranks of the port's engine over a ``torch.distributed`` mesh, for the
tests.

``Ranks(job, world, workdir)`` writes ``job`` (a dict: the port's
hybrids and query batches, the mesh shape, which cases to run) under
``workdir`` and starts ``world`` ranks of this file as subprocesses;
``.wait()`` joins them (``spawn`` does both). Each rank sets
one intra-op thread, joins a ``gloo`` group through a ``file://``
rendezvous under ``workdir`` (60 s timeout), builds the
``launch.mesh.make_debug_mesh`` of ``job["mesh"]``, runs the cases and
saves its results to ``workdir/rank{r}.pt``; ``wait`` returns them, one
dict a rank. A rank that fails or outlives the time limit fails the
wait, and every rank's process group is killed. Nothing here touches
the calling process's environment or ``torch.distributed`` state.

This module imports only numpy and torch (the card's machine has no
JAX); ``python tests/helpers/torch_mesh.py <job.pt> <rank>`` is a rank.

The cases (each optional in ``job``):

* ``serve``: ``[(kind, union, delta)]`` — one batch ``job["q"]`` through
  ``make_serve_step(EngineConfig(max_visited=job["max_visited"],
  score_union=union))`` on ``job["hybrids"][kind]``, with the buffer
  ``job["xy"]`` when ``delta``;
* ``point``: ``[kind]`` — ``job["q_point"]`` through
  ``make_point_serve_step``;
* ``two_tier``: ``[kind]`` — ``job["stream"]`` through
  ``make_two_tier_steps(EngineConfig(max_visited=1), wide_factor=64)``
  and ``schedule.serve_workload`` (batch 32, Hilbert);
* ``fresh``: a dict of ``EngineFreshServer`` arguments — a mixed stream
  (``schedule.serve_mixed_workload``), with a digest of the rank's whole
  hybrid after each maintenance step.

The hybrids go to ``job["device"]`` (``cpu`` by default, ``cuda`` for the
card's test: both ranks on ``cuda:0``); ``"launches"`` holds the kernel
launches of the serve, point and two-tier cases.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def _tensors(obj):
    """Every tensor of a (nested) dataclass, in field order."""
    import dataclasses
    if torch.is_tensor(obj):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def digest(obj) -> str:
    """SHA-1 of every tensor's dtype, shape and bytes inside ``obj``."""
    h = hashlib.sha1()
    for t in _tensors(obj):
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel()
                 else b"")
    return h.hexdigest()


def _host(stats):
    """A stats NamedTuple of tensors → the same NamedTuple of numpy."""
    return type(stats)(*(t.cpu().numpy() for t in stats))


def _cases(job: dict, mesh) -> dict:
    from repro_torch.core import engine, monitor, schedule
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch.mesh import to_device
    dev = mesh.device
    hyb = {k: mesh.shard(to_device(h, dev))
           for k, h in job["hybrids"].items()}
    out = {}
    kcuda.reset_launch_counts()

    def batch(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    for kind, union, delta in job.get("serve", ()):
        cfg = engine.EngineConfig(max_visited=job["max_visited"],
                                  score_union=union)
        step = mesh.step(engine.make_serve_step(cfg, kind=kind,
                                                axis=mesh.model))
        xy = (batch(job["xy"]),) if delta else ()
        out[("serve", kind, union, delta)] = _host(
            step(hyb[kind], batch(job["q"]), *xy))
    for kind in job.get("point", ()):
        step = mesh.step(engine.make_point_serve_step(
            engine.EngineConfig(), kind=kind, axis=mesh.model))
        out[("point", kind)] = _host(step(hyb[kind], batch(job["q_point"])))
    for kind in job.get("two_tier", ()):
        narrow, wide = (mesh.step(s) for s in engine.make_two_tier_steps(
            engine.EngineConfig(max_visited=1), kind=kind, wide_factor=64,
            axis=mesh.model))
        kw = dict(batch=32, sort="hilbert", device=dev)
        first = schedule.serve_workload(
            lambda q: narrow(hyb[kind], q), job["stream"], **kw)
        rep = schedule.serve_workload(
            lambda q: narrow(hyb[kind], q), job["stream"],
            wide_fn=lambda q: wide(hyb[kind], q), trunc_field="r_truncated",
            **kw)
        out[("two_tier", kind)] = (first, rep)
    out["launches"] = kcuda.launch_counts()
    fresh = job.get("fresh")
    if fresh is not None:
        srv = monitor.EngineFreshServer(
            fresh["base"], to_device(fresh["hybrid"], dev),
            engine.EngineConfig(**fresh["cfg"]), kind=fresh["kind"],
            mesh=mesh, fit_state=fresh["fit_state"],
            policy=monitor.DefaultPolicy(**fresh["policy"]), **fresh["kw"])
        digests = []
        on_segment = srv.on_segment

        def noted():
            d = on_segment()
            digests.append((digest(srv.hybrid), digest(srv._h_p)))
            return d
        srv.on_segment = noted
        mixed = schedule.serve_mixed_workload(
            srv, fresh["queries"], fresh["inserts"], **fresh["run"])
        out["fresh"] = dict(mixed=mixed, refits=srv.refits,
                            stats=srv.stats(), digests=digests)
    return out


def rank_main(job_path: str, rank: int) -> None:
    """One rank: join the group, run the job's cases, save the results."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshlib
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=job["init"], rank=rank,
                            world_size=job["world"],
                            timeout=timedelta(seconds=60))
    try:
        mesh = meshlib.make_debug_mesh(*job["mesh"],
                                       device=job.get("device", "cpu"))
        out = _cases(job, mesh)
        torch.save(out, Path(job["out"]) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world`` ranks of ``job`` running (module docstring): ``wait``
    returns each rank's results."""

    def __init__(self, job: dict, world: int, workdir: Path,
                 timeout_s: float = 240.0):
        self.workdir = workdir = Path(workdir)
        job_path = workdir / "job.pt"
        torch.save(dict(job, world=world, out=str(workdir),
                        init=f"file://{workdir / 'rendezvous'}"), job_path)
        path = [str(ROOT / "src")] + [
            p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(path))
        self.logs = [workdir / f"rank{r}.log" for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__, str(job_path), str(r)],
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))
        self.deadline = time.monotonic() + timeout_s
        self.timeout_s = timeout_s

    def wait(self) -> list:
        """Each rank's results. Raises ``AssertionError`` with the ranks'
        logs if one fails or the time limit passes (every rank is then
        killed)."""
        procs, failed = self.procs, None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                if time.monotonic() > self.deadline:
                    failed = f"ranks still running after {self.timeout_s} s"
                elif any(p.returncode for p in procs
                         if p.poll() is not None):
                    failed = "a rank failed"
                else:
                    time.sleep(0.05)
            if failed is None and any(p.returncode for p in procs):
                failed = "a rank failed"
        finally:
            self.stop()
        if failed is not None:
            raise AssertionError(failed + "".join(
                f"\n--- rank {r} (rc {p.returncode}):\n"
                + self.logs[r].read_text()[-3000:]
                for r, p in enumerate(procs)))
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(len(procs))]

    def stop(self) -> None:
        """Kill every rank still running (its whole process group)."""
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()


def spawn(job: dict, world: int, workdir: Path,
          timeout_s: float = 240.0) -> list:
    """Run ``job`` on ``world`` ranks and wait for them (``Ranks``)."""
    return Ranks(job, world, workdir, timeout_s).wait()


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]))
