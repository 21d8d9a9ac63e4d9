"""Time redesigned kernels against an older source, in turns, on the card.

``python -m repro_torch.launch.kernel_ab --old DIR [--points 872000]``

``DIR`` holds older sources of some of ``mbr_intersect.cu``,
``forest_infer_cells.cu``, ``traverse_fused_sliced.cu`` and
``spatial_key.cu`` (``git show <commit>:src/repro_torch/kernels/csrc/
<name>.cu`` into a directory that ``.gitignore`` lists); the A/B of each
source present runs, the others are skipped. Each is built there with
``kernels.cuda``'s ``nvcc`` flags and called through ``ctypes``: the
older ``mbr_intersect`` with its launcher of before the parent gather was
folded in, ``(queries, B, mbrs, N, out, stream)``; the older
``spatial_key`` with its launcher on normalized centres, ``(cxy, B,
hilbert, order, keys, stream)``; the older ``traverse_fused_sliced`` and
``forest_infer_cells`` with the launchers they still share with the new.

Each measurement runs in turns, old, new, new, old, on the same inputs,
after both outputs are held bit-equal (and equal to the plain version):

* ``mbr_intersect`` (the plain form) on the first 512 range queries of
  the deployment (``launch.serve``'s Guttman tree over ``crimes_like``
  at ``--points``, capacity 128) against every level of its tree, and on
  ``chip_smoke.py``'s 512 routing queries against every level of
  ``synth_levels(1.5M, 89)``;
* that tree's per-level walk, the old launches with the parent's gather
  and ``&`` between them against ``ops._per_level_walk``;
* ``forest_infer_cells`` on the deployment's forest bank
  (``fit_airtree(kind="forest")``, as the smoke fits it) on the first
  batch of 512 queries and on all eight in one call;
* ``traverse_fused_sliced`` on the deployment's first 512 range queries
  with its tree's own table (``DeviceTree.aslices``), and on the routing
  queries over ``synth_levels(1.5M, 89)`` with its built table;
* ``spatial_key`` on the deployment's 4096 range rects in the
  workload's frame (Hilbert): the older path (``ops.spatial_key_inputs``
  then the older kernel on the centres) against ``ops.spatial_key`` (one
  launch), and each kernel alone.

Times: the device time of a call (CUPTI over 30 calls after two: the
mean activity times the activities a call), the activities a call, the
median time of one call between two CUDA events and the time a call of
30 back to back between two events. Prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import math
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import cuda as kcuda, ops, ref

REPS = 30
AB_KERNELS = ("mbr_intersect", "forest_infer_cells", "traverse_fused_sliced",
              "spatial_key")


def _device(fn) -> tuple[float, int]:
    """(device ms a call; activities a call), from CUPTI over ``REPS``
    calls after two: the mean recorded activity times the activities a
    call (CUPTI can drop a few records of a run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    acts = math.ceil(len(ev) / REPS)
    return sum(e.time_range.elapsed_us() for e in ev) / len(ev) / 1e3 * \
        acts, acts


def _between_events(fn) -> tuple[float, float]:
    """(median ms of one call between two events; ms a call over ``REPS``
    calls back to back between two events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(REPS):
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    b.synchronize()
    return statistics.median(times), a.elapsed_time(b) / REPS


def in_turns(label: str, old, new) -> dict:
    """Old, new, new, old; prints and returns each side's readings."""
    got = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        fn = old if side == "old" else new
        got[side].append((*_device(fn), *_between_events(fn)))
    line = "; ".join(
        f"{side} " + ", ".join(f"{ms:.4f} ms ({acts} activities; between "
                               f"events {one:.4f} alone, {run:.4f} in a run)"
                               for ms, acts, one, run in got[side])
        for side in ("old", "new"))
    old_ms = sum(r[0] for r in got["old"]) / 2
    new_ms = sum(r[0] for r in got["new"]) / 2
    print(f"{label}: {line}; {old_ms / new_ms:.2f}x")
    return got


@functools.cache
def _old_launcher(old_dir: Path, name: str, argtypes: tuple):
    src = old_dir / f"{name}.cu"
    lib = old_dir / f"lib{name}_old.so"
    subprocess.run([kcuda._nvcc(), *kcuda.NVCC_FLAGS, f"-I{old_dir}",
                    "-o", str(lib), str(src)], check=True,
                   capture_output=True)
    fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"the old {name} failed to launch: {err}")


def _same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not torch.equal(a, b):
        raise RuntimeError(f"{what} differ: nothing is timed")


def mbr_part(old_dir: Path, q: torch.Tensor, level_mbrs: list, label: str
             ) -> None:
    """The plain form, old against new, at every level."""
    P, I = ctypes.c_void_p, ctypes.c_int
    old_fn = _old_launcher(old_dir, "mbr_intersect", (P, I, P, I, P, P))
    for m in level_mbrs:
        B, N = q.shape[0], m.shape[0]
        out_old = torch.empty((B, N), dtype=torch.bool, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream

        def old(m=m, out=out_old, N=N):
            _check(old_fn(q.data_ptr(), B, m.data_ptr(), N, out.data_ptr(),
                          stream), "mbr_intersect")
        launch, out_new = ops.prepare("mbr_intersect", q, m)
        old()
        launch()
        _same(out_old, out_new, f"old and new mbr_intersect at {N} MBRs")
        _same(out_new, ref.mbr_intersect(q, m),
              f"mbr_intersect and its plain version at {N} MBRs")
        in_turns(f"mbr_intersect {B} x {N} ({label})", old, launch)


def per_level_part(old_dir: Path, q, mb, pa) -> None:
    """The per-level walk: the old launches with the gather and ``&``
    between them, as the parent's ``ops._per_level_walk`` ran them,
    against the folded launches."""
    P, I = ctypes.c_void_p, ctypes.c_int
    old_fn = _old_launcher(old_dir, "mbr_intersect", (P, I, P, I, P, P))
    B = q.shape[0]

    def old_mbr(m):
        out = torch.empty((B, m.shape[0]), dtype=torch.bool, device=q.device)
        _check(old_fn(q.data_ptr(), B, m.data_ptr(), m.shape[0],
                      out.data_ptr(), torch.cuda.current_stream().cuda_stream),
               "mbr_intersect")
        return out

    def old():
        mask = old_mbr(mb[0])
        for m, p in zip(mb[1:], pa[1:]):
            mask = mask[:, p.long()] & old_mbr(m)
        return mask

    def new():
        return ops._per_level_walk(q, mb, pa)
    _same(old(), new(), "the old and new per-level walks")
    _same(new(), ref.traverse_fused(q, mb, pa),
          "the per-level walk and the plain walk")
    in_turns(f"per-level walk, levels {[m.shape[0] for m in mb]}", old, new)


def forest_part(old_dir: Path, bank, queries: np.ndarray, dev) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    old_fn = _old_launcher(old_dir, "forest_infer_cells",
                           (P, I, I, P, P, P, I, I, I, I, P, P))
    C, T, D = bank.feat_idx.shape
    Cl = bank.tables.shape[-1]
    fi = bank.feat_idx.reshape(C * T, D).contiguous()
    th = bank.thresh.reshape(C * T, D).contiguous()
    tb = bank.tables.reshape(C * T, 2 ** D, Cl).contiguous()
    q_all = torch.from_numpy(queries).to(dev)
    batches = [q_all[o:o + 512].contiguous()
               for o in range(0, q_all.shape[0], 512)]
    olds, news = [], []
    for q in batches:
        B, F = q.shape
        out = torch.empty((B, C, Cl), dtype=torch.float32, device=dev)

        def old(q=q, out=out, B=B, F=F):
            _check(old_fn(q.data_ptr(), B, F, fi.data_ptr(), th.data_ptr(),
                          tb.data_ptr(), C, T, D, Cl, out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream),
                   "forest_infer_cells")
        launch, got = ops.prepare("forest_infer_cells", q, fi, th, tb, C)
        old()
        launch()
        _same(out, got, "old and new forest_infer_cells")
        olds.append(old)
        news.append(launch)
    _same(got, ref.forest_infer_cells(batches[-1], fi, th, tb, C),
          "forest_infer_cells and its plain version")
    label = f"{C} cells x {T} tree, depth {D}, {Cl} labels"
    in_turns(f"forest_infer_cells, batch 512 ({label})", olds[0], news[0])
    in_turns(f"forest_infer_cells, {len(batches)} batches of 512 in one "
             f"call ({label})", lambda: [f() for f in olds],
             lambda: [f() for f in news])


def sliced_part(old_dir: Path, q, mb, pa, sl, label: str) -> None:
    """The windowed dense walk, old against new, on the same launcher
    arguments (the ABI is unchanged), held against the plain version."""
    P, I, PI = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    old_fn = _old_launcher(old_dir, "traverse_fused_sliced",
                           (P, I, P, P, PI, I, P, PI, I, I, P, P, I, P, P))
    launch, out_new = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    out_old = torch.empty_like(out_new)
    args = [*launch.tensors[:-1], out_old]
    cargs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]

    def old():
        _check(old_fn(*cargs, torch.cuda.current_stream().cuda_stream),
               "traverse_fused_sliced")
    old()
    launch()
    B, L = out_new.shape
    _same(out_old, out_new, f"old and new traverse_fused_sliced ({label})")
    _same(out_new, ref.traverse_fused_sliced(q, mb, pa, sl.starts,
                                             sl.widths, sl.tl),
          f"traverse_fused_sliced and its plain version ({label})")
    in_turns(f"traverse_fused_sliced {B} x {L}, windows {list(sl.widths)}, "
             f"{sl.n_tiles} tiles of {sl.tl} ({label})", old, launch)


def keys_part(old_dir: Path, q: torch.Tensor, bbox: torch.Tensor) -> None:
    """The curve keys: the older path (centres normalized in PyTorch, then
    the older kernel) against the one-launch call, then each kernel
    alone; both curves held bit-equal first."""
    P, I = ctypes.c_void_p, ctypes.c_int
    old_fn = _old_launcher(old_dir, "spatial_key", (P, I, I, I, P, P))
    B = q.shape[0]

    def old_kernel(cxy, keys, hilbert=1):
        _check(old_fn(cxy.data_ptr(), B, hilbert, 15, keys.data_ptr(),
                      torch.cuda.current_stream().cuda_stream),
               "spatial_key")

    def old_path(curve="hilbert"):
        cxy = ops.spatial_key_inputs(q, bbox)
        keys = torch.empty((B,), dtype=torch.int32, device=q.device)
        old_kernel(cxy, keys, ops.CURVES[curve])
        return keys

    def new_path(curve="hilbert"):
        return ops.spatial_key(q, bbox, curve)
    for curve in ops.CURVES:
        want = ref.spatial_key(ops.spatial_key_inputs(q, bbox), curve=curve)
        _same(old_path(curve), new_path(curve),
              f"old and new spatial_key ({curve})")
        _same(new_path(curve), want,
              f"spatial_key and its plain version ({curve})")
    in_turns(f"spatial_key path, {B} rects, workload frame (old: "
             f"spatial_key_inputs + kernel; new: one launch)", old_path,
             new_path)
    cxy = ops.spatial_key_inputs(q, bbox)
    keys = torch.empty((B,), dtype=torch.int32, device=q.device)
    launch, _ = ops.prepare("spatial_key", q, bbox, "hilbert")
    in_turns(f"spatial_key kernel alone, {B} rects (old: on normalized "
             f"centres)", lambda: old_kernel(cxy, keys), launch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with older sources of some of "
                         + ", ".join(f"{n}.cu" for n in AB_KERNELS))
    ap.add_argument("--points", type=int, default=872_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab times CUDA kernels: no CUDA device")
    names = [n for n in AB_KERNELS if (args.old / f"{n}.cu").exists()]
    if not names:
        raise SystemExit(f"no older source of {', '.join(AB_KERNELS)} in "
                         f"{args.old}")
    from repro_torch.core import build, labels, schedule
    from repro_torch.data import synth
    from repro_torch.data.synth_tree import synth_levels
    from repro_torch.launch import serve
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"A/B of {names} against {args.old}")
    dev = torch.device("cuda")
    kcuda.build_all([kcuda.KERNELS[n] for n in names])
    for name in names:
        log = kcuda.KERNELS[name].log_path().read_text()
        print(name, [ln.split("ptxas info    : ")[-1]
                     for ln in log.splitlines() if "registers" in ln])

    # the routing tree, table and queries of chip_smoke.routing_phase
    if {"mbr_intersect", "traverse_fused_sliced"} & set(names):
        rng = np.random.default_rng(0)
        mbrs, parents = synth_levels(1_500_000, 89, rng, str_pack=True)
        mb = [torch.from_numpy(m).to(dev) for m in mbrs]
        pa = [torch.from_numpy(p).to(dev) for p in parents]
        c = rng.uniform(-1, 1, (512, 2)).astype(np.float32)
        wd = rng.uniform(0, 0.004, (512, 2)).astype(np.float32)
        q = torch.from_numpy(np.concatenate([c - wd, c + wd], 1)).to(dev)
        if "mbr_intersect" in names:
            mbr_part(args.old, q, mb, "routing tree")
            per_level_part(args.old, q, mb, pa)
        if "traverse_fused_sliced" in names:
            from repro_torch.core import device_tree as dt
            q[0] = torch.tensor([5.0, 5.0, 6.0, 6.0], device=dev)  # empty
            sliced_part(args.old, q, mb, pa,
                        dt.build_ancestor_table(pa, device=dev),
                        "routing tree, built table")
        del mb, pa

    sargs = serve.parse_args([
        "--dataset", "crimes", "--points", str(args.points), "--queries",
        "4096", "--selectivity", "5e-5", "--node-capacity", "128",
        "--device", "cuda"])
    pts, dtree = serve.build_tree(sargs)
    qs = synth.synth_queries(pts, sargs.selectivity, sargs.queries,
                             device="cuda")
    wl = labels.make_workload(dtree, qs)
    q512 = torch.from_numpy(wl.queries[:512].copy()).to(dev)
    if "mbr_intersect" in names:
        mbr_part(args.old, q512, [lv.mbrs for lv in dtree.levels],
                 "deployment tree")
    if "traverse_fused_sliced" in names:
        sliced_part(args.old, q512, [lv.mbrs for lv in dtree.levels],
                    [lv.parent for lv in dtree.levels], dtree.aslices,
                    "deployment tree, its table")
    if "spatial_key" in names:
        keys_part(args.old, torch.from_numpy(wl.queries).to(dev),
                  torch.from_numpy(schedule.workload_bbox(
                      wl.queries)).to(dev))
    if "forest_infer_cells" in names:
        hyb, _ = build.fit_airtree(dtree, wl, kind="forest")
        forest_part(args.old, hyb.ait.bank, wl.queries, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
