#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py                  # the deployment below
    python3 chip_smoke.py --points 100000  # a cut (printed as such)
    python3 chip_smoke.py --large-points 4000000   # a cut of phase 9

Phases, each failing the run (non-zero exit) on its own error:

1. print the card's name and power limit (``nvidia-smi``);
2. build the twelve CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. build the serving index through ``repro_torch.launch.serve`` at the
   Chicago Crimes scale of the paper (872K points, node capacity 128,
   4096 queries at selectivity 5e-5, MLP bank);
4. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving paths give it plus edge rows, and time both (the
   ancestor-sliced walks with the deployed tree's own table, also against
   the full-walk kernels; mbr_intersect on every level);
5. stream the range workload through ``hybrid_query`` in Hilbert order
   (batch 512, narrow ``max_visited`` 64, wide tier x8) with every launch
   count reset just before and read just after; check the ``# oracle``
   against the workload labels and 512 sampled queries against f32
   brute-force containment; serve the same stream in arrival order as a
   comparison (reported, not gated) and profile both;
6. on the same index, serve a kNN, a spatial-join and a point stream
   (4096 queries each, one timed repetition), each with its launch
   counts reset and read around it and its oracle at 0 mismatches;
7. serve the mixed read/write stream (``--insert-rate``'s path): the
   range workload in Hilbert order, batch 512, one batch per segment,
   with 8,192 new records of the same synthetic city
   (``crimes_like(8192, seed=1)``, shuffled) staged between segments
   into a ``FreshServer`` (delta capacity 8,192, delta slots 64 narrow
   and 512 wide) under ``DefaultPolicy(refit_chunk=4, repack_at=0.75)``
   with the build's ``FitState``; gates: probe launches equal to the
   batches served, every insert staged, at least one repack, one refit
   chunk and one delta hit, 0 ``n_results`` mismatches against
   brute-force containment of each segment's visible points and 0
   id-set mismatches on 512 sampled rows; then the wall split (serving,
   repack, refit) and a profile of one ``FreshServer.serve`` pass over
   the 4096 queries at a delta fill of 6,144;
8. the forest bank (``--classifier forest``) at the deployment:
   ``fit_airtree(kind="forest")`` on the same tree and labelled workload,
   the range stream in Hilbert order through it (gates: 0 mismatches
   against the labels and against brute force on 512 sampled queries,
   ``mlp_predict_compact`` never launched); then the bank's dense form
   (``forest.cell_probs_dense``, the path of forest_infer_cells) over the
   4096 queries in batches of 512, launch counts reset and read around
   it, each batch bit-equal to the gathered form over every cell; and
   forest_infer_cells against its plain version, bit-equal, on one such
   batch and on a synthetic bank (4 trees of depth 8 a cell, 37 labels,
   empty cells);
9. the open loop (``--arrival poisson``): the MLP range stream under
   Poisson arrivals at 1.5x the capacity measured on the card, with the
   driver's automatic deadline (both from one measurement, so the two
   runs see the same arrivals), for ``--formation deadline`` and
   ``full``; gates:
   0 mismatches on the rows not degraded, the main path's kernels
   launched; p50/p95/p99 latency, goodput and degraded rows printed;
10. drive every rung of the walk ladder through ``ops.traverse_fused`` /
   ``ops.traverse_compact``: a synthetic 1.5M-leaf STR hierarchy whose
   full walks pass one CTA's shared memory takes both sliced kernels;
   with a degenerate table the dense walk takes the per-level
   mbr_intersect loop; a single-level tree is one mbr_intersect; launch
   counts per step, each result bit-equal to its plain version;
11. build the large index (``tweets_like`` 40M points, 20x the paper's
   Tweets set, ``str_bulk`` at capacity 128, flattened onto the card),
   whose compact walk needs the ancestor-sliced kernel, and serve the
   kNN and join streams on it (serve.py's defaults; join selectivity
   1e-6); gates: traverse_compact_sliced launched, no full walk, oracles
   at 0 mismatches, at least 200 of 256 sampled join rows not truncated;
   time traverse_compact_sliced on the kNN stream's first batch;
12. print the ``kernels:`` line, the serving rates beside the card, the
   per-kernel JSON line, and the contract's last line.

It imports neither JAX nor the JAX package, and refuses to run without a
CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Deployment: the paper's Chicago Crimes dataset size (872K points).
POINTS = 872_000
QUERIES = 4096
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
NEAR = 1e-5                      # MLP scores this close to the threshold
#                                  may flip between kernel and plain
TIMING_REPS = 30
INSERTS = 8192                   # the mixed stream's new records
LARGE_POINTS = 40_000_000        # the large index: 20x the paper's Tweets
DELTA_CAP = 8192                 # repro.launch.serve's --delta-cap


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median time of ``fn()`` between two CUDA events around each call
    (after two warm-up calls). For a call shorter than its own launch
    this measures the launch: the card waits for the host in between."""
    import torch
    fn()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_events(prof, match: str | None = None) -> list:
    """The profile's device-side events (kernels, copies, sets), those
    whose name contains ``match`` when given."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and (match is None or match in e.name)]


def device_ms(fn, match: str | None = None,
              reps: int = TIMING_REPS) -> tuple[float, str]:
    """Device time per call of ``fn()``: the summed CUPTI durations
    (``torch.profiler``) of the device work it issues — only kernels
    whose name contains ``match`` when given — over ``reps`` calls.
    A profile that recorded no matching activity is taken once more;
    after two empty ones it falls back to ``event_ms``. The second value
    names the source."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = cuda_events(prof, match)
        if ev:
            return (sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3,
                    "cupti")
    return event_ms(fn, reps), "cuda-events"


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, mism, launch, plain, n_bytes, n_ops,
               max_abs_err=0.0, plain_reps=TIMING_REPS, label="") -> dict:
    """Time ``launch`` (the kernel alone) and ``plain`` on the card
    (``plain_reps`` calls for a plain version of thousands of launches),
    print them beside the bound, and return the kernel's JSON row (launch
    count filled in later)."""
    from repro_torch.kernels import cuda as kcuda
    b, by = bound_ms(n_bytes, n_ops)
    k = kcuda.KERNELS[name]
    ms, src = device_ms(launch, f"{name}_kernel")
    plain_ms, psrc = device_ms(plain, reps=plain_reps)
    print(f"  {name}{label}: {mism} mismatches, kernel {ms:.4f} ms ({src}; "
          f"{event_ms(launch):.4f} ms between events), plain "
          f"{plain_ms:.4f} ms ({psrc}; {event_ms(plain, plain_reps):.4f} "
          f"ms between events), bound {b:.4f} ms ({by})")
    return {"name": name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)),
            "replaces": k.replaces, "launches": 0,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None}


def kernel_checks(idx, args, dev, inserts) -> list:
    """Phase 4: each kernel against its plain version at the serving
    path's shapes (one narrow batch), with edge rows; returns the JSON
    rows (launch counts filled in later)."""
    import torch
    from repro_torch.core import traversal
    from repro_torch.core.classifiers.router import router_features
    from repro_torch.core.grid import cells_of_queries
    from repro_torch.kernels import cuda as kcuda, ops, ref

    tree, hyb = idx.dtree, idx.hybrid
    B = args.batch
    q = torch.from_numpy(idx.workload.queries[:B].copy()).to(dev)
    leaf = tree.levels[-1].mbrs
    corner = tree.leaf_entries[0, 0]
    q[0] = torch.tensor([1e9, 1e9, 1e9 + 1, 1e9 + 1], device=dev)  # empty
    q[1] = torch.stack([corner[0], corner[1], corner[0], corner[1]])
    q[2] = torch.stack([leaf[5, 2], leaf[5, 1], leaf[5, 2] + 1e-3,
                        leaf[5, 3]])                  # touches an edge
    rows = []

    def row(name, mism, launch, plain, n_bytes, n_ops, max_abs_err=0.0):
        rows.append(kernel_row(name, mism, launch, plain, n_bytes, n_ops,
                               max_abs_err))

    # -- traverse_fused: dense visited mask of one batch
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    launch, vis = ops.prepare("traverse_fused", q, mb, pa)
    launch()
    want = ref.traverse_fused(q, mb, pa)
    mism = int((vis != want).sum())
    check(mism == 0, f"traverse_fused: {mism} mismatches")
    check(not bool(vis[0].any()), "traverse_fused: empty row visits leaves")
    L = tree.n_leaves
    tests, nodes = walk_work(q, mb, pa)
    row("traverse_fused", mism, launch,
        lambda: ref.traverse_fused(q, mb, pa),
        B * 16 + nodes * 20 + B * L, tests * 4)

    # -- leaf_refine: the narrow R path's slot table, with edge rows
    K = args.max_visited
    li, valid, _ = traversal.compact_mask_counted(want, K)
    li, valid = li.clone(), valid.clone()
    li[3, :4] = torch.tensor([-1, L, L + 9, 0], device=dev)
    valid[3, :4] = False                                 # padded slots
    valid[4] = False                                     # empty row
    M = tree.leaf_entries.shape[1]
    safe = torch.clamp(li, 0, L - 1)
    launch, inside = ops.prepare("leaf_refine", q, tree.leaf_entries, safe,
                                 valid)
    launch()
    ex, ey = tree.leaf_entries[..., 0], tree.leaf_entries[..., 1]
    want_in = ref.leaf_refine(q, ex, ey, safe, valid)
    mism = int((inside != want_in).sum())
    check(mism == 0, f"leaf_refine: {mism} mismatches")
    check(not bool(inside[4].any()), "leaf_refine: empty row matched")
    n_valid = int(valid.sum())
    n_leaves = int(torch.unique(safe[valid]).numel())
    row("leaf_refine", mism, launch,
        lambda: ref.leaf_refine(q, ex, ey, safe, valid),
        B * 16 + B * K * 5 + n_leaves * M * 8 + B * K * M,
        n_valid * M * 4)

    # -- mlp_predict_compact: the deployed bank on this batch
    ait = hyb.ait
    bank = ait.bank
    ids, ok, _ = cells_of_queries(ait.grid, q, ait.max_cells)
    x, cid = ops.mlp_inputs(q, bank, ids)
    kp = ait.max_pred
    launch, (kidx, kcnt) = ops.prepare("mlp_predict_compact", x, cid, ok,
                                       bank, L, kp, ait.threshold)
    launch()
    plain = lambda: ref.mlp_predict_compact(  # noqa: E731
        x, cid, ok, bank.w1, bank.b1, bank.w2, bank.b2, bank.label_map,
        bank.lmask, n_leaves=L, k=kp, threshold=ait.threshold)
    pidx, _, pcnt = plain()
    scores = ref.mlp_predict_scores(x, cid, ok, bank.w1, bank.b1, bank.w2,
                                    bank.b2, bank.label_map, bank.lmask, L)
    near = torch.nonzero(((scores - ait.threshold).abs() < NEAR).any(1))
    near = set(near.flatten().tolist())
    bad = torch.nonzero((kidx != pidx).any(1) | (kcnt != pcnt)).flatten()
    bad = [int(r) for r in bad.tolist()]
    if near:
        print(f"  mlp_predict_compact: near-threshold rows {sorted(near)} "
              f"(reported, differing: {[r for r in bad if r in near]})")
    mism = sum(1 for r in bad if r not in near)
    check(mism == 0, f"mlp_predict_compact: rows {bad} differ")
    keep = [r for r in range(B) if r not in near]
    max_err = float((kcnt[keep] - pcnt[keep]).abs().max())
    mlp_edge_rows(bank, L, kp, dev)
    C, F, H = bank.w1.shape
    Cl = bank.w2.shape[-1]
    n_slots = int(ok.sum())
    cells = int(torch.unique(cid[ok]).numel())
    row("mlp_predict_compact", mism, launch, plain,
        B * F * 4 + B * ids.shape[1] * 5
        + cells * (F * H + H + H * Cl + Cl * 2 + Cl / 4) * 4
        + B * kp * 4 + B * 4,
        n_slots * 2 * (F * H + H * Cl), max_abs_err=max_err)

    # -- forest_infer: the router on this batch, with features exactly on
    #    their thresholds
    rt = hyb.router
    feats = router_features(q)
    feats[5, rt.feat_idx[0, 0]] = rt.thresh[0, 0]
    feats[6, rt.feat_idx[1, 3]] = rt.thresh[1, 3]
    sel = feats[:, rt.feat_idx.long()].contiguous()
    launch, votes = ops.prepare("forest_infer", sel, rt.thresh, rt.tables)
    launch()
    want_v = ref.forest_infer(sel, rt.thresh, rt.tables)
    mism = int((votes != want_v).sum())
    check(mism == 0, f"forest_infer: {mism} mismatches (bit-exact)")
    T, D = rt.feat_idx.shape
    Cr = rt.tables.shape[-1]
    row("forest_infer", mism, launch,
        lambda: ref.forest_infer(sel, rt.thresh, rt.tables),
        B * T * D * 4 + T * D * 4 + rt.tables.numel() * 4 + B * Cr * 4,
        B * T * (D + Cr),
        max_abs_err=float((votes - want_v).abs().max()))
    rows.append(spatial_key_check(idx, dev))
    rows.append(traverse_compact_check(idx, q, dev))
    rows.append(knn_browse_check(idx, args, dev))
    rows.append(delta_probe_check(idx, args, dev, inserts))
    rows += sliced_checks(idx, q, dev)
    return rows


def sliced_checks(idx, q, dev) -> list:
    """mbr_intersect on the batch against every level of the deployed
    tree; both ancestor-sliced kernels with the tree's own table, bit-equal
    to their plain versions and to the full-walk kernels (compact at k 64
    and 512 with strip rows visiting 0, k and k + 1 leaves). Returns the
    mbr_intersect and traverse_fused_sliced rows (the compact one is
    timed on the 40M-point index, where the serving path runs it)."""
    import torch
    from repro_torch.data import synth
    from repro_torch.kernels import ops, ref
    tree = idx.dtree
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    sl = tree.aslices
    B, L = q.shape[0], tree.n_leaves
    print(f"  ancestor table of the deployed tree: levels "
          f"{[int(m.shape[0]) for m in mb]}, windows {sl.widths}, "
          f"{sl.n_tiles} tiles of {sl.tl} leaves")
    for m in mb:
        launch, hit = ops.prepare("mbr_intersect", q, m)
        launch()
        mism = int((hit != ref.mbr_intersect(q, m)).sum())
        check(mism == 0, f"mbr_intersect ({m.shape[0]} MBRs): {mism} "
              "mismatches")
    launch, vis = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    launch()
    want = ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths, sl.tl)
    flaunch, full = ops.prepare("traverse_fused", q, mb, pa)
    flaunch()
    mism = int((vis != want).sum())
    check(mism == 0, f"traverse_fused_sliced: {mism} mismatches")
    check(torch.equal(vis, full), "traverse_fused_sliced differs from the "
          "full walk's kernel")
    for k in (64, 512):
        qk = q.clone()
        qk[-3:] = torch.from_numpy(synth.strip_queries(
            mb[-1].cpu().numpy(), [0, k, k + 1])).to(dev)
        launch, (kidx, kcnt) = ops.prepare("traverse_compact_sliced", qk, mb,
                                           pa, sl, k)
        launch()
        pidx, _, pcnt = ref.traverse_compact_sliced(
            qk, mb, pa, sl.starts, sl.widths, sl.tl, k)
        flaunch, (fidx, fcnt) = ops.prepare("traverse_compact", qk, mb, pa,
                                            k)
        flaunch()
        mism = int((kidx != pidx).sum()) + int((kcnt != pcnt).sum())
        check(mism == 0, f"traverse_compact_sliced (k={k}): {mism} "
              "mismatches")
        check(torch.equal(kidx, fidx) and torch.equal(kcnt, fcnt),
              f"traverse_compact_sliced (k={k}) differs from the full walk")
        check(kcnt[-3:].tolist() == [0, k, k + 1],
              f"traverse_compact_sliced: strip rows visit "
              f"{kcnt[-3:].tolist()}")
    print(f"  traverse_fused_sliced and traverse_compact_sliced: bit-equal "
          f"to their plain versions and to the full-walk kernels (k 64 and "
          f"512, strip rows visiting 0, k, k + 1)")
    tests, nodes = walk_work(q, mb, pa)
    launch, _ = ops.prepare("traverse_compact_sliced", q, mb, pa, sl, 64)
    kernel_row("traverse_compact_sliced", 0, launch,
               lambda: ref.traverse_compact_sliced(q, mb, pa, sl.starts,
                                                   sl.widths, sl.tl, 64),
               B * 16 + nodes * 20 + sl.starts.numel() * 4 + B * 65 * 4,
               tests * 4, label=" (deployment, k 64)")
    launch, _ = ops.prepare("mbr_intersect", q, mb[-1])
    rows = [kernel_row("mbr_intersect", 0, launch,
                       lambda: ref.mbr_intersect(q, mb[-1]),
                       (B + L) * 16 + B * L, B * L * 4)]
    launch, _ = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    rows.append(kernel_row(
        "traverse_fused_sliced", 0, launch,
        lambda: ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths,
                                          sl.tl),
        B * 16 + nodes * 20 + sl.starts.numel() * 4 + B * L, tests * 4))
    return rows


def routing_phase(idx, dev) -> dict:
    """Every rung of the walk ladder through the normal wrappers. A
    synthetic 1.5M-leaf STR hierarchy (fanout 89: levels 1, 3, 190,
    16,854, 1.5M) passes one CTA's shared memory on both full walks:
    with its table both walks take the sliced kernels; with a degenerate
    table (every window the whole lane-padded level) the dense walk takes
    the per-level mbr_intersect loop and the compact walk stays sliced;
    a single-level tree is one mbr_intersect. Each result is bit-equal
    to the plain version. Returns the phase's launch counts."""
    import numpy as np
    import torch
    from repro_torch.core import device_tree as dt, traversal
    from repro_torch.core.rtree import RTree
    from repro_torch.data.synth_tree import synth_levels
    from repro_torch.kernels import cuda as kcuda, ops, ref
    t0 = time.time()
    rng = np.random.default_rng(0)
    mbrs, parents = synth_levels(1_500_000, 89, rng, str_pack=True)
    mb = [torch.from_numpy(m).to(dev) for m in mbrs]
    pa = [torch.from_numpy(p).to(dev) for p in parents]
    sl = dt.build_ancestor_table(pa, device=dev)
    sizes = [len(p) for p in parents]
    degen = dt.AncestorTable(
        starts=torch.zeros_like(sl.starts),
        widths=tuple(-(-n // dt.LANE) * dt.LANE for n in sizes[:-1]),
        tl=sl.tl)
    c = rng.uniform(-1, 1, (512, 2)).astype(np.float32)
    wd = rng.uniform(0, 0.004, (512, 2)).astype(np.float32)
    q = torch.from_numpy(np.concatenate([c - wd, c + wd], 1)).to(dev)
    q[0] = torch.tensor([5.0, 5.0, 6.0, 6.0], device=dev)      # empty
    print(f"# routing tree: levels {sizes}, full walks need "
          f"{ops.walk_smem('fused', 'full', sizes)} / "
          f"{ops.walk_smem('compact', 'full', sizes)} bytes of shared "
          f"memory (limit {ops.MAX_DYNAMIC_SMEM}); table windows "
          f"{sl.widths}, degenerate windows {degen.widths} "
          f"(built in {time.time()-t0:.1f}s)")
    want = ref.traverse_fused(q, mb, pa)
    wc = ref.traverse_compact(q, mb, pa, 64)
    kcuda.reset_launch_counts()
    steps = []

    def step(label, kind, table, fn, expect):
        route = ops.walk_route(kind, sizes, table.widths, table.tl)
        before = kcuda.launch_counts()
        got = fn()
        torch.cuda.synchronize()
        diff = {n: c - before[n] for n, c in kcuda.launch_counts().items()
                if c != before[n]}
        print(f"  {label}: rung {route}, launches {diff}")
        check(diff == expect, f"{label}: launches {diff}, want {expect}")
        steps.append(route)
        return got
    got = step("traverse_fused, built table", "fused", sl,
               lambda: ops.traverse_fused(q, mb, pa, slices=sl),
               {"traverse_fused_sliced": 1})
    plain = ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths,
                                      sl.tl)
    check(torch.equal(got, want) and torch.equal(got, plain),
          "routing: the sliced dense walk differs from plain")
    got = step("traverse_compact, built table", "compact", sl,
               lambda: ops.traverse_compact(q, mb, pa, 64, slices=sl),
               {"traverse_compact_sliced": 1})
    check(all(torch.equal(a, b) for a, b in zip(got, wc)),
          "routing: the sliced compact walk differs from plain")
    got = step("traverse_fused, degenerate table", "fused", degen,
               lambda: ops.traverse_fused(q, mb, pa, slices=degen),
               {"mbr_intersect": len(sizes)})
    check(torch.equal(got, want), "routing: the per-level walk differs")
    got = step("traverse_compact, degenerate table", "compact", degen,
               lambda: ops.traverse_compact(q, mb, pa, 64, slices=degen),
               {"traverse_compact_sliced": 1})
    check(all(torch.equal(a, b) for a, b in zip(got, wc)),
          "routing: the degenerate sliced compact walk differs")
    check(steps == ["sliced", "sliced", "per_level", "sliced"],
          f"routing: rungs {steps}")
    one = dt.flatten(RTree.str_bulk(idx.points[:64], max_entries=128),
                     device=dev)
    q1 = torch.from_numpy(idx.workload.queries[:512].copy()).to(dev)
    q1[-1] = one.levels[0].mbrs[0]
    before = kcuda.launch_counts()["mbr_intersect"]
    res = traversal.range_query_compact(one, q1, max_visited=64,
                                        max_results=512)
    cpu = traversal.range_query_compact(dt.flatten(
        RTree.str_bulk(idx.points[:64], max_entries=128), device="cpu"),
        q1.cpu(), max_visited=64, max_results=512)
    check(kcuda.launch_counts()["mbr_intersect"] == before + 1,
          "routing: the single-level tree did not launch mbr_intersect")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(res, cpu)),
          "routing: the single-level range query differs from the CPU's")
    check(int(res.n_visited[-1]) == 1, "routing: the leaf's own MBR missed")
    counts = kcuda.launch_counts()
    print(f"# launches over the routing phase: "
          f"{ {n: c for n, c in counts.items() if c} } "
          f"({time.time()-t0:.1f}s)")
    return counts


def large_index(dev, card, points: int):
    """The 40M-point index: ``tweets_like`` (20x the paper's Tweets set),
    ``RTree.str_bulk`` at capacity 128, flattened onto the card. Its
    compact walk passes one CTA's shared memory, so the kNN and join
    streams (serve.py's defaults) must run on traverse_compact_sliced
    and never on a full walk; both oracles at 0 mismatches. Returns
    ``(launch counts by stream, rates, the traverse_compact_sliced row)``.
    """
    import numpy as np
    import torch
    from repro_torch.core import device_tree as dt, knn, schedule
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    from repro_torch.kernels import cuda as kcuda, ops, ref
    from repro_torch.launch import serve
    t_all = time.time()
    t0 = time.time()
    pts = synth.tweets_like(points, seed=0)
    t_gen = time.time() - t0
    t0 = time.time()
    host = RTree.str_bulk(pts, max_entries=128)
    t_str = time.time() - t0
    t0 = time.time()
    tree = dt.flatten(host, device=dev)
    torch.cuda.synchronize()
    t_flat = time.time() - t0
    del host
    sizes = [lv.mbrs.shape[0] for lv in tree.levels]
    sl = tree.aslices
    routes = {k: ops.walk_route(k, sizes, sl.widths, sl.tl)
              for k in ("fused", "compact")}
    print(f"# large index: tweets_like {pts.shape[0]} points in "
          f"{t_gen:.1f}s, str_bulk (capacity 128) {t_str:.1f}s, flatten "
          f"{t_flat:.1f}s; {tree.n_leaves} leaves, levels {sizes}, table "
          f"windows {sl.widths} over {sl.n_tiles} tiles of {sl.tl}, "
          f"{tree.byte_size() / 1e6:.1f} MB on the card (+ "
          f"{sl.starts.numel() * 4 / 1e3:.1f} KB of window starts); compact "
          f"walk {ops.walk_smem('compact', 'full', sizes)} bytes full, "
          f"{ops.walk_smem('compact', 'sliced', sizes, sl.widths, sl.tl)} "
          f"sliced; rungs {routes}")
    walk = "traverse_compact_sliced"
    if points == LARGE_POINTS:
        check(ops.walk_route("compact", sizes) != "full"
              and routes["compact"] == "sliced",
              f"the large index's compact walk takes {routes['compact']}")
    elif routes["compact"] == "full":
        walk = "traverse_compact"
        print(f"# CUT: at {points} points the compact walk fits one CTA; "
              "the streams are held to the full walk instead")
    base = ["--dataset", "tweets", "--points", str(points), "--queries",
            str(QUERIES), "--batch", "512", "--sort", "hilbert", "--reps",
            "1", "--max-visited", "64", "--wide-factor", "8", "--device",
            "cuda"]
    counts, rates = {}, {}
    for qt, extra in (("knn", ["--knn-k", "8", "--knn-margin", "2.0"]),
                      ("join", ["--selectivity", "1e-6", "--join-pairs",
                                "16"])):
        args = serve.parse_args(base + extra + ["--query-type", qt])
        kcuda.reset_launch_counts()
        fn = serve.serve_knn if qt == "knn" else serve.serve_join
        out, mism, n_checked = fn(tree, pts, args)
        torch.cuda.synchronize()
        counts[qt] = kcuda.launch_counts()
        print(f"# launches over 2 {qt} streams on the large index: "
              f"{ {n: c for n, c in counts[qt].items() if c} }")
        other = ({"traverse_compact", "traverse_compact_sliced"}
                 - {walk}).pop()
        check(counts[qt][walk] > 0, f"large {qt}: {walk} never launched")
        check(counts[qt][other] == 0 and counts[qt]["traverse_fused"] == 0,
              f"large {qt}: {other} or traverse_fused was launched")
        check(mism == 0, f"large {qt} oracle: {mism} mismatches")
        if qt == "join":
            check(n_checked >= 200, f"large join: only {n_checked} of 256 "
                  "sampled outer rows not truncated")
        make = serve.knn_stream if qt == "knn" else serve.join_stream
        profile_stream(f"{qt} (large index)",
                       make(tree, pts, args)[-1])
        rates[qt] = ", ".join(f"{v:.0f} {k}" for k, v in out.items())
        print(f"# large {qt} on {card}: {rates[qt]}")

    # traverse_compact_sliced at the serving shape: the kNN stream's
    # first narrow batch (probe boxes in Hilbert order)
    kargs = serve.parse_args(base + ["--query-type", "knn"])
    centers, r, _ = serve.knn_stream(tree, pts, kargs)
    boxes = np.concatenate([centers - r, centers + r], 1).astype(np.float32)
    sched = schedule.make_schedule(boxes, 512, "hilbert", device=dev)
    qb = torch.from_numpy(boxes[sched.order[:512]]).to(dev)
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    launch, (kidx, kcnt) = ops.prepare("traverse_compact_sliced", qb, mb, pa,
                                       sl, 64)
    launch()
    pidx, _, pcnt = ref.traverse_compact_sliced(qb, mb, pa, sl.starts,
                                                sl.widths, sl.tl, 64)
    mism = int((kidx != pidx).sum()) + int((kcnt != pcnt).sum())
    check(mism == 0, f"traverse_compact_sliced (large index): {mism} "
          "mismatches")
    tests, nodes = walk_work(qb, mb, pa)
    row = kernel_row(
        "traverse_compact_sliced", mism, launch,
        lambda: ref.traverse_compact_sliced(qb, mb, pa, sl.starts, sl.widths,
                                            sl.tl, 64),
        512 * 16 + nodes * 20 + sl.starts.numel() * 4 + 512 * 65 * 4,
        tests * 4, plain_reps=3,
        label=f" (large index, kNN batch, mean "
              f"{float(kcnt.float().mean()):.1f} visited)")
    print(f"# large-index phase: {time.time()-t_all:.1f}s")
    return counts, rates, row


def spatial_key_check(idx, dev) -> dict:
    """spatial_key, both curves, on the stream's 4096 normalized centres
    plus edge rows (the frame's corners — 1.0 clips to 32767 — centres
    outside it, exact quantization steps and the floats just below), and
    through the wrapper with a zero-extent frame. Bit-equal."""
    import numpy as np
    import torch
    from repro_torch.core import schedule
    from repro_torch.kernels import ops, ref
    wq = idx.workload.queries
    q = torch.from_numpy(wq).to(dev)
    bbox = torch.from_numpy(schedule.workload_bbox(wq)).to(dev)
    cxy = ops.spatial_key_inputs(q, bbox)
    steps = np.array([1, 2, 3, 1000, 32767], np.float32) / np.float32(32768)
    edge = [[0, 0], [1, 1], [0, 1], [1, 0], [-0.5, 1.5], [1.5, -0.25],
            [-1e10, 1e10], [np.inf, -np.inf]] + [[v, v] for v in steps] \
        + [[np.nextafter(v, np.float32(0)), v] for v in steps]
    cxy_e = torch.cat([cxy, torch.tensor(np.asarray(edge, np.float32),
                                         device=dev)])
    flat = torch.cat([q[0, :2], q[0, :2]])           # zero-extent frame
    for curve in ("morton", "hilbert"):
        launch, keys = ops.prepare("spatial_key", cxy_e, curve)
        launch()
        mism = int((keys != ref.spatial_key(cxy_e, curve=curve)).sum())
        cf = ops.spatial_key_inputs(q, flat)
        launch, kf = ops.prepare("spatial_key", cf, curve)
        launch()
        mism += int((kf != ref.spatial_key(cf, curve=curve)).sum())
        check(mism == 0, f"spatial_key ({curve}): {mism} mismatches")
        check(int(keys[len(wq) + 1]) == int(keys[len(wq) + 12]),
              f"spatial_key ({curve}): 1.0 does not clip to 32767")
    print(f"  spatial_key: both curves bit-equal on {len(wq)} centres, "
          f"{len(edge)} edge rows and a zero-extent frame")
    launch, _ = ops.prepare("spatial_key", cxy, "hilbert")
    n = cxy.shape[0]
    return kernel_row("spatial_key", 0, launch,
                      lambda: ref.spatial_key(cxy, curve="hilbert"),
                      n * 12, n * 15 * 16)


def walk_work(q, mb, pa) -> tuple[int, int]:
    """What a root-to-leaf walk of this batch must do: ``(tests, nodes)``,
    the (query, node) MBR tests — every node of the top level, and below
    it the children of the query's visited nodes — and the distinct
    nodes any query tests, each of which is read once."""
    import torch
    from repro_torch.kernels import ref
    tests = nodes = 0
    vis = None
    for m, p in zip(mb, pa):
        hit = ref.mbr_intersect(q, m)
        live = torch.ones_like(hit) if vis is None else vis[:, p.long()]
        tests += int(live.sum())
        nodes += int(live.any(0).sum())
        vis = live & hit
    return tests, nodes


def traverse_compact_check(idx, q, dev) -> dict:
    """traverse_compact at k = 64 (narrow) and 512 (wide) on one batch
    whose last rows visit 0, exactly k and k + 1 leaves, and on a
    single-level tree; bit-equal to ``compact_mask_counted`` of the
    walk."""
    import torch
    from repro_torch.core import device_tree as dt
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    from repro_torch.kernels import ops, ref
    tree = idx.dtree
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    ks = [k for k in (64, 512) if k + 1 < tree.n_leaves]
    if ks != [64, 512]:
        print(f"# CUT: traverse_compact strip rows at k in {ks} only "
              f"({tree.n_leaves} leaves)")
    for k in ks:
        qk = q.clone()
        qk[-3:] = torch.from_numpy(synth.strip_queries(
            mb[-1].cpu().numpy(), [0, k, k + 1])).to(dev)
        launch, (kidx, kcnt) = ops.prepare("traverse_compact", qk, mb, pa, k)
        launch()
        pidx, _, pcnt = ref.traverse_compact(qk, mb, pa, k)
        mism = int((kidx != pidx).sum()) + int((kcnt != pcnt).sum())
        check(mism == 0, f"traverse_compact (k={k}): {mism} mismatches")
        check(kcnt[-3:].tolist() == [0, k, k + 1],
              f"traverse_compact: strip rows visit {kcnt[-3:].tolist()}")
    one = dt.flatten(RTree.str_bulk(idx.points[:64], max_entries=128),
                     device=dev)
    check(one.height == 1, "str_bulk of 64 points is not a single leaf")
    m1 = [lv.mbrs for lv in one.levels]
    p1 = [lv.parent for lv in one.levels]
    q1 = q.clone()
    q1[-2] = m1[0][0]                                # the leaf's own MBR
    p0 = one.leaf_entries[0, 0]
    q1[-1] = torch.cat([p0, p0])                     # one of its points
    launch, (kidx, kcnt) = ops.prepare("traverse_compact", q1, m1, p1, 64)
    launch()
    pidx, _, pcnt = ref.traverse_compact(q1, m1, p1, 64)
    check(torch.equal(kidx, pidx) and torch.equal(kcnt, pcnt),
          "traverse_compact: single-level tree differs")
    check(kcnt[-2:].tolist() == [1, 1],
          "traverse_compact: single-level tree missed its leaf")
    print(f"  traverse_compact: bit-equal at k in {ks} (strip rows "
          f"visit 0, k, k + 1) and on a single-level tree "
          f"({int(kcnt.sum())} of {q.shape[0]} rows hit its leaf)")
    launch, (kidx, kcnt) = ops.prepare("traverse_compact", q, mb, pa, 64)
    tests, nodes = walk_work(q, mb, pa)
    return kernel_row("traverse_compact", 0, launch,
                      lambda: ref.traverse_compact(q, mb, pa, 64),
                      q.shape[0] * 16 + nodes * 20 + q.shape[0] * 65 * 4,
                      tests * 4)


def knn_browse_check(idx, args, dev) -> dict:
    """knn_browse on the kNN stream's first narrow batch (probe boxes at
    the default radius, k = 8, slots from traverse_compact), with invalid
    slots, an all-invalid row and an entry exactly at d2 == r2; the
    deployment's leaves hold fewer than 128 entries (+inf padding).
    Bit-equal."""
    import numpy as np
    import torch
    from repro_torch.core import knn
    from repro_torch.kernels import ops, ref
    tree = idx.dtree
    rng = np.random.default_rng(0)
    pts = idx.points
    c = torch.from_numpy(pts[rng.integers(0, len(pts), args.batch)]
                         .astype(np.float32)).to(dev)
    r = torch.tensor(knn.default_radius(tree, 8), device=dev)
    li, valid, _ = ref.traverse_compact(
        torch.cat([c - r, c + r], 1), [lv.mbrs for lv in tree.levels],
        [lv.parent for lv in tree.levels], args.max_visited)
    c3 = torch.cat([c, (r * r).expand(len(c), 1)], 1)
    li, valid = li.clone(), valid.clone()
    valid[3, :4] = False                                   # padded slots
    valid[4] = False                                       # empty row
    leaf = int(li[1, 0])
    e = tree.leaf_entries[leaf, 0]
    dx, dy = e[0] - c3[1, 0], e[1] - c3[1, 1]
    c3[1, 2] = dx * dx + dy * dy                           # d2 == r2
    valid[1, 0] = True
    n_pad = int((tree.leaf_counts < tree.leaf_entries.shape[1]).sum())
    check(n_pad > 0, "no leaf with +inf padding")
    launch, d2 = ops.prepare("knn_browse", c3, tree.leaf_entries, li, valid)
    launch()
    ex, ey = tree.leaf_entries[..., 0], tree.leaf_entries[..., 1]
    want = ref.knn_browse(c3, ex, ey, li, valid)
    mism = int((d2 != want).sum())   # +inf == +inf
    check(mism == 0, f"knn_browse: {mism} mismatches (bit-exact)")
    check(float(d2[1, 0, 0]) == float(c3[1, 2]),
          "knn_browse: the entry at d2 == r2 was dropped")
    check(bool(torch.isinf(d2[4]).all()), "knn_browse: empty row hit")
    print(f"  knn_browse: bit-equal, the d2 == r2 entry kept, "
          f"{int(torch.isfinite(d2).sum())} in-radius entries, "
          f"{n_pad} of {tree.n_leaves} leaves padded")
    B, K = li.shape
    M = tree.leaf_entries.shape[1]
    n_valid = int(valid.sum())
    n_leaves = int(torch.unique(li[valid]).numel())
    return kernel_row("knn_browse", 0, launch,
                      lambda: ref.knn_browse(c3, ex, ey, li, valid),
                      B * 12 + B * K * 5 + n_leaves * M * 8 + B * K * M * 4,
                      n_valid * M * 6)


def make_inserts():
    """The mixed stream's inserts: ``INSERTS`` new records of the same
    synthetic city (the generator draws its hot blocks before anything
    that depends on n), shuffled so they arrive in no spatial order."""
    import numpy as np
    from repro_torch.data import synth
    ins = synth.crimes_like(INSERTS, seed=1)
    return ins[np.random.default_rng(0).permutation(ins.shape[0])]


def delta_probe_case(q, buf, k, dev, edge: bool) -> list:
    """One delta_probe check: kernel against plain version, bit-equal on
    slot table, validity and count. With ``edge`` the first k + 1 buffer
    points move onto the line y = 0 at x = 100 + i/1024 (exact in f32,
    outside the city) and rows 1-3 get rects whose edges pass through
    them (k, k + 1 and, from a corner, k - 1 hits). Returns the counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    q, buf = q.copy(), buf.copy()
    q[0] = [1e9, 1e9, 1e9 + 1, 1e9 + 1]                     # empty row
    if edge:
        step = np.float32(1 / 1024)
        buf[:k + 1, 0] = 100 + np.arange(k + 1, dtype=np.float32) * step
        buf[:k + 1, 1] = 0
        q[1] = [100, 0, 100 + (k - 1) * step, 0]
        q[2] = [100, 0, 100 + k * step, 0]
        q[3] = [100 + 2 * step, 0, 101, 1]
    qt, bt = torch.from_numpy(q).to(dev), torch.from_numpy(buf).to(dev)
    launch, (kidx, kcnt) = ops.prepare("delta_probe", qt, bt, k)
    launch()
    pidx, pvalid, pcnt = ref.delta_probe(qt, bt, k)
    kvalid = torch.arange(k, device=dev)[None, :] < kcnt[:, None]
    mism = int((kidx != pidx).sum() + (kcnt != pcnt).sum()
               + (kvalid != pvalid).sum())
    check(mism == 0, f"delta_probe (cap {len(buf)}, k {k}): {mism} "
          "mismatches")
    counts = kcnt.tolist()
    check(counts[0] == 0, "delta_probe: the empty row hit")
    if edge:
        check(counts[1:4] == [k, k + 1, k - 1],
              f"delta_probe edge rows count {counts[1:4]}")
    return counts


def delta_probe_check(idx, args, dev, inserts) -> dict:
    """delta_probe on one narrow batch of the range workload against the
    mixed stream's buffer (cap 8192) filled to 0, 1,170, 6,144 and 8,192
    inserts, at k 64 (narrow) and 512 (wide), with edge rows; then a cap
    that is not a multiple of the block and a one-point store. Bit-equal.
    Timed at fill 6,144, k 64."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    B, cap = args.batch, DELTA_CAP
    q = idx.workload.queries[:B].astype(np.float32)
    for fill in (0, 1170, 6144, 8192):
        buf = np.full((cap, 2), np.inf, np.float32)
        buf[:fill] = inserts[:fill]
        for k in (64, 512):
            delta_probe_case(q, buf, k, dev, edge=fill > k)
    odd = np.full((777, 2), np.inf, np.float32)
    odd[:600] = inserts[:600]
    delta_probe_case(q[:37], odd, 8, dev, edge=True)
    one = inserts[:1].astype(np.float32)
    got = delta_probe_case(np.concatenate([q[:4], [np.r_[one[0], one[0]]]])
                           .astype(np.float32), one, 4, dev, edge=False)
    check(got[-1] == 1, "delta_probe: a one-point store missed its point")
    print(f"  delta_probe: bit-equal at cap {cap} (fills 0, 1170, 6144, "
          f"8192; k 64 and 512; edge rows with k, k + 1 and k - 1 hits), "
          f"at cap 777 and on a one-point store")
    fill, k = 6144, 64
    buf = np.full((cap, 2), np.inf, np.float32)
    buf[:fill] = inserts[:fill]
    qt, bt = torch.from_numpy(q).to(dev), torch.from_numpy(buf).to(dev)
    launch, _ = ops.prepare("delta_probe", qt, bt, k)
    return kernel_row("delta_probe", 0, launch,
                      lambda: ref.delta_probe(qt, bt, k),
                      B * 16 + cap * 8 + B * (k + 1) * 4, B * fill * 4)


def mlp_edge_rows(bank, L: int, k: int, dev) -> None:
    """The fused prediction kernel on the edge rows, with a bank of the
    deployed bank's F, H and Cl whose cells are pinned by their biases
    (w = 0): cells 0..2 predict three runs of leaves 0..k-1, cell 3 leaf
    k, cell 4 nothing. Rows: 0, exactly k, k + 1, duplicates across
    cells, all-padded and partly padded slots."""
    import torch
    from repro_torch.core.classifiers.mlp import MLPBank
    from repro_torch.kernels import ops, ref
    _, F, H = bank.w1.shape
    run = -(-k // 3)
    Cl = max(bank.w2.shape[-1], run)
    C = 5
    check(L >= k + 1, "too few leaves for the edge rows")
    b2 = torch.full((C, Cl), -9.0, device=dev)
    lm = torch.full((C, Cl), -1, dtype=torch.int32, device=dev)
    lmk = torch.zeros((C, Cl), dtype=torch.bool, device=dev)
    sizes = []
    for c in range(3):
        ids = torch.arange(c * run, min((c + 1) * run, k), device=dev,
                           dtype=torch.int32)
        n = ids.numel()
        lm[c, :n], b2[c, :n], lmk[c, :n] = ids, 9.0, True
        sizes.append(n)
    lm[3, 0], b2[3, 0], lmk[3, 0] = k, 9.0, True
    lmk[4] = True
    lm[4] = 0                                      # masked by b2 = -9
    eb = MLPBank(w1=torch.zeros((C, F, H), device=dev),
                 b1=torch.zeros((C, H), device=dev),
                 w2=torch.zeros((C, H, Cl), device=dev), b2=b2,
                 mu=bank.mu, sd=bank.sd, label_map=lm, lmask=lmk)
    T = True
    edge = [([4, 4, 4, 4], [T] * 4, 0),                       # nothing
            ([0, 1, 2, 4], [T] * 4, k),                       # exactly k
            ([0, 1, 2, 3], [T] * 4, k + 1),                   # k + 1
            ([0, 0, 1, 1], [T] * 4, sizes[0] + sizes[1]),     # duplicates
            ([0, 1, 2, 3], [False] * 4, 0),                   # padded
            ([0, 1, 2, 3], [T, False, T, False], sizes[0] + sizes[2])]
    cid = torch.tensor([e[0] for e in edge], dtype=torch.int32, device=dev)
    ok = torch.tensor([e[1] for e in edge], device=dev)
    x = torch.zeros((len(edge), F), device=dev)
    launch, (kidx, kcnt) = ops.prepare("mlp_predict_compact", x, cid, ok,
                                       eb, L, k, 0.5)
    launch()
    pidx, _, pcnt = ref.mlp_predict_compact(
        x, cid, ok, eb.w1, eb.b1, eb.w2, eb.b2, eb.label_map, eb.lmask,
        n_leaves=L, k=k, threshold=0.5)
    for r, (_, _, want) in enumerate(edge):
        check(int(kcnt[r]) == want == int(pcnt[r]),
              f"mlp edge row {r}: count {int(kcnt[r])}, want {want}")
        check(bool(torch.equal(kidx[r], pidx[r])), f"mlp edge row {r} ids")
    print(f"  mlp_predict_compact edge rows: counts "
          f"{[int(c) for c in kcnt]} (k={k}) equal the plain version's")


def brute_force_check(idx, report, dev, n_sample: int, max_results: int):
    """Phase 5b: sampled queries against f32 brute-force containment of
    every point: n_results exactly, and the id set where it fits."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    rng = np.random.default_rng(0)
    Q = idx.workload.n_queries
    sample = rng.choice(Q, min(n_sample, Q), replace=False)
    st = report.stats
    mism_n = mism_ids = 0
    for o, inside in serve._inside_chunks(
            idx.points, idx.workload.queries[sample], dev, chunk=64):
        s = sample[o:o + 64]
        n = inside.sum(1).cpu().numpy()
        mism_n += int((n != st.n_results[s]).sum())
        for j, qi in enumerate(s):
            if n[j] <= max_results:
                want = set(torch.nonzero(inside[j]).flatten().tolist())
                got = st.result_ids[qi]
                mism_ids += int(set(got[got >= 0].tolist()) != want)
    print(f"# brute force: {mism_n} / {sample.size} sampled n_results and "
          f"{mism_ids} id-set mismatches vs f32 containment of all "
          f"{idx.points.shape[0]} points")
    check(mism_n == 0 and mism_ids == 0, "brute-force containment mismatch")


def schedule_cost(queries, batch: int, dev) -> None:
    """Host-clock cost of batch formation alone (``make_schedule``:
    curve keys on the card, copy back, stable argsort) per stream,
    median of 20, for each sort mode."""
    import torch
    from repro_torch.core import schedule
    ms = {}
    for sort in ("hilbert", "morton", "none"):
        times = []
        for _ in range(22):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            schedule.make_schedule(queries, batch, sort, device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[sort] = statistics.median(times[2:])
    print("# batch formation per stream (host clock, median of 20): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))


def profile_stream(label: str, run):
    """One more full stream (``run()``) under ``torch.profiler`` (device
    activity only): wall time, device busy share, and the device time by
    kernel, the port's CUDA kernels' share among it. Returns ``(run()'s
    result, busy ms, {kernel name: ms})``, busy None without device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cuda as kcuda
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in cuda_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    if not by_name:
        print(f"# profile of one {label} stream: the profiler recorded no "
              "device activity (device busy share not measured)")
        return out, None, by_name
    busy = sum(by_name.values())
    ours = sum(v for n, v in by_name.items()
               if any(f"{k}_kernel" in n for k in kcuda.KERNELS))
    print(f"# profile of one {label} stream (CUPTI): wall {wall:.2f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%, idle "
          f"{100 - 100 * busy / wall:.1f}%), the port's CUDA kernels "
          f"{ours:.3f} ms ({100 * ours / max(busy, 1e-9):.1f}% of busy), "
          f"{len(cuda_events(prof))} device activities")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:100]}")
    return out, busy, by_name


def mixed_stream(idx, base_argv, inserts, dev):
    """Phase 7: the mixed read/write stream through ``serve.serve_mixed``
    with the maintenance policy, its gates, the wall split and the
    profile of one serve pass at fill 6,144. Returns ``(launch counts,
    rate)``."""
    import numpy as np
    import torch
    from repro_torch.core import delta, schedule
    from repro_torch.core.hybrid import hybrid_query
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    margs = serve.parse_args(base_argv + [
        "--sort", "hilbert", "--reps", "1", "--insert-every", "1",
        "--delta-cap", str(DELTA_CAP), "--policy", "default",
        "--refit-chunk", "4", "--repack-at", "0.75"])
    server = serve.make_fresh_server(idx, margs)
    calls = {"serve": 0, "serve_wide": 0}
    secs = {"repack": 0.0, "refit_cells": 0.0}

    def counted(name):
        fn = getattr(server, name)

        def call(q):
            calls[name] += 1
            return fn(q)
        setattr(server, name, call)

    def clocked(name):
        fn = getattr(server, name)

        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        setattr(server, name, call)
    for name in calls:
        counted(name)
    for name in secs:
        clocked(name)

    kcuda.reset_launch_counts()
    mixed, server, dt_s, mism = serve.serve_mixed(idx, inserts, margs,
                                                  server=server)
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    print(f"# launches over the mixed stream ({calls['serve']} narrow + "
          f"{calls['serve_wide']} wide batches): {counts}")
    n_probe = calls["serve"] + calls["serve_wide"]
    check(counts["delta_probe"] == n_probe,
          f"delta_probe launched {counts['delta_probe']} times for "
          f"{n_probe} served batches")
    check(calls["serve"] == mixed.n_batches, "narrow batch count differs")
    for name in ("spatial_key", "traverse_fused", "leaf_refine",
                 "mlp_predict_compact", "forest_infer"):
        check(counts[name] > 0, f"{name} never launched on the mixed stream")
    n_repacks = mixed.n_repacks + sum(d.repack for _, d in mixed.maintenance)
    n_refit = sum(r.cells_refit for r in server.refits)
    hits = int(mixed.stats.delta_hits.sum())
    check(mixed.n_inserts == INSERTS, f"{mixed.n_inserts} inserts staged")
    check(n_repacks >= 1, "the mixed stream never repacked")
    check(n_refit > 0, "the mixed stream refit no cell")
    check(hits > 0, "no query hit the delta buffer")
    check(mism == 0, f"mixed oracle: {mism} n_results mismatches")
    trunc = mixed.stats.truncated.astype(bool)
    rows = np.random.default_rng(0).choice(np.flatnonzero(~trunc),
                                           min(512, int((~trunc).sum())),
                                           replace=False)
    _, id_mism, n_rows = serve.mixed_oracle(
        mixed, idx.points, idx.workload.queries, dev, id_rows=rows)
    print(f"# mixed oracle: {mism} / {mixed.n_queries} n_results and "
          f"{id_mism} / {n_rows} sampled id-set mismatches vs f32 "
          f"brute force over each segment's visible points; {n_repacks} "
          f"repacks, {n_refit} cells refit in {len(server.refits)} "
          f"refit_cells calls, {hits} delta hits")
    check(id_mism == 0, f"mixed oracle: {id_mism} id-set mismatches")
    check(n_rows >= 500, f"only {n_rows} rows compared by id set")
    serving = dt_s - secs["repack"] - secs["refit_cells"]
    print(f"# mixed wall {dt_s:.3f} s: serving {serving:.3f} s, repack "
          f"{secs['repack']:.3f} s (incl. the span diff), refit chunks "
          f"{secs['refit_cells']:.3f} s; {mixed.n_queries / dt_s:.0f} "
          f"queries/s end to end, {mixed.n_queries / serving:.0f} "
          f"queries/s serving alone")

    # one FreshServer.serve pass over the stream at fill 6,144
    nargs = serve.parse_args(base_argv + ["--delta-cap", str(DELTA_CAP)])
    pserver = serve.make_fresh_server(idx, nargs)
    pserver.insert(inserts[:6144])
    q = idx.workload.queries
    bbox = schedule.workload_bbox(q)

    def run():
        return schedule.serve_workload(
            pserver.serve, q, batch=margs.batch, sort="hilbert", bbox=bbox,
            wide_fn=pserver.serve_wide, device=dev)
    run()
    rep, busy, by_name = profile_stream("FreshServer.serve (fill 6144)",
                                        run)
    if busy:
        probe = sum(v for n, v in by_name.items() if "delta_probe" in n)
        ms = {}
        for tier, widen in (("narrow", 1), ("wide", margs.wide_factor)):
            qb = torch.from_numpy(q[:margs.batch]).to(dev)
            res = hybrid_query(pserver.hybrid, qb,
                               max_visited=margs.max_visited * widen,
                               max_results=512 * widen)
            hit = delta.probe(pserver.delta.xy, qb, k=64 * widen,
                              base=pserver.delta.base)
            ms[tier] = device_ms(
                lambda: delta.merge_hybrid_result(res, hit))[0]
        merge = rep.n_batches * ms["narrow"] + rep.wide_batches * ms["wide"]
        print(f"# fill 6144: delta_probe {probe:.3f} ms "
              f"({100 * probe / busy:.1f}% of busy), merge "
              f"{ms['narrow']:.4f} ms per narrow and {ms['wide']:.4f} ms "
              f"per wide batch, {merge:.3f} ms over the pass "
              f"({100 * merge / busy:.1f}% of busy; {rep.n_batches} narrow "
              f"+ {rep.wide_batches} wide batches)")
    return counts, f"{mixed.n_queries / dt_s:.0f} queries/s"


def forest_phase(idx, base_argv, dev, card):
    """Phase 8: the forest bank at the deployment — fit, the range stream
    through it with its gates, the dense path of forest_infer_cells and
    the kernel's checks. Returns ``(launch counts by path, the stream's
    summary, the kernel's JSON row)``."""
    import dataclasses
    import torch
    from repro_torch.core import build
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    t0 = time.time()
    hyb, rep = build.fit_airtree(idx.dtree, idx.workload, kind="forest",
                                 verbose=True)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    print(f"# AI+R (forest): grid {rep.grid_size}², exact-fit "
          f"{rep.exact_fit:.3f} ({int(rep.cell_fit.sum())}/"
          f"{rep.cell_fit.size} cells exact), router test acc "
          f"{rep.router.test_acc:.3f}, models {rep.model_bytes/1e6:.2f} MB, "
          f"fit {fit_s:.1f}s (host trees + exact-fit evaluation on the card)")
    fidx = dataclasses.replace(idx, hybrid=hyb, report=rep)
    fargs = serve.parse_args(base_argv + [
        "--classifier", "forest", "--sort", "hilbert", "--reps", "1"])
    kcuda.reset_launch_counts()
    report, dt_s = serve.serve_stream(hyb, idx.workload, fargs)
    torch.cuda.synchronize()
    counts = {"range (forest bank)": kcuda.launch_counts()}
    mism = serve.report_stream(report, dt_s, fidx)
    print(f"# launches over 2 forest-bank range streams: "
          f"{counts['range (forest bank)']}")
    check(mism == 0, f"forest oracle: {mism} n_results mismatches")
    for name in ("spatial_key", "traverse_fused", "leaf_refine",
                 "forest_infer"):
        check(counts["range (forest bank)"][name] > 0,
              f"{name} never launched on the forest-bank stream")
    check(counts["range (forest bank)"]["mlp_predict_compact"] == 0,
          "the forest-bank stream launched mlp_predict_compact")
    brute_force_check(fidx, report, dev, 512, 512)
    st = report.stats
    ai = 100 * float(st.used_ai.mean())
    acc = float(st.leaf_accesses.mean())
    rate = (f"{report.n_queries / dt_s:.0f} queries/s, {ai:.1f}% AI path, "
            f"{acc:.2f} leaf accesses/query")
    print(f"# serve forest on {card}: {rate}")
    profile_stream("range (forest bank)",
                   serve.range_stream(hyb, idx.workload, fargs))
    counts["forest (dense)"], row = forest_dense(hyb.ait.bank,
                                                 idx.workload.queries, dev)
    return counts, rate, row


def forest_dense(bank, queries, dev):
    """The dense form of the forest bank, ``forest.cell_probs_dense``,
    over the stream's queries in batches of 512 (launch counts reset
    before and read after); then, outside the counts, each batch against
    the gathered form over every cell, and forest_infer_cells against its
    plain version on the first batch and on a synthetic bank. Returns
    ``(launch counts, the kernel's JSON row)``."""
    import torch
    from repro_torch.core.classifiers import forest
    from repro_torch.kernels import cuda as kcuda, ops, ref
    q_all = torch.from_numpy(queries).to(dev)
    batches = [q_all[o:o + 512] for o in range(0, q_all.shape[0], 512)]
    kcuda.reset_launch_counts()
    dense = [forest.cell_probs_dense(bank, q) for q in batches]
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    print(f"# launches over the forest bank's dense form ({len(batches)} "
          f"batches): { {n: c for n, c in counts.items() if c} }")
    check(counts["forest_infer_cells"] == len(batches),
          f"forest_infer_cells launched {counts['forest_infer_cells']} "
          f"times for {len(batches)} batches")
    C, T, D = bank.feat_idx.shape
    Cl = bank.tables.shape[-1]
    for q, d in zip(batches, dense):
        ids = torch.arange(C, dtype=torch.int32, device=dev).expand(
            q.shape[0], C)
        check(torch.equal(d, forest.cell_probs_for(bank, q, ids)),
              "cell_probs_dense differs from cell_probs_for over every cell")
    del dense
    fi = bank.feat_idx.reshape(C * T, D)
    th = bank.thresh.reshape(C * T, D)
    tb = bank.tables.reshape(C * T, 2 ** D, Cl)
    q = batches[0]
    launch, votes = ops.prepare("forest_infer_cells", q, fi, th, tb, C)
    launch()
    want = ref.forest_infer_cells(q, fi, th, tb, C)
    mism = int((votes != want).sum())
    check(mism == 0, f"forest_infer_cells (deployment bank): {mism} "
          "mismatches (bit-exact)")
    del votes, want
    synthetic_forest_check(q, dev)
    print(f"  forest_infer_cells: bit-equal to its plain version on the "
          f"deployment's bank ({C} cells x {T} tree, depth {D}, {Cl} "
          f"labels) and on the synthetic bank; cell_probs_dense equals "
          f"the gathered form over every cell on all {len(batches)} "
          f"batches")
    # the bound counts what this batch needs: the output, the table rows
    # its codes name (each once), the features and the trees' tests
    bits = (q[:, fi.long()] > th[None]).long()
    powers = 2 ** torch.arange(D - 1, -1, -1, device=dev)
    codes = (bits * powers).sum(-1)                           # [B, C·T]
    rows = torch.arange(C * T, device=dev)[None, :] * 2 ** D + codes
    n_rows = int(torch.unique(rows).numel())
    B = q.shape[0]
    n_bytes = B * C * Cl * 4 + n_rows * Cl * 4 + q.numel() * 4 \
        + C * T * D * 8
    n_ops = B * C * T * D + B * C * Cl * (T - 1)
    row = kernel_row("forest_infer_cells", mism, launch,
                     lambda: ref.forest_infer_cells(q, fi, th, tb, C),
                     n_bytes, n_ops,
                     label=f" (deployment bank, batch {B}, {n_rows} "
                           f"distinct table rows)")
    del rows, codes, bits
    return counts, row


def synthetic_forest_check(q, dev) -> None:
    """forest_infer_cells on a synthetic bank over the batch's features:
    16 cells of 4 trees of depth 8, 37 labels (not a multiple of 32),
    cells 3 and 7 empty (``thresh = +inf``), thresholds from the
    features' own values so that both branches are taken, one feature
    exactly on its threshold. Bit-equal to the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    C, T, D, Cl = 16, 4, 8, 37
    x = q.cpu().numpy()
    B, F = x.shape
    fi = rng.integers(0, F, (C * T, D)).astype(np.int32)
    th = x[rng.integers(0, B, (C * T, D)), fi]
    th[3 * T:4 * T] = np.inf
    th[7 * T:8 * T] = np.inf
    tb = rng.uniform(0, 1, (C * T, 2 ** D, Cl)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (x, fi, th, tb)]
    launch, votes = ops.prepare("forest_infer_cells", *args, C)
    launch()
    want = ref.forest_infer_cells(*args, C)
    check(torch.equal(votes, want), "forest_infer_cells (synthetic bank, "
          f"T 4): {int((votes != want).sum())} mismatches")
    check(bool((votes[:, 3] == votes[0, 3]).all()),
          "forest_infer_cells: an empty cell's votes vary by query")


def open_loop_phase(idx, base_argv, dev):
    """Phase 9: the MLP range stream open-loop (``serve_open_loop``)
    under Poisson arrivals, both formations. The driver's automatic rate
    (1.5x the measured capacity) and deadline (6x a narrow + wide step)
    are computed once from one ``serve.measure_capacity`` and passed to
    both runs, so the two formations see the same arrivals and
    deadlines. Returns ``(launch counts by path, {formation:
    summary})``."""
    import torch
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    args = serve.parse_args(base_argv + ["--sort", "hilbert"])
    narrow, wide, trunc = serve.make_serve_fns(idx.hybrid, args)
    ts = serve.measure_capacity(narrow, wide, idx.workload.queries, args)
    step = ts["narrow"] + ts["wide"]
    rate = 1.5 * args.batch / step
    print(f"# open-loop capacity: narrow step {ts['narrow']*1e3:.3f} ms, "
          f"wide step {ts['wide']*1e3:.3f} ms (host clock, median of 3) -> "
          f"{args.batch / step:.0f} queries/s; both formations at "
          f"{rate:.0f} queries/s offered, deadline {6e3 * step:.3f} ms")
    counts, summary = {}, {}
    for formation in ("deadline", "full"):
        oargs = serve.parse_args(base_argv + [
            "--sort", "hilbert", "--arrival", "poisson", "--formation",
            formation, "--rate", repr(rate), "--deadline-ms",
            repr(6e3 * step)])
        kcuda.reset_launch_counts()
        t0 = time.time()
        rep, mism = serve.serve_open_loop(narrow, wide, trunc, idx.workload,
                                          oargs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        path = f"open loop ({formation})"
        counts[path] = kcuda.launch_counts()
        print(f"# launches over the {path} stream: "
              f"{ {n: c for n, c in counts[path].items() if c} }")
        check(mism == 0, f"{path} oracle: {mism} mismatches on rows not "
              "degraded")
        check(rep.stats.truncated[rep.degraded].all(),
              f"{path}: a degraded row lost its truncation flag")
        for name in ("spatial_key", "traverse_fused", "leaf_refine",
                     "mlp_predict_compact", "forest_infer"):
            check(counts[path][name] > 0,
                  f"{name} never launched on the {path} stream")
        lat = rep.telemetry["latency_s"]
        summary[formation] = (
            f"p50 {lat['p50']*1e3:.3f} / p95 {lat['p95']*1e3:.3f} / p99 "
            f"{lat['p99']*1e3:.3f} ms, goodput {100*rep.goodput:.2f}%, "
            f"{rep.n_degraded} degraded, {rep.n_missed} missed, "
            f"{rep.n_batches} + {rep.n_wide_batches} wide batches "
            f"(mean fill {100*rep.mean_fill:.1f}%), {wall:.2f}s wall")
        print(f"# open loop ({formation}): {summary[formation]}")
    return counts, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="chip smoke of repro_torch")
    p.add_argument("--points", type=int, default=POINTS,
                   help="dataset size (a cut below the deployment's "
                        f"{POINTS} is printed as such)")
    p.add_argument("--large-points", type=int, default=LARGE_POINTS,
                   help="the large index's size (a cut below "
                        f"{LARGE_POINTS} is printed as such)")
    opts = p.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no src/repro_torch under {ROOT})", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke runs only on the card",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    from repro_torch import resolve_device
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve

    t_start = time.time()
    card = card_line()
    print(card)
    dev = resolve_device("cuda")

    t0 = time.time()
    kcuda.build_all()
    print(f"# built {len(kcuda.KERNELS)} CUDA kernels in "
          f"{time.time()-t0:.1f}s")
    for k in kcuda.KERNELS.values():
        regs = [ln.split("ptxas info    : ")[-1]
                for ln in k.log_path().read_text().splitlines()
                if "registers" in ln]
        print(f"  {k.name}: {'; '.join(regs)}")

    if opts.points != POINTS:
        print(f"# CUT: {opts.points} points instead of the deployment's "
              f"{POINTS}")
    base_argv = [
        "--dataset", "crimes", "--points", str(opts.points),
        "--queries", str(QUERIES), "--selectivity", "5e-5",
        "--node-capacity", "128", "--batch", "512", "--max-visited", "64",
        "--wide-factor", "8", "--classifier", "mlp", "--device", "cuda"]
    args = serve.parse_args(base_argv + ["--sort", "hilbert", "--reps", "3"])
    t0 = time.time()
    idx = serve.build_index(args)
    print(f"# index built in {time.time()-t0:.1f}s")

    inserts = make_inserts()
    print("# kernels vs plain versions on the card:")
    rows = kernel_checks(idx, args, dev, inserts)

    # -- the range stream in Hilbert order (the reference's default)
    kcuda.reset_launch_counts()
    report, dt_s = serve.serve_stream(idx.hybrid, idx.workload, args)
    torch.cuda.synchronize()
    counts = {"range": kcuda.launch_counts()}
    mism = serve.report_stream(report, dt_s, idx)
    print(f"# launches over {1 + args.reps} range streams "
          f"({report.n_batches} narrow + {report.wide_batches} wide "
          f"batches each): {counts['range']}")
    for name in ("spatial_key", "traverse_fused", "leaf_refine",
                 "mlp_predict_compact", "forest_infer"):
        check(counts["range"][name] > 0,
              f"{name} never launched on the range stream")
    check(mism == 0, f"oracle: {mism} n_results mismatches vs labels")
    brute_force_check(idx, report, dev, 512, 512)
    rates = {"range (hilbert)": f"{report.n_queries / dt_s:.0f} queries/s"}
    schedule_cost(idx.workload.queries, args.batch, dev)

    # -- the same stream in arrival order: a comparison, not gated
    args_none = serve.parse_args(base_argv + ["--sort", "none",
                                              "--reps", "3"])
    rep_none, dt_none = serve.serve_stream(idx.hybrid, idx.workload,
                                           args_none)
    same = all(np.array_equal(getattr(report.stats, f),
                              getattr(rep_none.stats, f))
               for f in report.stats._fields)
    print(f"# arrival order (comparison): {rep_none.n_queries / dt_none:.0f}"
          f" queries/s against {report.n_queries / dt_s:.0f} in Hilbert "
          f"order; per-query stats {'identical' if same else 'DIFFER'}")
    rates["range (arrival order)"] = \
        f"{rep_none.n_queries / dt_none:.0f} queries/s"
    profile_stream("range (hilbert)",
                   serve.range_stream(idx.hybrid, idx.workload, args))
    profile_stream("range (arrival order)",
                   serve.range_stream(idx.hybrid, idx.workload, args_none))

    # -- kNN, join and point streams on the same index
    for qt in ("knn", "join", "point"):
        qargs = serve.parse_args(base_argv + [
            "--sort", "hilbert", "--reps", "1", "--query-type", qt])
        kcuda.reset_launch_counts()
        if qt == "point":
            out, mism = serve.serve_point(idx.hybrid, idx.points, qargs)
        else:
            fn = serve.serve_knn if qt == "knn" else serve.serve_join
            out, mism, _ = fn(idx.dtree, idx.points, qargs)
        torch.cuda.synchronize()
        counts[qt] = kcuda.launch_counts()
        print(f"# launches over 2 {qt} streams: {counts[qt]}")
        if qt == "point":
            profile_stream(qt, serve.point_stream(idx.hybrid, idx.points,
                                                  qargs)[-1])
        else:
            make = serve.knn_stream if qt == "knn" else serve.join_stream
            profile_stream(qt, make(idx.dtree, idx.points, qargs)[-1])
        check(mism == 0, f"{qt} oracle: {mism} mismatches")
        need = {"knn": ("spatial_key", "traverse_compact", "knn_browse"),
                "join": ("spatial_key", "traverse_compact", "leaf_refine"),
                "point": ("spatial_key", "traverse_fused", "leaf_refine",
                          "mlp_predict_compact", "forest_infer")}[qt]
        for name in need:
            check(counts[qt][name] > 0,
                  f"{name} never launched on the {qt} stream")
        if qt != "point":
            check(counts[qt]["traverse_fused"] == 0,
                  f"the {qt} stream built a dense [B, L] visited mask")
        rates[qt] = ", ".join(f"{v:.0f} {k}" for k, v in out.items())

    counts["mixed"], rates["mixed"] = mixed_stream(idx, base_argv, inserts,
                                                   dev)

    # -- the forest bank, then the open loop, on the same index
    fcounts, rates["forest"], frow = forest_phase(idx, base_argv, dev, card)
    counts.update(fcounts)
    rows.append(frow)
    ocounts, open_loop = open_loop_phase(idx, base_argv, dev)
    counts.update(ocounts)

    # -- the walk ladder's rungs, then the 40M-point index's streams
    counts["routing"] = routing_phase(idx, dev)
    if opts.large_points != LARGE_POINTS:
        print(f"# CUT: the large index holds {opts.large_points} points "
              f"instead of {LARGE_POINTS}")
    large, large_rates, large_row = large_index(dev, card, opts.large_points)
    counts["knn (large index)"] = large["knn"]
    counts["join (large index)"] = large["join"]
    rows.append(large_row)

    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in counts.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        check(r["launches"] > 0, f"{r['name']} never launched")

    st = report.stats
    ai = 100 * float(st.used_ai.mean())
    acc = float(st.leaf_accesses.mean())
    print("kernels: " + ", ".join(kcuda.KERNELS) + " (CUDA C++, sm_90a)")
    print(f"# serve on {card}: range {rates['range (hilbert)']} in Hilbert "
          f"order ({ai:.1f}% answered on the AI path, {acc:.2f} leaf "
          f"accesses/query; {rates['range (arrival order)']} in arrival "
          f"order); knn {rates['knn']}; join {rates['join']}; point "
          f"{rates['point']}; mixed {rates['mixed']} with {INSERTS} "
          f"inserts; forest bank {rates['forest']}; open loop at 1.5x "
          f"capacity: deadline formation {open_loop['deadline']}, full "
          f"{open_loop['full']} ({opts.points} points, batch {args.batch}); "
          f"on the {opts.large_points}-point index knn {large_rates['knn']}, "
          f"join {large_rates['join']}")
    print(f"# smoke finished in {time.time()-t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
