#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py                  # the deployment below
    python3 chip_smoke.py --points 100000  # a cut (printed as such)

Phases, each failing the run (non-zero exit) on its own error:

1. print the card's name and power limit (``nvidia-smi``);
2. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. build the serving index through ``repro_torch.launch.serve`` at the
   Chicago Crimes scale of the paper (872K points, node capacity 128,
   4096 queries at selectivity 5e-5, MLP bank);
4. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it plus edge rows, and time both;
5. stream the workload through ``hybrid_query`` (batch 512, narrow
   ``max_visited`` 64, wide tier x8, arrival order) with every launch
   count reset just before and read just after; check the ``# oracle``
   against the workload labels and 512 sampled queries against f32
   brute-force containment;
6. print the ``kernels:`` line, the serving rates beside the card, the
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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
NEAR = 1e-5                      # MLP scores this close to the threshold
#                                  may flip between kernel and plain
TIMING_REPS = 30


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
    Falls back to ``event_ms`` when the profiler records no device
    activity; the second value names the source."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = cuda_events(prof, match)
    if not ev:
        return event_ms(fn, reps), "cuda-events"
    return sum(e.time_range.elapsed_us() for e in ev) / reps / 1e3, "cupti"


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(idx, args, dev) -> list:
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
        b, by = bound_ms(n_bytes, n_ops)
        k = kcuda.KERNELS[name]
        ms, src = device_ms(launch, f"{name}_kernel")
        plain_ms, psrc = device_ms(plain)
        print(f"  {name}: {mism} mismatches, kernel {ms:.4f} ms ({src}; "
              f"{event_ms(launch):.4f} ms between events), plain "
              f"{plain_ms:.4f} ms ({psrc}; {event_ms(plain):.4f} ms between "
              f"events), bound {b:.4f} ms ({by})")
        rows.append({"name": name, "route": "cuda",
                     "source": str(k.source.relative_to(ROOT)),
                     "replaces": k.replaces, "launches": 0,
                     "max_abs_err": max_abs_err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": None})

    # -- traverse_fused: dense visited mask of one batch
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    launch, vis = ops.prepare("traverse_fused", q, mb, pa)
    launch()
    want = ref.traverse_fused(q, mb, pa)
    mism = int((vis != want).sum())
    check(mism == 0, f"traverse_fused: {mism} mismatches")
    check(not bool(vis[0].any()), "traverse_fused: empty row visits leaves")
    n_int = sum(int(m.shape[0]) for m in mb[:-1])
    L = tree.n_leaves
    row("traverse_fused", mism, launch,
        lambda: ref.traverse_fused(q, mb, pa),
        B * 16 + n_int * 20 + L * 20 + B * L, B * (n_int + L) * 4)

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
    row("leaf_refine", mism, launch,
        lambda: ref.leaf_refine(q, ex, ey, safe, valid),
        B * 16 + B * K * 5 + n_valid * M * 8 + B * K * M,
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
    return rows


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
    rng = np.random.default_rng(0)
    Q = idx.workload.n_queries
    sample = rng.choice(Q, min(n_sample, Q), replace=False)
    pts = torch.from_numpy(idx.points.astype(np.float32)).to(dev)
    st = report.stats
    mism_n = mism_ids = 0
    for o in range(0, sample.size, 64):
        s = sample[o:o + 64]
        qq = torch.from_numpy(idx.workload.queries[s]).to(dev)
        inside = ((pts[None, :, 0] >= qq[:, None, 0])
                  & (pts[None, :, 0] <= qq[:, None, 2])
                  & (pts[None, :, 1] >= qq[:, None, 1])
                  & (pts[None, :, 1] <= qq[:, None, 3]))
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


def profile_stream(idx, args, dev) -> None:
    """One more full stream under ``torch.profiler`` (device activity
    only): wall time, device busy share, and the device time by kernel,
    the four ported kernels' share among it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import schedule
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    narrow, wide, trunc = serve.make_serve_fns(idx.hybrid, args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = schedule.serve_workload(
            narrow, idx.workload.queries, batch=args.batch, sort=args.sort,
            wide_fn=wide, trunc_field=trunc, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in cuda_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    if not by_name:
        print("# profile of one stream: the profiler recorded no device "
              "activity (device busy share not measured)")
        return
    busy = sum(by_name.values())
    ours = sum(v for n, v in by_name.items()
               if any(f"{k}_kernel" in n for k in kcuda.KERNELS))
    n_b = rep.n_batches + rep.wide_batches
    print(f"# profile of one stream ({n_b} batches, CUPTI): wall "
          f"{wall:.2f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%), "
          f"the four CUDA kernels {ours:.3f} ms "
          f"({100 * ours / max(busy, 1e-9):.1f}% of busy), "
          f"{len(cuda_events(prof))} device activities")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:100]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="chip smoke of repro_torch")
    p.add_argument("--points", type=int, default=POINTS,
                   help="dataset size (a cut below the deployment's "
                        f"{POINTS} is printed as such)")
    opts = p.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no src/repro_torch under {ROOT})", file=sys.stderr)
        return 2
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
    args = serve.parse_args([
        "--dataset", "crimes", "--points", str(opts.points),
        "--queries", "4096", "--selectivity", "5e-5",
        "--node-capacity", "128", "--batch", "512", "--max-visited", "64",
        "--wide-factor", "8", "--classifier", "mlp", "--sort", "none",
        "--reps", "3", "--device", "cuda"])
    t0 = time.time()
    idx = serve.build_index(args)
    print(f"# index built in {time.time()-t0:.1f}s")

    print("# kernels vs plain versions on the card:")
    rows = kernel_checks(idx, args, dev)

    kcuda.reset_launch_counts()
    report, dt_s = serve.serve_stream(idx.hybrid, idx.workload, args)
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    mism = serve.report_stream(report, dt_s, idx)
    n_streams = 1 + args.reps
    print(f"# launches over {n_streams} streams "
          f"({report.n_batches} narrow + {report.wide_batches} wide "
          f"batches each): {counts}")
    for r in rows:
        r["launches"] = counts[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never launched on the stream")
    check(mism == 0, f"oracle: {mism} n_results mismatches vs labels")
    brute_force_check(idx, report, dev, 512, 512)
    profile_stream(idx, args, dev)

    st = report.stats
    qps = report.n_queries / dt_s
    ai = 100 * float(st.used_ai.mean())
    acc = float(st.leaf_accesses.mean())
    print("kernels: " + ", ".join(kcuda.KERNELS) + " (CUDA C++, sm_90a)")
    print(f"# serve on {card}: {qps:.0f} queries/s, {ai:.1f}% answered on "
          f"the AI path, {acc:.2f} leaf accesses/query "
          f"({opts.points} points, batch {args.batch})")
    print(f"# smoke finished in {time.time()-t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
