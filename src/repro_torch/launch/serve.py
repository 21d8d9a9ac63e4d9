"""Spatial serving driver: build an index and stream a full workload.

``python -m repro_torch.launch.serve --points 120000 --queries 4096 [...]``

End-to-end, on one device: synthesize the dataset → dynamic (Guttman)
R-tree build on the host → for range and point streams, workload
labelling on the R path and AI+R training (grid search + router) →
closed-loop streaming of the *entire* query workload through the spatial
batch scheduler (``core.schedule``, ``--sort hilbert`` by default): every
query is served exactly once, results are restored to submission order,
and rows that overflowed the narrow bounds are re-served on the wide
tier. Each stream closes with an oracle line.

``--query-type`` picks the stream: ``range`` (``hybrid_query``),
``point`` (degenerate rects through ``point_query``, exactness asserted),
``knn`` (distance browsing with a radius-doubling wide tier) or ``join``
(index-nested-loop spatial join with pair-slot tables). kNN and join
need only the R-tree. On ``--device cuda`` (the default) every stream
runs the CUDA kernels of its path; ``--device cpu`` runs their plain
PyTorch versions. ``--classifier`` picks the AI-tree's bank: ``mlp``
(the port's default until the engine is ported), ``knn`` (the default of
``repro.launch.serve``) or ``forest`` (per-cell oblivious decision trees,
the paper's classifier family, fit on the host).

Open-loop mode (``--arrival poisson|bursty|trace``, range stream only):
instead of draining the workload closed-loop, queries are stamped with
arrival times (``data.arrivals``) and served by the streaming runtime
(``core.runtime``) under per-query deadlines (``--rate``,
``--deadline-ms``, pinned to the capacity measured on the device when
0): continuous Hilbert batch formation with deadline-aware partial
dispatch and wide-tier gating (``--formation full`` keeps the
fixed-full-batch baseline). Reports latency p50/p95/p99, goodput and the
degraded-row accounting, plus the no-drop oracle.

Mixed read/write mode (``--insert-rate r``, range stream only): the last
``r`` of the points is held out of the build and staged as inserts
between query segments (``schedule.serve_mixed_workload`` over a
``monitor.FreshServer``): every batch probes the delta buffer (the
``delta_probe`` kernel on the card), the freshness guard demotes stale
cells to the exact R path, ``--repack-every N`` repacks once N points are
staged, and ``--policy default`` runs the maintenance loop (span-diff
repacks at ``--repack-at`` of ``--delta-cap``, ``--refit-chunk`` cell
refits per segment; a forest bank has no per-cell refit, so the server
gets no ``FitState`` and skips the refit chunks, counting them). The
oracle checks every query's result count against brute-force
containment over exactly the points visible to its segment, on the
stream's device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import build, device_tree as dt, joins, labels
from repro_torch.core import knn as knnlib, runtime, schedule
from repro_torch.core.geometry import torch_contains_point
from repro_torch.core.hybrid import HybridTree, hybrid_query, point_query
from repro_torch.core.monitor import DefaultPolicy, FreshServer
from repro_torch.core.rtree import RTree
from repro_torch.data import arrivals as arrv, synth


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="tweets", choices=("tweets",
                                                           "crimes"))
    p.add_argument("--points", type=int, default=120_000)
    p.add_argument("--queries", type=int, default=4096)
    p.add_argument("--selectivity", type=float, default=5e-5)
    p.add_argument("--node-capacity", type=int, default=128)
    p.add_argument("--classifier", default="mlp",
                   choices=("mlp", "knn", "forest"),
                   help="AI-tree bank (repro.launch.serve defaults to "
                        "knn)")
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions of the full stream")
    p.add_argument("--sort", default="hilbert", choices=schedule.SORT_MODES,
                   help="spatial batch scheduling curve (none = arrival "
                        "order)")
    p.add_argument("--max-visited", type=int, default=64,
                   help="narrow-tier R-path bound (overflow re-serves wide)")
    p.add_argument("--wide-factor", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda runs the CUDA kernels; cpu their plain "
                        "PyTorch versions")
    p.add_argument("--query-type", default="range",
                   choices=("range", "point", "knn", "join"),
                   help="serving path: range rects (default), point "
                        "lookups (degenerate rects, single-cell AI "
                        "routing, exactness asserted), kNN (distance "
                        "browsing with a radius-doubling wide tier), or "
                        "spatial join (index-nested-loop, pair-slot "
                        "tables)")
    p.add_argument("--knn-k", type=int, default=8,
                   help="neighbors per query for --query-type knn")
    p.add_argument("--knn-margin", type=float, default=2.0,
                   help="probe radius margin over the density estimate "
                        "(larger = fewer wide-tier re-serves)")
    p.add_argument("--join-pairs", type=int, default=16,
                   help="narrow-tier pair-slot width for --query-type "
                        "join")
    p.add_argument("--insert-rate", type=float, default=0.0,
                   help="fraction of points held out of the build and "
                        "staged as dynamic inserts during the stream")
    p.add_argument("--insert-every", type=int, default=4,
                   help="query batches per stream segment (inserts land "
                        "between segments)")
    p.add_argument("--repack-every", type=int, default=0,
                   help="online repack once this many inserts are staged "
                        "(0 = never; buffer must then hold them all)")
    p.add_argument("--delta-cap", type=int, default=8192,
                   help="delta store capacity (points)")
    p.add_argument("--arrival", default="closed",
                   choices=("closed", "poisson", "bursty", "trace"),
                   help="closed = drain the workload as fast as it serves "
                        "(the throughput harness); anything else stamps "
                        "arrival times and drives the open-loop runtime "
                        "(core.runtime) under per-query deadlines")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open-loop arrival rate, queries/s (0 = auto: "
                        "1.5x the measured serve capacity)")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="per-query deadline from arrival (0 = auto: 6x "
                        "the measured narrow+wide batch cost)")
    p.add_argument("--trace", default=None,
                   help="timestamp file for --arrival trace (.npy or one "
                        "float per line)")
    p.add_argument("--formation", default="deadline",
                   choices=("deadline", "full"),
                   help="open-loop batch formation: deadline-aware "
                        "partial dispatch, or fixed-full-batch baseline")
    p.add_argument("--policy", default="none", choices=("none", "default"),
                   help="between-segment maintenance policy: span-diff "
                        "repacks + stats-driven incremental refit chunks "
                        "(the refit chunks need a per-cell classifier: "
                        "knn or mlp)")
    p.add_argument("--refit-chunk", type=int, default=4,
                   help="max stale cells retrained per segment decision")
    p.add_argument("--repack-at", type=float, default=0.75,
                   help="policy repacks once the delta buffer passes this "
                        "fill fraction")
    args = p.parse_args(argv)
    if args.query_type != "range" and (args.insert_rate > 0
                                       or args.arrival != "closed"):
        p.error("--query-type point/knn/join drive the closed-loop "
                "read-only stream (no --insert-rate / --arrival)")
    return args


@dataclasses.dataclass
class Index:
    """Everything the build produced for one serving run."""
    points: np.ndarray          # the points in the tree
    extra: np.ndarray | None    # held-out inserts (``--insert-rate``)
    dtree: dt.DeviceTree
    workload: labels.Workload
    hybrid: HybridTree
    report: build.BuildReport


def build_tree(args: argparse.Namespace
               ) -> tuple[np.ndarray, dt.DeviceTree]:
    """Dataset → Guttman R-tree on the device over all points but the
    last ``--insert-rate`` of them, the held-out inserts (prints the
    reference's ``# dataset`` / ``# R-tree`` lines). Returns every point
    and the tree."""
    dev = resolve_device(args.device)
    gen = synth.tweets_like if args.dataset == "tweets" else synth.crimes_like
    pts = gen(args.points)
    base, extra = split_inserts(pts, args.insert_rate)
    print(f"# dataset {args.dataset}: {pts.shape[0]} points"
          + (f" ({extra.shape[0]} held out as inserts)"
             if extra is not None else ""))

    t0 = time.time()
    tree = RTree(max_entries=args.node_capacity).insert_all(base)
    dtree = dt.flatten(tree, device=dev)
    print(f"# R-tree: {dtree.n_leaves} leaves, height {dtree.height}, "
          f"built in {time.time()-t0:.1f}s")
    return pts, dtree


def split_inserts(pts: np.ndarray, rate: float
                  ) -> tuple[np.ndarray, np.ndarray | None]:
    """``(base, inserts)``: the last ``round(rate * N)`` points are the
    inserts (None when there are none), held out as
    ``repro.launch.serve`` holds them out."""
    n_ins = int(round(rate * pts.shape[0]))
    return (pts[:-n_ins], pts[-n_ins:]) if n_ins else (pts, None)


def build_index(args: argparse.Namespace) -> Index:
    """``build_tree`` → labels → ``fit_airtree`` (prints the reference's
    ``# workload`` / ``# AI+R`` lines too)."""
    pts, dtree = build_tree(args)
    qs = synth.synth_queries(pts, args.selectivity, args.queries,
                             device=args.device)
    wl = labels.make_workload(dtree, qs)
    print(f"# workload: mean α {wl.alpha.mean():.3f}, "
          f"mean visited {wl.n_visited.mean():.1f}")

    hyb, rep = build.fit_airtree(dtree, wl, kind=args.classifier,
                                 verbose=True)
    print(f"# AI+R: grid {rep.grid_size}², exact-fit {rep.exact_fit:.3f} "
          f"({int(rep.cell_fit.sum())}/{rep.cell_fit.size} cells exact), "
          f"router test acc {rep.router.test_acc:.3f}, "
          f"models {rep.model_bytes/1e6:.2f} MB")
    base, extra = split_inserts(pts, args.insert_rate)
    return Index(points=base, extra=extra, dtree=dtree, workload=wl,
                 hybrid=hyb, report=rep)


def make_serve_fns(hyb: HybridTree, args: argparse.Namespace):
    """(narrow_fn, wide_fn, trunc_field): ``hybrid_query`` closures with
    the narrow/wide bound split (the wide tier also widens
    ``max_results`` so its result-id gather cannot re-truncate)."""
    mv, mr = args.max_visited, 512

    def narrow(q):
        return hybrid_query(hyb, q, max_visited=mv, max_results=mr)

    def wide(q):
        return hybrid_query(hyb, q, max_visited=mv * args.wide_factor,
                            max_results=mr * args.wide_factor)

    return narrow, wide, "truncated"


def timed(run: Callable, reps: int):
    """Warm up with one call of ``run`` (one full stream: both tiers),
    then time ``reps`` calls, each ending on the host after every batch's
    results are copied back. Returns the last result and seconds per
    call."""
    out = run()
    t0 = time.time()
    for _ in range(reps):
        out = run()
    return out, (time.time() - t0) / max(reps, 1)


def _stream(narrow_fn: Callable, q: np.ndarray, args: argparse.Namespace,
            *, wide_fn=None, trunc_field=None) -> Callable:
    """A closure that serves the whole stream ``q`` once through the
    scheduler (``--sort`` curve over the frame of ``q``'s centres)."""
    bbox = schedule.workload_bbox(q)

    def run() -> schedule.ServeReport:
        return schedule.serve_workload(
            narrow_fn, q, batch=args.batch, sort=args.sort, bbox=bbox,
            wide_fn=wide_fn, trunc_field=trunc_field, device=args.device)
    return run


def range_stream(hyb: HybridTree, wl: labels.Workload,
                 args: argparse.Namespace) -> Callable:
    """The range stream: the workload through ``hybrid_query``, overflow
    re-served wide."""
    narrow_fn, wide_fn, trunc_field = make_serve_fns(hyb, args)
    return _stream(narrow_fn, wl.queries, args, wide_fn=wide_fn,
                   trunc_field=trunc_field)


def serve_stream(hyb: HybridTree, wl: labels.Workload,
                 args: argparse.Namespace
                 ) -> tuple[schedule.ServeReport, float]:
    """The range stream, warmed and timed (``timed``)."""
    return timed(range_stream(hyb, wl, args), args.reps)


def report_stream(report: schedule.ServeReport, dt_s: float,
                  idx: Index) -> int:
    """Print the ``# stream`` / ``# serve`` / ``# AI path`` / ``# oracle``
    lines; returns the oracle's mismatch count against the labels."""
    st = report.stats
    acc = float(np.asarray(st.leaf_accesses).mean())
    ai = float(np.asarray(st.used_ai).mean())
    resid = int(np.asarray(st.truncated).sum())
    print(f"# stream: {report.n_queries} queries in {report.n_batches} "
          f"batches (sort={report.sort}), {report.n_reserved} re-served "
          f"wide ({report.wide_batches} batches), {resid} still truncated")
    print(f"# serve: {report.n_queries/dt_s:.0f} queries/s, "
          f"{acc:.2f} leaf accesses/query, "
          f"{100*ai:.1f}% answered by the AI path")
    k = idx.hybrid.ait.max_pred
    L = idx.dtree.n_leaves
    dense_b = report.n_queries * L * 4
    slot_b = report.n_queries * (k + 1) * 4
    kind = idx.hybrid.ait.kind
    if kind != "mlp":
        verdict = (f"still materialized (the {kind} bank has no fused "
                   "prediction kernel)")
    elif idx.dtree.device.type == "cuda":
        verdict = "eliminated (fused CUDA prediction kernel)"
    else:
        verdict = "still materialized on the CPU (plain PyTorch version)"
    print(f"# AI path: {slot_b/1e3:.0f} KB compact slot tables; "
          f"{dense_b/1e6:.1f} MB dense [B, {L}] score tables {verdict}")
    # no-drop oracle: the labelling pass already executed every query
    mism = int(np.sum(np.asarray(st.n_results) != idx.workload.n_results))
    print(f"# oracle: {mism} / {report.n_queries} n_results mismatches "
          f"vs workload labels")
    return mism


def _inside_chunks(points: np.ndarray, rects: np.ndarray, device,
                   chunk: int = 256):
    """Yield ``(offset, inside [n, P] bool)``: closed-rect f32
    containment of every point, ``chunk`` rects at a time (fewer when
    ``chunk * P`` would pass ``knn.BRUTE_CELLS``), on ``device`` — the
    brute-force oracles' containment."""
    dev = resolve_device(device)
    p = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    r = torch.from_numpy(np.asarray(rects, np.float32)).to(dev)
    chunk = max(1, min(chunk, knnlib.BRUTE_CELLS // max(p.shape[0], 1)))
    for o in range(0, r.shape[0], chunk):
        yield o, torch_contains_point(r[o:o + chunk, None, :], p[None])


def knn_stream(dtree: dt.DeviceTree, pts: np.ndarray,
               args: argparse.Namespace
               ) -> tuple[np.ndarray, float, Callable]:
    """The kNN stream: ``(centres, radius, run)``, centres drawn from the
    points, the probe radius from the density estimate, and a closure
    serving the stream once with the radius-doubling wide tier."""
    rng = np.random.default_rng(0)
    centers = pts[rng.integers(0, pts.shape[0], args.queries)].astype(
        np.float32)
    r = knnlib.default_radius(dtree, args.knn_k, margin=args.knn_margin)
    narrow, wide = knnlib.make_knn_steps(
        dtree, k=args.knn_k, radius=r, max_visited=args.max_visited,
        wide_factor=args.wide_factor)
    return centers, r, _stream(
        narrow, np.concatenate([centers, centers], axis=1), args,
        wide_fn=wide, trunc_field="truncated")


def serve_knn(dtree: dt.DeviceTree, pts: np.ndarray,
              args: argparse.Namespace) -> tuple[dict, int, int]:
    """kNN stream: distance browsing at a density-derived radius, with
    the radius-doubling wide tier re-serving flagged rows; the port's
    brute-force oracle checks a sample bit for bit. Returns the stream's
    rate, the oracle's mismatch count and the sampled rows it compared."""
    centers, r, run = knn_stream(dtree, pts, args)
    report, dt_s = timed(run, args.reps)
    st = report.stats
    trunc = np.asarray(st.truncated)
    acc = float(np.asarray(st.leaf_accesses).mean())
    print(f"# knn stream: k={args.knn_k}, radius {r:.4g} "
          f"(margin {args.knn_margin}), {report.n_queries} queries in "
          f"{report.n_batches} batches (sort={report.sort}), "
          f"{report.n_reserved} re-served at 2x radius, {int(trunc.sum())} "
          f"still truncated (flagged, never approximate)")
    kd = np.sqrt(np.asarray(st.neighbor_d2)[:, -1][~trunc].mean())
    print(f"# serve: {report.n_queries/dt_s:.0f} queries/s, "
          f"{acc:.2f} leaf accesses/query, mean k-distance {kd:.4g}")
    # oracle: sampled rows vs all-pairs brute kNN on the stream's device —
    # d2 bit for bit (both round dx*dx, dy*dy and their sum separately);
    # truncated rows match on the in-radius prefix, and rows whose visited
    # set overflowed even the wide slot table are flagged, not compared.
    # Ids are compared on exact rows whose k + 1 nearest distances are
    # distinct (a tie at the k-th leaves the id set open)
    k = args.knn_k
    m = min(256, centers.shape[0])
    idx = np.random.default_rng(0).choice(centers.shape[0], m,
                                          replace=False)
    bd2, bids = knnlib.knn_brute(pts, centers[idx], k + 1,
                                 device=args.device)
    got = np.asarray(st.neighbor_d2)[idx]
    got_ids = np.asarray(st.neighbor_ids)[idx]
    nw = np.asarray(st.n_within)[idx]
    over = (np.asarray(st.n_visited) > np.asarray(st.leaf_accesses))[idx]
    mism = id_rows = id_mism = 0
    for j in np.flatnonzero(~over):
        exact = not trunc[idx[j]]
        kk = k if exact else min(int(nw[j]), k)
        mism += int(not np.array_equal(got[j, :kk], bd2[j, :kk]))
        if exact and bool((np.diff(bd2[j]) > 0).all()):
            id_rows += 1
            id_mism += int(not np.array_equal(got_ids[j], bids[j, :k]))
    print(f"# oracle: {mism} / {m - int(over.sum())} sampled rows mismatch "
          f"brute-force k-distances (bit-exact; {int(over.sum())} "
          f"overflowed rows flagged), {id_mism} / {id_rows} exact rows "
          f"with distinct distances mismatch brute-force ids")
    return ({"queries/s": report.n_queries / dt_s}, mism + id_mism,
            m - int(over.sum()))


def join_stream(dtree: dt.DeviceTree, pts: np.ndarray,
                args: argparse.Namespace) -> tuple[np.ndarray, Callable]:
    """The join stream: ``(outer, run)``, the outer rects (the range
    workload's generator) and a closure running the two-tier join once."""
    outer = synth.synth_queries(pts, args.selectivity, args.queries,
                                device=args.device)

    def run() -> joins.JoinReport:
        return joins.spatial_join(
            dtree, outer, batch=args.batch, max_pairs=args.join_pairs,
            max_visited=args.max_visited, sort=args.sort,
            wide_factor=args.wide_factor, device=args.device)
    return outer, run


def serve_join(dtree: dt.DeviceTree, pts: np.ndarray,
               args: argparse.Namespace) -> tuple[dict, int, int]:
    """Spatial join stream: index-nested-loop over the compacting
    traversal, pairs through the pair-slot tables; sampled outer rows'
    pair sets are checked against brute-force containment on the
    stream's device. Returns the stream's rates, the oracle's mismatch
    count and the sampled (not truncated) rows it compared."""
    outer, run = join_stream(dtree, pts, args)
    rep, dt_s = timed(run, args.reps)
    print(f"# join stream: {rep.n_outer} outer rects x {pts.shape[0]} "
          f"points -> {rep.n_pairs} pairs "
          f"({rep.n_pairs/max(rep.n_outer,1):.1f}/outer) in "
          f"{rep.n_batches} batches (sort={rep.sort}), {rep.n_reserved} "
          f"re-served wide, {rep.residual_truncated} still truncated")
    print(f"# serve: {rep.n_outer/dt_s:.0f} outer rows/s, "
          f"{rep.n_pairs/dt_s:.0f} pairs/s")
    # oracle: sampled outer rows' pair sets vs dense containment; rows the
    # wide tier still truncated are excluded (flagged above)
    m = min(256, outer.shape[0])
    idx = np.random.default_rng(0).choice(outer.shape[0], m, replace=False)
    idx = idx[~np.asarray(rep.stats.truncated).astype(bool)[idx]]
    got = {(int(o), int(pj)) for o, pj in
           rep.pairs[np.isin(rep.pairs[:, 0], idx)]}
    brute = set()
    for o, inside in _inside_chunks(pts, outer[idx], args.device):
        oi, pj = torch.nonzero(inside, as_tuple=True)
        brute |= {(int(idx[o + a]), int(b))
                  for a, b in zip(oi.tolist(), pj.tolist())}
    mism = len(got ^ brute)
    print(f"# oracle: {mism} pair mismatches vs brute-force containment "
          f"over {idx.size} sampled outer rows")
    return ({"outer rows/s": rep.n_outer / dt_s,
             "pairs/s": rep.n_pairs / dt_s}, mism, int(idx.size))


def point_stream(hyb: HybridTree, base: np.ndarray,
                 args: argparse.Namespace) -> tuple[np.ndarray, Callable]:
    """The point stream: ``(q, run)``, degenerate rects at dataset points
    and a closure serving them once through ``point_query`` (no wide
    tier)."""
    rng = np.random.default_rng(0)
    ppts = base[rng.integers(0, base.shape[0], args.queries)].astype(
        np.float32)
    q = np.concatenate([ppts, ppts], axis=1)
    return q, _stream(lambda qq: point_query(hyb, qq), q, args)


def serve_point(hyb: HybridTree, base: np.ndarray,
                args: argparse.Namespace) -> tuple[dict, int]:
    """Point-query stream: degenerate rects at dataset points served
    with single-cell AI routing and narrowed bounds — no wide tier, so
    exactness is asserted (zero truncated rows) instead of re-served.
    Returns the stream's rate and the oracle's mismatch count."""
    q, run = point_stream(hyb, base, args)
    report, dt_s = timed(run, args.reps)
    st = report.stats
    resid = int(np.asarray(st.truncated).sum())
    acc = float(np.asarray(st.leaf_accesses).mean())
    ai = float(np.asarray(st.used_ai).mean())
    print(f"# point stream: {report.n_queries} degenerate-rect queries "
          f"in {report.n_batches} batches (sort={report.sort}), "
          f"single-cell AI routing, no wide tier")
    print(f"# serve: {report.n_queries/dt_s:.0f} queries/s, "
          f"{acc:.2f} leaf accesses/query, {100*ai:.1f}% AI path")
    # the narrowed bounds must cover every row — a truncated point query
    # would be silently wrong, so this is a hard failure, not a re-serve
    if resid:
        raise RuntimeError(f"{resid} truncated point queries")
    # containment in f32: a degenerate rect contains only the points that
    # are bit-equal to it at that precision
    got = np.asarray(st.n_results)
    mism = 0
    for o, inside in _inside_chunks(base, q, args.device):
        exp = inside.sum(dim=1).cpu().numpy()
        mism += int(np.sum(exp != got[o:o + exp.shape[0]]))
    print(f"# oracle: 0 truncated (exactness asserted); {mism} / "
          f"{report.n_queries} n_results mismatches vs brute-force "
          f"containment")
    return {"queries/s": report.n_queries / dt_s}, mism


def make_fresh_server(idx: Index, args: argparse.Namespace
                      ) -> FreshServer:
    """The mixed stream's server on the index's device. ``--policy
    default`` turns on the maintenance loop (span-diff repacks and
    incremental ``refit_cells`` chunks between segments) with the build's
    ``FitState``. A forest bank gets no ``FitState``: repack, demote and
    promote still run, and the server skips the refit chunks, prints its
    one-time notice and counts the skips on each decision
    (``MaintenanceDecision.refit_skipped``)."""
    fit_state = policy = None
    if args.policy != "none":
        policy = DefaultPolicy(refit_chunk=args.refit_chunk,
                               repack_at=args.repack_at)
        if idx.hybrid.ait.kind != "forest":
            fit_state = idx.report.fit_state
    return FreshServer(idx.points, idx.hybrid, delta_cap=args.delta_cap,
                       max_visited=args.max_visited, max_results=512,
                       wide_factor=args.wide_factor, fit_state=fit_state,
                       policy=policy)


def mixed_oracle(mixed: schedule.MixedReport, base: np.ndarray,
                 queries: np.ndarray, device, id_rows: np.ndarray = ()
                 ) -> tuple[int, int, int]:
    """Brute force over each segment's visible points
    (``schedule.visible_segments``) on ``device``: ``(n_results
    mismatches over every query, id-set mismatches, rows compared)`` —
    id sets are compared on the ``id_rows`` whose true count fits the
    result table and whose row is not flagged truncated. A visible
    point's index is its global id (inserts continue the numbering)."""
    st = mixed.stats
    got = np.asarray(st.n_results)
    trunc = np.asarray(st.truncated).astype(bool)
    mr = np.asarray(st.result_ids).shape[1]
    want_ids = set(int(i) for i in id_rows)
    mism = id_mism = n_rows = 0
    for (lo, hi), visible in schedule.visible_segments(mixed, base):
        for o, inside in _inside_chunks(visible, queries[lo:hi], device):
            n = inside.sum(dim=1).cpu().numpy()
            q0 = lo + o
            mism += int(np.sum(n != got[q0:q0 + n.shape[0]]))
            for j in range(n.shape[0]):
                qi = q0 + j
                if qi not in want_ids or trunc[qi] or n[j] > mr:
                    continue
                n_rows += 1
                ids = st.result_ids[qi]
                want = set(torch.nonzero(inside[j]).flatten().tolist())
                id_mism += int(set(ids[ids >= 0].tolist()) != want)
    return mism, id_mism, n_rows


def serve_mixed(idx: Index, extra: np.ndarray, args: argparse.Namespace,
                server: FreshServer | None = None
                ) -> tuple[schedule.MixedReport, FreshServer, float, int]:
    """Drive the mixed read/write stream (the range workload with
    ``extra`` staged between segments), print the reference's ``# mixed
    stream`` / ``# serve`` / ``# freshness`` (/ ``# policy`` /
    ``# recovery``) lines and the per-segment brute-force ``# oracle``.
    Returns ``(report, server, seconds, oracle mismatches)``."""
    server = server if server is not None else make_fresh_server(idx, args)
    wl = idx.workload
    t0 = time.time()
    mixed = schedule.serve_mixed_workload(
        server, wl.queries, extra, batch=args.batch, sort=args.sort,
        bbox=schedule.workload_bbox(wl.queries),
        insert_every=args.insert_every, repack_every=args.repack_every)
    dt_s = time.time() - t0
    st = mixed.stats
    fs = server.stats()
    acc = float(st.leaf_accesses.mean())
    ai = float(st.used_ai.mean())
    guarded = float(st.guarded.mean())
    d_hits = int(st.delta_hits.sum())
    resid = int(np.asarray(getattr(st, server.trunc_field)).sum())
    print(f"# mixed stream: {mixed.n_queries} queries / {mixed.n_inserts} "
          f"inserts in {mixed.n_segments} segments ({mixed.n_batches} "
          f"batches, sort={mixed.sort}), {mixed.n_repacks} repacks, "
          f"{mixed.n_reserved} re-served wide, {resid} still truncated")
    print(f"# serve: {mixed.n_queries/dt_s:.0f} queries/s, "
          f"{acc:.2f} leaf accesses/query, {100*ai:.1f}% AI path, "
          f"{100*guarded:.1f}% guard-demoted, {d_hits} delta hits")
    print(f"# freshness: {fs.ok_cells}/{fs.n_cells} cells serve-eligible "
          f"({fs.fit_cells} exact-fit, {fs.stale_cells} stale, "
          f"{fs.demoted_cells} demoted), delta "
          f"fill {fs.delta_fill}/{server.delta.capacity}, "
          f"{fs.n_repacks} repacks")
    if server.policy is not None:
        n_prep = sum(d.repack for _, d in mixed.maintenance)
        n_ref = sum(r.cells_refit for r in server.refits)
        n_dem = sum(d.demote.size for _, d in mixed.maintenance)
        n_pro = sum(d.promote.size for _, d in mixed.maintenance)
        n_skip = sum(d.refit_skipped for _, d in mixed.maintenance)
        print(f"# policy: {n_prep} repacks, {n_ref} cell refits "
              f"({n_skip} skipped), {n_dem} demotions, {n_pro} promotions "
              f"across {len(mixed.maintenance)} segment decisions")
        # recovery curve: guard/AI rates per segment show the AI path
        # coming back chunk by chunk after each span-diff repack
        curve = "  ".join(
            f"{s}:{st.guarded[lo:hi].mean():.2f}/"
            f"{st.used_ai[lo:hi].mean():.2f}"
            for s, (lo, hi) in enumerate(mixed.seg_bounds))
        print(f"# recovery (seg:guarded/used_ai): {curve}")
    mism, _, _ = mixed_oracle(mixed, idx.points, wl.queries, args.device)
    print(f"# oracle: {mism} / {mixed.n_queries} n_results mismatches vs "
          f"per-segment brute-force containment")
    return mixed, server, dt_s, mism


def measure_capacity(narrow_fn: Callable, wide_fn: Callable,
                     queries: np.ndarray, args: argparse.Namespace
                     ) -> dict:
    """Median seconds of one narrow and one wide step on the first
    ``--batch`` queries (one warm-up call each, then 3 timed calls, the
    device synchronized before and after each)."""
    dev = resolve_device(args.device)
    qb = torch.from_numpy(np.asarray(queries[:args.batch],
                                     np.float32)).to(dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ts = {}
    for name, fn in (("narrow", narrow_fn), ("wide", wide_fn)):
        fn(qb)
        reps = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn(qb)
            sync()
            reps.append(time.perf_counter() - t0)
        ts[name] = float(np.median(reps))
    return ts


def serve_open_loop(narrow_fn: Callable, wide_fn: Callable,
                    trunc_field: str, wl: labels.Workload,
                    args: argparse.Namespace
                    ) -> tuple[runtime.RuntimeReport, int]:
    """Open-loop serving: stamp arrivals, drive ``runtime.run_stream``,
    report the latency/goodput/degraded accounting plus the no-drop
    oracle (every non-degraded row exact against the workload labels).
    The auto rate and deadline are pinned to the step costs measured on
    the device (``measure_capacity``). Returns the runtime's report and
    the oracle's mismatch count."""
    q = wl.queries
    ts = measure_capacity(narrow_fn, wide_fn, q, args)
    cap_qps = args.batch / (ts["narrow"] + ts["wide"])
    rate = args.rate if args.rate > 0 else 1.5 * cap_qps
    deadline_s = (args.deadline_ms / 1e3 if args.deadline_ms > 0
                  else 6.0 * (ts["narrow"] + ts["wide"]))
    arr = arrv.make_arrivals(args.arrival, q.shape[0], rate,
                             trace=args.trace)
    print(f"# open loop: {args.arrival} arrivals at {rate:.0f} qps "
          f"({rate/cap_qps:.2f}x measured capacity {cap_qps:.0f} qps), "
          f"deadline {deadline_s*1e3:.1f} ms, formation={args.formation}")
    rep = runtime.run_stream(
        narrow_fn, q, arr, batch=args.batch, deadline_s=deadline_s,
        sort=args.sort, wide_fn=wide_fn, trunc_field=trunc_field,
        formation=args.formation, device=args.device)
    lat = rep.telemetry["latency_s"]
    depth = rep.telemetry["queue_depth"]
    print(f"# stream: {rep.n_queries} queries in {rep.n_batches} batches "
          f"(+{rep.n_wide_batches} wide), mean fill "
          f"{100*rep.mean_fill:.0f}%, queue depth p95 {depth['p95']:.0f}")
    print(f"# latency: p50 {lat['p50']*1e3:.1f} ms, "
          f"p95 {lat['p95']*1e3:.1f} ms, p99 {lat['p99']*1e3:.1f} ms")
    print(f"# goodput: {100*rep.goodput:.1f}% exact-and-on-time "
          f"({rep.n_missed} missed deadline, {rep.n_degraded} degraded "
          f"to best-effort narrow — flagged, never dropped)")
    # no-drop oracle: every query completed after it arrived, and every
    # non-degraded row's count matches the labelling pass exactly
    if not np.all(rep.done_s > rep.arrival_s):
        raise RuntimeError("a query completed before it arrived")
    got = np.asarray(rep.stats.n_results)
    ok = ~rep.degraded
    mism = int(np.sum(got[ok] != wl.n_results[ok]))
    print(f"# oracle: 0 dropped; {mism} / {int(ok.sum())} "
          f"non-degraded n_results mismatches vs workload labels"
          + (f"; {rep.n_degraded} degraded rows carry their truncation "
             f"flag" if rep.n_degraded else ""))
    return rep, mism


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.query_type in ("knn", "join"):     # the R-tree is all they need
        pts, dtree = build_tree(args)
        serve = serve_knn if args.query_type == "knn" else serve_join
        serve(dtree, pts, args)
        return
    idx = build_index(args)
    if args.query_type == "point":
        serve_point(idx.hybrid, idx.points, args)
        return
    if idx.extra is not None:
        serve_mixed(idx, idx.extra, args)
        return
    if args.arrival != "closed":
        narrow_fn, wide_fn, trunc_field = make_serve_fns(idx.hybrid, args)
        serve_open_loop(narrow_fn, wide_fn, trunc_field, idx.workload, args)
        return
    report, dt_s = serve_stream(idx.hybrid, idx.workload, args)
    report_stream(report, dt_s, idx)


if __name__ == "__main__":
    main()
