"""Spatial serving driver: build an AI+R-tree and stream a full workload.

``python -m repro_torch.launch.serve --points 120000 --queries 4096 [...]``

End-to-end, on one device: synthesize the dataset → dynamic (Guttman)
R-tree build on the host → workload labelling on the R path → AI+R
training (grid search + router) → closed-loop streaming of the *entire*
query workload through the batch scheduler (``core.schedule``): every
query is served exactly once through ``hybrid_query``, results are
restored to submission order, and rows that overflowed the narrow R-path
bound are re-served on the wide tier. Reports aggregate stats over the
whole stream plus an oracle check that no query was dropped.

On ``--device cuda`` (the default) the serving path runs the four CUDA
kernels (fused traversal, leaf refinement, fused MLP prediction, router
forest); ``--device cpu`` runs their plain PyTorch versions. This port
serves range queries, closed loop, with the MLP bank and arrival-order
batches (``--sort none``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import build, device_tree as dt, labels, schedule
from repro_torch.core.hybrid import HybridTree, hybrid_query
from repro_torch.core.rtree import RTree
from repro_torch.data import synth


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="tweets", choices=("tweets",
                                                           "crimes"))
    p.add_argument("--points", type=int, default=120_000)
    p.add_argument("--queries", type=int, default=4096)
    p.add_argument("--selectivity", type=float, default=5e-5)
    p.add_argument("--node-capacity", type=int, default=128)
    p.add_argument("--classifier", default="mlp", choices=("mlp",))
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions of the full stream")
    p.add_argument("--sort", default="none", choices=("none",),
                   help="batch order (none = arrival order; the "
                        "Hilbert/Morton curves come with the spatial_key "
                        "kernel)")
    p.add_argument("--max-visited", type=int, default=64,
                   help="narrow-tier R-path bound (overflow re-serves wide)")
    p.add_argument("--wide-factor", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda runs the CUDA kernels; cpu their plain "
                        "PyTorch versions")
    return p.parse_args(argv)


@dataclasses.dataclass
class Index:
    """Everything the build produced for one serving run."""
    points: np.ndarray
    dtree: dt.DeviceTree
    workload: labels.Workload
    hybrid: HybridTree
    report: build.BuildReport


def build_index(args: argparse.Namespace) -> Index:
    """Dataset → Guttman R-tree → labels → ``fit_airtree`` (prints the
    reference's ``# dataset`` / ``# R-tree`` / ``# workload`` / ``# AI+R``
    lines)."""
    dev = resolve_device(args.device)
    gen = synth.tweets_like if args.dataset == "tweets" else synth.crimes_like
    pts = gen(args.points)
    print(f"# dataset {args.dataset}: {pts.shape[0]} points")

    t0 = time.time()
    tree = RTree(max_entries=args.node_capacity).insert_all(pts)
    dtree = dt.flatten(tree, device=dev)
    print(f"# R-tree: {dtree.n_leaves} leaves, height {dtree.height}, "
          f"built in {time.time()-t0:.1f}s")

    qs = synth.synth_queries(pts, args.selectivity, args.queries)
    wl = labels.make_workload(dtree, qs)
    print(f"# workload: mean α {wl.alpha.mean():.3f}, "
          f"mean visited {wl.n_visited.mean():.1f}")

    hyb, rep = build.fit_airtree(dtree, wl, kind=args.classifier,
                                 verbose=True)
    print(f"# AI+R: grid {rep.grid_size}², exact-fit {rep.exact_fit:.3f} "
          f"({int(rep.cell_fit.sum())}/{rep.cell_fit.size} cells exact), "
          f"router test acc {rep.router.test_acc:.3f}, "
          f"models {rep.model_bytes/1e6:.2f} MB")
    return Index(points=pts, dtree=dtree, workload=wl, hybrid=hyb,
                 report=rep)


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


def serve_stream(hyb: HybridTree, wl: labels.Workload,
                 args: argparse.Namespace
                 ) -> tuple[schedule.ServeReport, float]:
    """Warm both tiers with one full stream, then time ``--reps`` full
    streams (each ends on the host, after every batch's results are
    copied back). Returns the last report and seconds per stream."""
    dev = resolve_device(args.device)
    narrow_fn, wide_fn, trunc_field = make_serve_fns(hyb, args)

    def stream():
        return schedule.serve_workload(
            narrow_fn, wl.queries, batch=args.batch, sort=args.sort,
            bbox=schedule.workload_bbox(wl.queries), wide_fn=wide_fn,
            trunc_field=trunc_field, device=dev)

    report = stream()
    t0 = time.time()
    for _ in range(args.reps):
        report = stream()
    return report, (time.time() - t0) / max(args.reps, 1)


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
    verdict = ("eliminated (fused CUDA prediction kernel)"
               if idx.dtree.device.type == "cuda" else
               "still materialized on the CPU (plain PyTorch version)")
    print(f"# AI path: {slot_b/1e3:.0f} KB compact slot tables; "
          f"{dense_b/1e6:.1f} MB dense [B, {L}] score tables {verdict}")
    # no-drop oracle: the labelling pass already executed every query
    mism = int(np.sum(np.asarray(st.n_results) != idx.workload.n_results))
    print(f"# oracle: {mism} / {report.n_queries} n_results mismatches "
          f"vs workload labels")
    return mism


def main(argv=None) -> None:
    args = parse_args(argv)
    idx = build_index(args)
    report, dt_s = serve_stream(idx.hybrid, idx.workload, args)
    report_stream(report, dt_s, idx)


if __name__ == "__main__":
    main()
