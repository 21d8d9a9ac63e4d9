"""End-to-end "AI+R"-tree construction for a (data, query) workload.

Implements the paper's training protocol for the MLP bank:
  * execute the workload on the R-tree to collect (visited, true) labels
    (``labels.make_workload``, done by the caller);
  * hill-climb the grid size (2×2 → max, §III-B / §V-B3) until the cell
    models reach the best exact fit on the training workload;
  * train the binary router on an 80/20 split (§V-C2);
  * assemble the hybrid structure, with the per-cell exact-fit flags wired
    into the serving guard (``AITree.cell_ok``).

Everything lives on the device of the ``DeviceTree`` it is given. The
incremental refit state (``FitState``, ``refit_cells``) is not ported yet:
``BuildReport.fit_state`` is ``None``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import celldata, grid as gridlib, labels
from repro_torch.core.aitree import ai_query, make_aitree
from repro_torch.core.classifiers import mlp as mlplib
from repro_torch.core.classifiers.router import train_router, RouterReport
from repro_torch.core.device_tree import DeviceTree
from repro_torch.core.hybrid import HybridTree


@dataclasses.dataclass
class BuildReport:
    grid_sizes_tried: list
    grid_size: int
    exact_fit: float
    classifier_kind: str
    cells_trained: int
    model_bytes: int
    router_bytes: int
    router: RouterReport
    train_seconds: float
    # Per-cell exact-fit flags of the winning grid ([C] bool): cell c is
    # flagged iff ≥ 1 training query touched it and every touching query
    # was answered exactly. Wired into ``AITree.cell_ok``.
    cell_fit: Optional[np.ndarray] = None
    fit_state: None = None


def _eval_exact_fit(ait, dtree: DeviceTree, wl: labels.Workload,
                    batch: int = 256) -> tuple[float, np.ndarray]:
    """Fraction of workload queries the AI path answers without fallback AND
    with exactly the true leaf set accessed, plus the per-query exactness
    vector ([Q] bool) the per-cell fit flags are derived from."""
    exact = np.zeros((wl.n_queries,), bool)
    Q = wl.n_queries
    for o in range(0, Q, batch):
        q = wl.queries[o:o + batch]
        pad = batch - q.shape[0]
        if pad:
            q = np.concatenate([q, np.tile(q[-1:], (pad, 1))])
        res = ai_query(ait, dtree, torch.from_numpy(q).to(dtree.device))
        take = batch - pad
        pred = res.pred_mask[:take].cpu().numpy()
        fb = res.fallback[:take].cpu().numpy()
        tgt = wl.true_labels[o:o + take]
        exact[o:o + take] = ~fb & np.all(pred == tgt, axis=1)
    return float(exact.mean()), exact


def cell_fit_flags(grid, queries: np.ndarray, exact: np.ndarray,
                   max_cells: int, n_cells: int) -> np.ndarray:
    """Per-cell exact-fit flags: [C] bool from per-query exactness.

    A cell is serve-eligible iff at least one training query touched it
    and *every* touching query was exact. Overflowed queries touch no
    valid cell and so constrain nothing.
    """
    ids, valid, _ = gridlib.bucket_queries_by_cell(grid, queries, max_cells)
    touched = np.zeros((n_cells,), bool)
    bad = np.zeros((n_cells,), bool)
    touched[ids[valid]] = True
    bad[ids[valid & ~exact[:, None]]] = True
    return touched & ~bad


def eval_cell_fit(ait, dtree: DeviceTree, wl: labels.Workload,
                  batch: int = 256) -> tuple[float, np.ndarray, np.ndarray]:
    """``(exact_fit, exact [Q] bool, cell_ok [C] bool)`` for an assembled
    AI-tree — what ``fit_airtree`` installs."""
    fit, exact = _eval_exact_fit(ait, dtree, wl, batch=batch)
    cell_ok = cell_fit_flags(ait.grid, wl.queries, exact, ait.max_cells,
                             ait.bank.n_cells)
    return fit, exact, cell_ok


def fit_airtree(dtree: DeviceTree, workload: labels.Workload, *,
                kind: str = "mlp", tau: float = 0.75,
                grid_sizes: Sequence[int] = (2, 4, 6, 8, 10, 14, 20),
                max_cells: int = 4, max_pred: int = 64,
                target_fit: float = 1.0, mlp_hidden: int = 64,
                mlp_epochs: int = 3000, seed: int = 0,
                max_labels: Optional[int] = None,
                max_queries: Optional[int] = None,
                router_workload: Optional[labels.Workload] = None,
                verbose: bool = False) -> tuple[HybridTree, BuildReport]:
    """Full build on ``dtree``'s device (reference defaults). Only
    ``kind="mlp"`` is ported; ``max_labels``/``max_queries`` pin the
    per-cell pads (default: tight to this workload)."""
    if kind != "mlp":
        raise NotImplementedError(f"kind={kind!r} is not ported yet "
                                  "(mlp only)")
    t0 = time.time()
    dev = dtree.device
    best = None  # (fit, g, ait, bytes, cells, exact)
    tried = []
    for g in grid_sizes:
        gr = gridlib.fit_grid(workload.queries, g, device=dev)
        ds = celldata.build_cell_datasets(gr, workload,
                                          max_cells_per_query=max_cells,
                                          max_labels=max_labels,
                                          max_queries=max_queries)
        bank, _ = mlplib.train_bank(
            ds, hidden=mlp_hidden, max_epochs=mlp_epochs,
            target_fit=target_fit, seed=seed, device=dev)
        nbytes = bank.byte_size()
        ait = make_aitree(gr, bank, max_cells=max_cells, max_pred=max_pred)
        fit, exact = _eval_exact_fit(ait, dtree, workload)
        tried.append((g, round(fit, 4)))
        if verbose:
            print(f"  grid {g}x{g}: exact-fit {fit:.4f} "
                  f"({ds.n_cells_used} cells, {nbytes/1e6:.2f} MB)")
        if best is None or fit > best[0]:
            best = (fit, g, ait, nbytes, ds.n_cells_used, exact)
        if fit >= target_fit:
            break
    fit, g, ait, nbytes, cells, exact = best
    # wire the winning grid's per-cell fit into the serving guard: cells
    # whose training queries were not all exact (or that saw no training
    # query) must not reach the ungated AI path
    cell_ok = cell_fit_flags(ait.grid, workload.queries, exact, max_cells,
                             ait.bank.n_cells)
    ait = dataclasses.replace(ait, cell_ok=torch.from_numpy(cell_ok).to(dev))

    # §V-C2: the router is trained to GENERALIZE over the combined-α workload
    rwl = router_workload if router_workload is not None else workload
    router, rrep = train_router(rwl.queries, rwl.alpha, tau=tau, seed=seed,
                                device=dev)
    hybrid = HybridTree(tree=dtree, ait=ait, router=router)
    report = BuildReport(
        grid_sizes_tried=tried, grid_size=g, exact_fit=fit,
        classifier_kind=kind, cells_trained=cells, model_bytes=nbytes,
        router_bytes=router.byte_size(), router=rrep,
        train_seconds=time.time() - t0, cell_fit=cell_ok)
    return hybrid, report
