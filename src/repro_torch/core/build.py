"""End-to-end "AI+R"-tree construction for a (data, query) workload.

Implements the paper's training protocol for the MLP and kNN banks:
  * execute the workload on the R-tree to collect (visited, true) labels
    (``labels.make_workload``, done by the caller);
  * hill-climb the grid size (2×2 → max, §III-B / §V-B3) until the cell
    models reach the best exact fit on the training workload;
  * train the binary router on an 80/20 split (§V-C2);
  * assemble the hybrid structure, with the per-cell exact-fit flags wired
    into the serving guard (``AITree.cell_ok``).

Everything lives on the device of the ``DeviceTree`` it is given.

The build is cell-granular end to end: bucketing, label spaces, training
and certification are per-cell computations with no cross-cell coupling.
``fit_airtree`` therefore emits a ``FitState`` beside the tree, and
``refit_cells`` replays the same pipeline on just the cells whose leaf
span changed (``core.spans``) — relabel → retrain → splice → re-certify —
giving the bank rows and fit flags a from-scratch ``fit_airtree`` on the
new tree would give those cells (the router is left as fit).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import celldata, grid as gridlib, labels
from repro_torch.core import spans as spanslib
from repro_torch.core.aitree import (ai_query, bank_n_cells, make_aitree,
                                     update_bank_cells)
from repro_torch.core.classifiers import knn as knnlib, mlp as mlplib
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
    # Everything ``refit_cells`` needs to continue this build incrementally
    # (training rows, certificates, spans of the fitted tree, pinned pads).
    fit_state: Optional["FitState"] = None


@dataclasses.dataclass
class FitState:
    """The resumable state of a cell-granular build (host numpy).

    ``refit_cells`` threads it functionally — each call returns an updated
    copy whose certificates (``exact`` / ``exact_valid``) and span snapshot
    describe the *current* tree, so chunked refits converge to the
    full-fit state regardless of chunk order.
    """
    queries: np.ndarray           # [Q, 4] f32 training queries (fixed)
    true_rows: list               # [Q] np.int64 arrays — true leaf ids,
    #                               kept current under remap/relabel
    exact: np.ndarray             # [Q] bool — AI path answered exactly
    exact_valid: np.ndarray       # [Q] bool — certificate is current;
    #                               False while any touched cell is stale
    cell_ids: np.ndarray          # [Q, S] i32 bucketing on the fit grid
    cell_valid: np.ndarray        # [Q, S] bool
    overflow: np.ndarray          # [Q] bool — cell-window overflow
    qp: int                       # pinned query pad of the deployed bank
    cl: int                       # pinned label pad of the deployed bank
    spans: list                   # [C] frozensets — cell spans of the
    sigs: list                    # [L] bytes    —  certified tree
    cell_stale: np.ndarray        # [C] bool — span changed, not yet refit
    kind: str
    mlp_hidden: int
    mlp_epochs: int
    target_fit: float
    seed: int
    label_kwargs: dict            # make_workload kwargs for relabelling

    @property
    def n_cells(self) -> int:
        return len(self.spans)

    def exact_fit(self) -> float:
        """Aggregate certified exact fit (uncertified rows count as 0)."""
        return float((self.exact & self.exact_valid).mean())


@dataclasses.dataclass
class RefitReport:
    cells_changed: int        # span-diff invalidations seen this call
    cells_refit: int          # cells actually retrained + respliced
    cells_stale_left: int     # still-stale cells (chunked refit backlog)
    n_relabeled: int          # queries re-run on the R path for labels
    n_recertified: int        # queries whose exactness was re-evaluated
    exact_fit: float          # aggregate certified fit after this call
    train_epochs: int
    train_seconds: float


def _eval_exact(ait, dtree: DeviceTree, queries: np.ndarray, target,
                batch: int = 256) -> np.ndarray:
    """[Q] bool: the AI path answered the query without fallback AND with
    exactly its true leaf set. ``target(o, take)`` gives the [take, L]
    true-leaf rows of queries ``o .. o+take``."""
    Q = queries.shape[0]
    exact = np.zeros((Q,), bool)
    for o in range(0, Q, batch):
        q = queries[o:o + batch]
        pad = batch - q.shape[0]
        if pad:
            q = np.concatenate([q, np.tile(q[-1:], (pad, 1))])
        res = ai_query(ait, dtree, torch.from_numpy(q).to(dtree.device))
        take = batch - pad
        pred = res.pred_mask[:take].cpu().numpy()
        fb = res.fallback[:take].cpu().numpy()
        exact[o:o + take] = ~fb & np.all(pred == target(o, take), axis=1)
    return exact


def _eval_exact_fit(ait, dtree: DeviceTree, wl: labels.Workload,
                    batch: int = 256) -> tuple[float, np.ndarray]:
    """Fraction of workload queries the AI path answers without fallback AND
    with exactly the true leaf set accessed, plus the per-query exactness
    vector ([Q] bool) the per-cell fit flags are derived from."""
    exact = _eval_exact(
        ait, dtree, wl.queries,
        lambda o, take: wl.true_labels[o:o + take], batch=batch)
    return float(exact.mean()), exact


def _eval_exact_rows(ait, dtree: DeviceTree, queries: np.ndarray,
                     true_rows: list, batch: int = 256) -> np.ndarray:
    """Per-query exactness against index-form labels (the refit path's
    twin of ``_eval_exact_fit``)."""
    def target(o, take):
        tgt = np.zeros((take, dtree.n_leaves), bool)
        for j in range(take):
            tgt[j, true_rows[o + j]] = True
        return tgt
    return _eval_exact(ait, dtree, queries, target, batch=batch)


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
                             bank_n_cells(ait.bank))
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
                label_kwargs: Optional[dict] = None,
                verbose: bool = False) -> tuple[HybridTree, BuildReport]:
    """Full build on ``dtree``'s device (reference defaults), for
    ``kind="mlp"`` or ``"knn"``. ``max_labels``/``max_queries`` pin the
    per-cell pads (default: tight to this workload) — a refit world and a
    from-scratch world compare bit-identically only under equal pads.
    ``label_kwargs`` records the ``make_workload`` settings ``workload``
    was labelled with, so ``refit_cells`` relabels identically."""
    if kind not in ("mlp", "knn"):
        raise NotImplementedError(f"kind={kind!r} is not ported "
                                  "(mlp, knn)")
    t0 = time.time()
    dev = dtree.device
    best = None  # (fit, g, ait, bytes, cells, exact, ds)
    tried = []
    for g in grid_sizes:
        gr = gridlib.fit_grid(workload.queries, g, device=dev)
        ds = celldata.build_cell_datasets(gr, workload,
                                          max_cells_per_query=max_cells,
                                          max_labels=max_labels,
                                          max_queries=max_queries)
        if kind == "mlp":
            bank, _ = mlplib.train_bank(
                ds, hidden=mlp_hidden, max_epochs=mlp_epochs,
                target_fit=target_fit, seed=seed, device=dev)
        else:
            bank = knnlib.fit_knn(ds, device=dev)
        nbytes = bank.byte_size()
        ait = make_aitree(gr, bank, max_cells=max_cells, max_pred=max_pred)
        fit, exact = _eval_exact_fit(ait, dtree, workload)
        tried.append((g, round(fit, 4)))
        if verbose:
            print(f"  grid {g}x{g}: exact-fit {fit:.4f} "
                  f"({ds.n_cells_used} cells, {nbytes/1e6:.2f} MB)")
        if best is None or fit > best[0]:
            best = (fit, g, ait, nbytes, ds.n_cells_used, exact, ds)
        if fit >= target_fit:
            break
    fit, g, ait, nbytes, cells, exact, ds = best
    # wire the winning grid's per-cell fit into the serving guard: cells
    # whose training queries were not all exact (or that saw no training
    # query) must not reach the ungated AI path
    n_cells = bank_n_cells(ait.bank)
    cell_ok = cell_fit_flags(ait.grid, workload.queries, exact, max_cells,
                             n_cells)
    ait = dataclasses.replace(ait, cell_ok=torch.from_numpy(cell_ok).to(dev))

    # §V-C2: the router is trained to GENERALIZE over the combined-α workload
    rwl = router_workload if router_workload is not None else workload
    router, rrep = train_router(rwl.queries, rwl.alpha, tau=tau, seed=seed,
                                device=dev)
    hybrid = HybridTree(tree=dtree, ait=ait, router=router)

    ids, valid, overflow = gridlib.bucket_queries_by_cell(
        ait.grid, workload.queries, max_cells)
    sigs = spanslib.leaf_signatures(dtree)
    state = FitState(
        queries=np.asarray(workload.queries, np.float32).copy(),
        true_rows=celldata.workload_true_rows(workload),
        exact=exact.copy(),
        exact_valid=np.ones_like(exact),
        cell_ids=ids, cell_valid=valid, overflow=overflow,
        qp=int(ds.feats.shape[1]), cl=int(ds.max_labels),
        spans=spanslib.cell_spans(dtree, ait.grid, sigs=sigs),
        sigs=sigs,
        cell_stale=np.zeros((n_cells,), bool),
        kind=kind, mlp_hidden=mlp_hidden, mlp_epochs=mlp_epochs,
        target_fit=target_fit, seed=seed,
        label_kwargs=dict(label_kwargs or {}))
    report = BuildReport(
        grid_sizes_tried=tried, grid_size=g, exact_fit=fit,
        classifier_kind=kind, cells_trained=cells, model_bytes=nbytes,
        router_bytes=router.byte_size(), router=rrep,
        train_seconds=time.time() - t0, cell_fit=cell_ok, fit_state=state)
    return hybrid, report


def refit_cells(hybrid: HybridTree, state: FitState,
                cells: Optional[np.ndarray] = None, *, batch: int = 256,
                label_kwargs: Optional[dict] = None, verbose: bool = False
                ) -> tuple[HybridTree, FitState, RefitReport]:
    """Incrementally re-optimize the AI side against ``hybrid.tree``.

    The online continuation of ``fit_airtree``: spans of the (possibly
    repacked) tree are diffed against the certified snapshot in
    ``state``; cells whose span moved are stale. This call relabels the
    chunk's queries on the R path, retrains just the chunk's cells (same
    per-cell pipeline, pinned pads), splices the rows into the live bank
    (``update_bank_cells``), re-certifies every query whose touched cells
    are all current again, and recomputes the serving guard. The router is
    left as fit.

    ``cells`` defaults to *all* stale cells; pass a subset to spread the
    work over serve segments (chunked refit). Cells in ``cells`` that are
    not stale are retrained too (a forced refit — the policy's promote
    lever). Returns ``(hybrid', state', report)``; the inputs are left
    untouched.
    """
    if state.kind not in ("mlp", "knn"):
        raise NotImplementedError(
            f"refit_cells: kind={state.kind!r} has no per-cell splice")
    t0 = time.time()
    dtree = hybrid.tree
    dev = dtree.device
    ait = hybrid.ait
    bank = ait.bank
    C = bank_n_cells(bank)
    new_sigs = spanslib.leaf_signatures(dtree)
    new_spans = spanslib.cell_spans(dtree, ait.grid, sigs=new_sigs)
    changed, remap = spanslib.diff_spans(state.spans, new_spans,
                                         state.sigs, new_sigs)
    stale = state.cell_stale | changed
    if cells is None:
        cells = np.flatnonzero(stale)
    cells = np.unique(np.asarray(cells, np.int64))
    in_chunk = np.zeros((C,), bool)
    in_chunk[cells] = True

    ids, valid = state.cell_ids, state.cell_valid

    def touch(cell_mask: np.ndarray) -> np.ndarray:
        """[Q] bool — queries with a valid slot on any flagged cell."""
        return (valid & cell_mask[ids]).any(axis=1)

    # -- 1. carry surviving leaf ids across the tree change ----------------
    exact = state.exact.copy()
    exact_valid = state.exact_valid.copy()
    true_rows = list(state.true_rows)
    if state.sigs != new_sigs:
        # rename global leaf ids in the bank's label maps (unchanged cells
        # keep serving, exactly renamed) and in the cached label rows
        lm, lmk = spanslib.remap_label_map(
            bank.label_map.cpu().numpy(), bank.lmask.cpu().numpy(), remap)
        bank = dataclasses.replace(bank,
                                   label_map=torch.from_numpy(lm).to(dev),
                                   lmask=torch.from_numpy(lmk).to(dev))
        for qi, rows in enumerate(true_rows):
            if rows.size:
                r = remap[rows]
                if (r < 0).any():
                    # a true leaf vanished ⇒ some touched cell's span
                    # changed ⇒ the query is relabeled when that cell
                    # refits; until then: uncertified
                    exact_valid[qi] = False
                    r = r[r >= 0]
                true_rows[qi] = np.sort(r).astype(np.int64)
        exact_valid[touch(changed)] = False
    # any query seeing a stale cell is uncertified until that cell refits
    exact_valid[touch(stale)] = False

    # -- 2. relabel the chunk's queries against the new tree ---------------
    relabel = np.flatnonzero(touch(in_chunk))
    if relabel.size:
        lkw = dict(state.label_kwargs)
        lkw.update(label_kwargs or {})
        sub_wl = labels.make_workload(dtree, state.queries[relabel], **lkw)
        for j, qi in enumerate(celldata.workload_true_rows(sub_wl)):
            true_rows[int(relabel[j])] = qi

    # -- 3. rebuild + retrain just the chunk, splice into the live bank ----
    epochs = 0
    if cells.size:
        sub = celldata.build_cell_subset(
            ait.grid, state.queries, true_rows, cells,
            max_cells_per_query=ait.max_cells, max_labels=state.cl,
            max_queries=state.qp)
        if state.kind == "mlp":
            mu, sd = mlplib.grid_norm(ait.grid)
            params, trep = mlplib.train_cells(
                sub.feats, sub.labels, sub.qmask, sub.lmask, mu, sd, cells,
                hidden=state.mlp_hidden, max_epochs=state.mlp_epochs,
                target_fit=state.target_fit, seed=state.seed, device=dev)
            epochs = trep.epochs
            bank = update_bank_cells(
                bank, cells, w1=params["w1"], b1=params["b1"],
                w2=params["w2"], b2=params["b2"],
                label_map=sub.label_map, lmask=sub.lmask)
        else:
            sub_bank = knnlib.fit_knn(sub, eps=float(bank.eps), device=dev)
            bank = update_bank_cells(
                bank, cells, feats=sub_bank.feats, labels=sub_bank.labels,
                label_map=sub_bank.label_map, lmask=sub_bank.lmask)
        if verbose:
            print(f"  refit {cells.size} cells ({relabel.size} queries "
                  f"relabeled, {epochs} epochs)")
    post_stale = stale & ~in_chunk

    # -- 4. re-certify queries whose world is current again ----------------
    ait = dataclasses.replace(ait, bank=bank)
    recert = np.flatnonzero(touch(in_chunk) & ~touch(post_stale))
    if recert.size:
        exact[recert] = _eval_exact_rows(
            ait, dtree, state.queries[recert],
            [true_rows[int(qi)] for qi in recert], batch=batch)
        exact_valid[recert] = True

    # -- 5. recompute the serving guard from the refreshed certificates ----
    q_ok = exact & exact_valid
    touched = np.zeros((C,), bool)
    bad = np.zeros((C,), bool)
    touched[ids[valid]] = True
    bad[ids[valid & ~q_ok[:, None]]] = True
    cell_ok = touched & ~bad & ~post_stale
    ait = dataclasses.replace(ait, cell_ok=torch.from_numpy(cell_ok).to(dev))

    state = dataclasses.replace(
        state, true_rows=true_rows, exact=exact, exact_valid=exact_valid,
        spans=new_spans, sigs=new_sigs, cell_stale=post_stale)
    report = RefitReport(
        cells_changed=int(changed.sum()), cells_refit=int(cells.size),
        cells_stale_left=int(post_stale.sum()),
        n_relabeled=int(relabel.size), n_recertified=int(recert.size),
        exact_fit=state.exact_fit(), train_epochs=epochs,
        train_seconds=time.time() - t0)
    return dataclasses.replace(hybrid, ait=ait), state, report
