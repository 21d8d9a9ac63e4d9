"""The AI-tree (paper §III): predict true leaves, access only those, refine.

Query path (Fig. 5/6):
  1. grid-route the query to its overlapped cells (≤ ``max_cells``);
  2. run those cells' models, union their per-leaf scores (max-combine);
  3. threshold → predicted leaf set (≤ ``max_pred``);
  4. fetch ONLY predicted leaves and refine entries exactly (never a false
     positive, §III-C);
  5. raise the fallback flag when the prediction is unusable — empty set,
     a predicted leaf with zero qualifying entries (the paper's
     misprediction signal), grid/prediction overflow — the caller then runs
     the classical R-path for those queries, keeping results exact.

The three bank families of the reference are ported: the MLP bank
(``kind="mlp"``), whose serving path (``ai_query_compact``) predicts
through ``kernels.ops.mlp_predict_compact`` (the fused CUDA kernel on the
card); the kNN bank (``kind="knn"``); and the oblivious-forest bank
(``kind="forest"``). The kNN and forest banks predict through the dense
score table and compact it, as the reference does. ``ai_query`` keeps the
dense score table for exact-fit evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.core.device_tree import DeviceTree
from repro_torch.core.grid import Grid, cells_of_queries
from repro_torch.core.classifiers.mlp import (MLPBank, cell_logits_for,
                                              global_scores)
from repro_torch.core.classifiers.forest import (Forest,
                                                 cell_probs_for as
                                                 forest_probs)
from repro_torch.core.classifiers.knn import (KNNBank,
                                              cell_probs_for as knn_probs)
from repro_torch.core import traversal
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class AITree:
    grid: Grid
    bank: Union[MLPBank, KNNBank, Forest]
    # Per-cell serve-eligibility guard: cell ``c``'s model may answer on
    # the AI path iff ``cell_ok[c]``. ``build.fit_airtree`` sets it from
    # the per-cell exact-fit flags; queries overlapping any not-ok cell are
    # demoted to the exact R path by ``hybrid_query``.
    cell_ok: torch.Tensor
    kind: str            # "mlp" (MLPBank), "knn" (KNNBank) or "forest"
    max_cells: int
    max_pred: int
    threshold: float


_PER_CELL = {MLPBank: ("w1", "b1", "w2", "b2", "label_map", "lmask"),
             KNNBank: ("feats", "labels", "label_map", "lmask")}


def bank_n_cells(bank) -> int:
    """Cell count of any bank family (the guard/label leading axis)."""
    return bank.label_map.shape[0]


def update_bank_cells(bank, cells, **rows):
    """Functional per-cell splice: a new bank whose rows at ``cells``
    ([Csub] global cell ids) are replaced by the given ``[Csub, ...]``
    arrays, every other cell's rows untouched — the write side of
    ``build.refit_cells``. Only per-cell buffers (leading axis C) may be
    spliced; globals like ``mu``/``sd`` would retarget every cell."""
    per_cell = _PER_CELL.get(type(bank))
    if per_cell is None:
        raise NotImplementedError(
            f"update_bank_cells: {type(bank).__name__} has no per-cell "
            "splice (forest banks refit whole)")
    dev = bank.label_map.device
    idx = torch.as_tensor(np.asarray(cells, np.int64), device=dev)
    updates = {}
    for name, val in rows.items():
        if name not in per_cell:
            raise ValueError(f"{name!r} is not a per-cell buffer of "
                             f"{type(bank).__name__} (allowed: {per_cell})")
        cur = getattr(bank, name)
        val = torch.as_tensor(val, device=dev).to(cur.dtype)
        if tuple(val.shape) != (idx.shape[0],) + tuple(cur.shape[1:]):
            raise ValueError(f"{name}: row shape {tuple(val.shape)} does "
                             f"not match ({idx.shape[0]},) + "
                             f"{tuple(cur.shape[1:])}")
        new = cur.clone()
        new[idx] = val
        updates[name] = new
    return dataclasses.replace(bank, **updates)


def make_aitree(grid: Grid, bank, *, max_cells: int = 4,
                max_pred: int = 64, threshold: float = 0.5,
                cell_ok=None) -> AITree:
    kinds = {MLPBank: "mlp", Forest: "forest", KNNBank: "knn"}
    if type(bank) not in kinds:
        raise TypeError(f"{type(bank).__name__} is not a bank "
                        "(MLPBank, Forest, KNNBank)")
    dev = bank.label_map.device
    if cell_ok is None:
        cell_ok = torch.ones((bank_n_cells(bank),), dtype=torch.bool,
                             device=dev)
    return AITree(grid=grid, bank=bank,
                  cell_ok=torch.as_tensor(cell_ok, device=dev),
                  kind=kinds[type(bank)], max_cells=max_cells,
                  max_pred=max_pred, threshold=threshold)


def cell_slot_probs(ait: AITree, queries: torch.Tensor,
                    cell_ids: torch.Tensor) -> torch.Tensor:
    """Per-(query, cell-slot) classifier scores: [B, S] ids → [B, S, Cl]."""
    if ait.kind == "mlp":
        return torch.sigmoid(cell_logits_for(ait.bank, queries, cell_ids))
    if ait.kind == "knn":
        return knn_probs(ait.bank, queries, cell_ids)
    if ait.kind == "forest":
        return forest_probs(ait.bank, queries, cell_ids)
    raise ValueError(f"unknown bank kind {ait.kind!r}")


def predict_scores(ait: AITree, queries: torch.Tensor, n_leaves: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, 4] → (leaf scores [B, L], cell_overflow [B]).

    The dense prediction path — for consumers that need the full score
    table (exact-fit evaluation, ``pred_mask``). Serving uses
    ``predict_compact``.
    """
    cell_ids, valid, overflow = cells_of_queries(
        ait.grid, queries, ait.max_cells)
    probs = cell_slot_probs(ait, queries, cell_ids)
    scores = global_scores(ait.bank, probs, valid, cell_ids, n_leaves)
    return scores, overflow


def predict_compact(ait: AITree, queries: torch.Tensor, n_leaves: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Prediction straight to the compact slot table: [B, 4] →
    ``(leaf_idx [B, max_pred] i32, valid [B, max_pred] bool, n_pred [B]
    i32, cell_overflow [B] bool)``.

    Semantically ``compact_mask_counted(predict_scores > threshold,
    max_pred)`` plus the cell-routing overflow flag. With an MLP bank on
    the card the dense ``[B, L]`` score table never exists; the kNN and
    forest banks have no prediction kernel (as in the reference) and
    compact the dense table.
    """
    if ait.kind == "mlp":
        cell_ids, valid, overflow = cells_of_queries(
            ait.grid, queries, ait.max_cells)
        idx, v, cnt = kops.mlp_predict_compact(
            queries, ait.bank, cell_ids, valid, n_leaves=n_leaves,
            k=ait.max_pred, threshold=ait.threshold)
        return idx, v, cnt, overflow
    if ait.kind not in ("knn", "forest"):
        raise ValueError(f"unknown bank kind {ait.kind!r}")
    scores, overflow = predict_scores(ait, queries, n_leaves)
    idx, v, cnt = traversal.compact_mask_counted(
        scores > ait.threshold, ait.max_pred)
    return idx, v, cnt, overflow


def _refine_and_flag(ait: AITree, tree: DeviceTree, queries: torch.Tensor,
                     leaf_idx: torch.Tensor, valid: torch.Tensor,
                     n_pred: torch.Tensor, cell_over: torch.Tensor,
                     max_results: int):
    """Shared tail of the AI query pipelines: refine the predicted slot
    table, gather result ids, and assemble the paper's fallback signals
    (empty prediction, mispredicted zero-count leaf, cell/prediction
    overflow, result truncation). Returns ``(counts, n_pred_clamped,
    n_results, result_ids, fallback, mispredict)``.
    """
    pred_over = n_pred > ait.max_pred
    ref = traversal.refine_leaves(tree, queries, leaf_idx, valid)
    empty = n_pred == 0
    # paper's misprediction signal: a predicted leaf with no qualifying entry
    mispredict = torch.any((ref.counts == 0) & valid, dim=-1)
    result_ids, trunc = traversal.gather_result_ids(tree, ref, max_results)
    fallback = empty | mispredict | cell_over | pred_over | trunc
    n_results = torch.sum(ref.counts * valid.to(torch.int32), dim=-1,
                          dtype=torch.int32)
    return (ref.counts, torch.clamp(n_pred, max=ait.max_pred), n_results,
            result_ids, fallback, mispredict)


def primary_cell_ids(ait: AITree, queries: torch.Tensor) -> torch.Tensor:
    """[B] i32 — each query's anchor grid cell (its lower-left corner's
    cell), or -1 for cell-window overflow."""
    cell_ids, valid, _ = cells_of_queries(ait.grid, queries, ait.max_cells)
    return torch.where(valid[:, 0], cell_ids[:, 0], -1).to(torch.int32)


class AIQueryResult(NamedTuple):
    pred_mask: torch.Tensor     # [B, L] predicted leaves
    counts: torch.Tensor        # [B, K] qualifying entries per accessed leaf
    n_pred: torch.Tensor        # [B] leaves accessed by the AI path
    n_results: torch.Tensor     # [B] qualifying points found
    result_ids: torch.Tensor    # [B, max_results] i32, -1 pad
    fallback: torch.Tensor      # [B] bool — run the exact R-path instead
    mispredict: torch.Tensor    # [B] bool — a predicted leaf held no
    #                             qualifying entry
    cell_id: torch.Tensor       # [B] i32 anchor cell (-1 on window overflow)


def ai_query(ait: AITree, tree: DeviceTree, queries: torch.Tensor, *,
             max_results: int = 512) -> AIQueryResult:
    """AI query through the dense score table (keeps ``pred_mask``)."""
    queries = queries.to(torch.float32)
    scores, cell_over = predict_scores(ait, queries, tree.n_leaves)
    pred = scores > ait.threshold                           # [B, L]
    leaf_idx, valid, n_pred = traversal.compact_mask_counted(
        pred, ait.max_pred)
    counts, n_pred_c, n_results, result_ids, fallback, mis = \
        _refine_and_flag(ait, tree, queries, leaf_idx, valid, n_pred,
                         cell_over, max_results)
    return AIQueryResult(
        pred_mask=pred, counts=counts, n_pred=n_pred_c,
        n_results=n_results, result_ids=result_ids, fallback=fallback,
        mispredict=mis, cell_id=primary_cell_ids(ait, queries))


class AICompactResult(NamedTuple):
    leaf_idx: torch.Tensor      # [B, max_pred] predicted leaves (ID order)
    valid: torch.Tensor         # [B, max_pred] slot validity
    counts: torch.Tensor        # [B, max_pred] qualifying entries per slot
    n_pred: torch.Tensor        # [B] leaves accessed by the AI path
    n_results: torch.Tensor     # [B] qualifying points found
    result_ids: torch.Tensor    # [B, max_results] i32, -1 pad
    fallback: torch.Tensor      # [B] bool — run the exact R-path instead
    mispredict: torch.Tensor    # [B] bool — a predicted leaf held no
    #                             qualifying entry
    cell_id: torch.Tensor       # [B] i32 anchor cell (-1 on window overflow)


def ai_query_compact(ait: AITree, tree: DeviceTree, queries: torch.Tensor,
                     *, max_results: int = 512) -> AICompactResult:
    """Serving-path AI query: fused predict+compact → refine.

    Per-field identical to ``ai_query`` on every shared field, including
    the fallback convention.
    """
    queries = queries.to(torch.float32)
    leaf_idx, valid, n_pred, cell_over = predict_compact(
        ait, queries, tree.n_leaves)
    counts, n_pred_c, n_results, result_ids, fallback, mis = \
        _refine_and_flag(ait, tree, queries, leaf_idx, valid, n_pred,
                         cell_over, max_results)
    return AICompactResult(
        leaf_idx=leaf_idx, valid=valid, counts=counts, n_pred=n_pred_c,
        n_results=n_results, result_ids=result_ids, fallback=fallback,
        mispredict=mis, cell_id=primary_cell_ids(ait, queries))
