"""Per-grid-cell training-set assembly (paper §III-B).

Every query is assigned to each grid cell it overlaps; each non-empty cell
gets its own training set whose label space is *cell-local*: the union of
true leaf IDs seen by that cell's queries. Cell-local labels keep the
classifier heads small (the paper's per-cell decision trees have the same
property implicitly) and map back to global DFS leaf IDs via ``label_map``.

All outputs are padded, stacked arrays ready for expert-parallel training.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.grid import Grid, bucket_queries_by_cell
from repro_torch.core.labels import Workload


@dataclasses.dataclass
class CellDataset:
    grid: Grid
    feats: np.ndarray       # [C, Qp, F] f32 — per-cell padded query features
    labels: np.ndarray      # [C, Qp, Cl] f32 — cell-local multi-hot targets
    qmask: np.ndarray       # [C, Qp] bool — query-slot validity
    lmask: np.ndarray       # [C, Cl] bool — label-slot validity
    label_map: np.ndarray   # [C, Cl] i32 — cell-local → global leaf id (-1 pad)
    n_cells_used: int       # non-empty cells (models actually trained)
    label_overflow: np.ndarray  # [C] bool — label space exceeded Cl
    query_overflow: np.ndarray  # [C] bool — query count exceeded Qp

    @property
    def n_cells(self) -> int:
        return self.feats.shape[0]

    @property
    def max_labels(self) -> int:
        return self.labels.shape[-1]


def query_features(queries: np.ndarray) -> np.ndarray:
    """Feature representation (§III-A5): the raw query rectangle. The model
    may normalize internally; the input interface stays the rectangle."""
    return np.asarray(queries, dtype=np.float32)


def bucket_cell_queries(grid: Grid, queries: np.ndarray,
                        max_cells_per_query: int) -> list[list[int]]:
    """Per-cell training-query index lists, in ascending query order — the
    canonical row order of every cell's dataset (full build and subset
    rebuild alike, so a rebuilt row block is positionally identical)."""
    ids, valid, _ = bucket_queries_by_cell(grid, queries, max_cells_per_query)
    per_cell_q: list[list[int]] = [[] for _ in range(grid.n_cells)]
    for qi in range(queries.shape[0]):
        for s in range(max_cells_per_query):
            if valid[qi, s]:
                per_cell_q[int(ids[qi, s])].append(qi)
    return per_cell_q


def cell_label_space(per_cell_q: list[int],
                     true_rows: list[np.ndarray]) -> np.ndarray:
    """A cell's local label space: sorted unique global leaf ids over its
    queries' true sets (paper §III-B, cell-local heads)."""
    if per_cell_q:
        return np.unique(np.concatenate(
            [true_rows[qi] for qi in per_cell_q]))
    return np.empty(0, np.int64)


def _assemble_cells(grid: Grid, queries: np.ndarray,
                    true_rows: list[np.ndarray], cells: np.ndarray,
                    Cl: int, Qp: int, *,
                    per_cell_q: list[list[int]]) -> CellDataset:
    """Shared assembly core: padded rows for the listed cells only.

    Row ``i`` of every output array belongs to global cell ``cells[i]``.
    A cell's rows depend on nothing but its own query list, their labels,
    and the (Cl, Qp) pads — so assembling a subset is bit-identical to
    slicing those cells out of the full assembly with the same pads, the
    property ``build.refit_cells`` leans on.
    """
    n = len(cells)
    feats = np.zeros((n, Qp, 4), np.float32)
    labels = np.zeros((n, Qp, Cl), np.float32)
    qmask = np.zeros((n, Qp), bool)
    lmask = np.zeros((n, Cl), bool)
    label_map = np.full((n, Cl), -1, np.int32)
    l_over = np.zeros((n,), bool)
    q_over = np.zeros((n,), bool)
    fx = query_features(queries)
    used = 0
    for i, c in enumerate(cells):
        qs = per_cell_q[int(c)]
        if not qs:
            continue
        used += 1
        u = cell_label_space(qs, true_rows)
        if len(u) > Cl:
            l_over[i] = True
            u = u[:Cl]
        if len(qs) > Qp:
            q_over[i] = True
            qs = qs[:Qp]
        pos = {g: j for j, g in enumerate(u)}
        label_map[i, :len(u)] = u
        lmask[i, :len(u)] = True
        for slot, qi in enumerate(qs):
            feats[i, slot] = fx[qi]
            qmask[i, slot] = True
            for g in true_rows[qi]:
                if g in pos:
                    labels[i, slot, pos[g]] = 1.0
    return CellDataset(
        grid=grid, feats=feats, labels=labels, qmask=qmask, lmask=lmask,
        label_map=label_map, n_cells_used=used, label_overflow=l_over,
        query_overflow=q_over)


def workload_true_rows(workload: Workload) -> list[np.ndarray]:
    """[Q] per-query global true-leaf id arrays (multi-hot → index form)."""
    return [np.flatnonzero(workload.true_labels[qi])
            for qi in range(workload.n_queries)]


def build_cell_datasets(grid: Grid, workload: Workload, *,
                        max_cells_per_query: int = 4,
                        max_labels: Optional[int] = None,
                        max_queries: Optional[int] = None) -> CellDataset:
    """Assemble per-cell padded training sets from a labelled workload."""
    per_cell_q = bucket_cell_queries(grid, workload.queries,
                                     max_cells_per_query)
    true_rows = workload_true_rows(workload)
    Cl = max_labels or max(8, max(
        (len(cell_label_space(q, true_rows)) for q in per_cell_q),
        default=8))
    Qp = max_queries or max(8, max((len(q) for q in per_cell_q), default=8))
    return _assemble_cells(grid, workload.queries, true_rows,
                           np.arange(grid.n_cells), Cl, Qp,
                           per_cell_q=per_cell_q)


def build_cell_subset(grid: Grid, queries: np.ndarray,
                      true_rows: list[np.ndarray], cells: np.ndarray, *,
                      max_cells_per_query: int, max_labels: int,
                      max_queries: int) -> CellDataset:
    """Rebuild just the listed cells' datasets against (possibly fresh)
    ``true_rows``, with the pad shapes pinned to the deployed bank's —
    the data side of ``build.refit_cells``. Row ``i`` ↔ ``cells[i]``."""
    per_cell_q = bucket_cell_queries(grid, queries, max_cells_per_query)
    return _assemble_cells(grid, queries, true_rows,
                           np.asarray(cells, np.int64), max_labels,
                           max_queries, per_cell_q=per_cell_q)
