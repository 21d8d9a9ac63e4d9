"""The model-index grid (paper §III-B, Fig. 6): "indexing the learned models".

A G×G uniform grid over query space; one learned model per *non-empty* cell
(cells no training query touches get no model). At query time the models
whose cells overlap the query rectangle are executed and their predictions
unioned.

The grid is deterministic integer lattice math — its own routing never needs
learning. Cell indices are computed in float32 as ``floor((q - x0) / cw)``,
the reference's op order: queries lying exactly on a cell boundary land in
the same cell in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform G×G grid over the data/query bounding box."""
    bbox: torch.Tensor  # [4] f32 (xmin, ymin, xmax, ymax)
    g: int

    @property
    def n_cells(self) -> int:
        return self.g * self.g

    def cell_width(self) -> Tuple[torch.Tensor, torch.Tensor]:
        # span * f32(1/g), not span / g: the reference computes the width
        # under jit, where XLA rewrites division by the constant g into
        # multiplication by its float32 reciprocal, and boundary queries
        # land in the same cell only if the width is bit-equal.
        inv_g = float(np.float32(1.0) / np.float32(self.g))
        return ((self.bbox[2] - self.bbox[0]) * inv_g,
                (self.bbox[3] - self.bbox[1]) * inv_g)


def fit_grid(points_or_queries: np.ndarray, g: int, margin: float = 1e-3,
             device: str | torch.device = "cuda") -> Grid:
    """Fit the grid bbox over data points [N,2] or query rects [Q,4]."""
    a = np.asarray(points_or_queries, dtype=np.float32)
    if a.shape[-1] == 2:
        lo, hi = a.min(axis=0), a.max(axis=0)
    else:
        lo = a[:, :2].min(axis=0)
        hi = a[:, 2:].max(axis=0)
    span = np.maximum(hi - lo, 1e-9)
    bbox = np.concatenate([lo - margin * span, hi + margin * span])
    return Grid(bbox=torch.from_numpy(bbox.astype(np.float32)).to(
        resolve_device(device)), g=int(g))


def cell_range(grid: Grid, queries: torch.Tensor) -> torch.Tensor:
    """[B, 4] query rects → [B, 4] i32 (cx0, cy0, cx1, cy1) cell index ranges."""
    q = queries.to(torch.float32)
    cw, ch = grid.cell_width()
    gx0, gy0 = grid.bbox[0], grid.bbox[1]
    top = grid.g - 1
    cx0 = torch.clamp(torch.floor((q[:, 0] - gx0) / cw), 0, top)
    cy0 = torch.clamp(torch.floor((q[:, 1] - gy0) / ch), 0, top)
    cx1 = torch.clamp(torch.floor((q[:, 2] - gx0) / cw), 0, top)
    cy1 = torch.clamp(torch.floor((q[:, 3] - gy0) / ch), 0, top)
    return torch.stack([cx0, cy0, cx1, cy1], dim=-1).to(torch.int32)


def cells_of_queries(grid: Grid, queries: torch.Tensor, max_cells: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Overlapped cell ids per query, statically bounded.

    ``max_cells`` must be a perfect square (the window is √max × √max).
    Returns ``(cell_ids [B, max_cells] i32, valid [B, max_cells] bool,
    overflow [B] bool)``. ``overflow`` marks queries spanning a wider cell
    window than the static bound — those take the exact R-tree path.
    """
    side = int(round(np.sqrt(max_cells)))
    if side * side != max_cells:
        raise ValueError("max_cells must be a perfect square")
    B = queries.shape[0]
    cr = cell_range(grid, queries)                          # [B, 4]
    nx = cr[:, 2] - cr[:, 0] + 1                            # [B]
    ny = cr[:, 3] - cr[:, 1] + 1
    d = torch.arange(side, dtype=torch.int32, device=queries.device)
    # side×side window anchored at (cx0, cy0); offsets clamped into range so
    # every id is in-bounds (duplicates are masked by ``valid``).
    ox = torch.minimum(d[None, :], nx[:, None] - 1)         # [B, side]
    oy = torch.minimum(d[None, :], ny[:, None] - 1)
    cx = cr[:, 0:1] + ox
    cy = cr[:, 1:2] + oy
    ids = (cy[:, :, None] * grid.g + cx[:, None, :]).reshape(B, -1)
    valid = ((d[None, :, None] < ny[:, None, None])
             & (d[None, None, :] < nx[:, None, None])).reshape(B, -1)
    overflow = (nx > side) | (ny > side)
    return ids.to(torch.int32), valid & ~overflow[:, None], overflow


def bucket_queries_by_cell(grid: Grid, queries: np.ndarray, max_cells: int
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host twin of ``cells_of_queries`` (used at training time)."""
    q = torch.as_tensor(np.asarray(queries, np.float32),
                        device=grid.bbox.device)
    ids, valid, overflow = cells_of_queries(grid, q, max_cells)
    return ids.cpu().numpy(), valid.cpu().numpy(), overflow.cpu().numpy()
