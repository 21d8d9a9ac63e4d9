"""Batched k-nearest-neighbour serving on the slot-table contract.

The kNN path is distance browsing over the range machinery: probe the
tree with the query's ``centre ± radius`` box through the compacting
traversal (``visited_leaves_compact``: on the card the ``[B, L]`` visited
mask never exists), then distance-browse exactly the named leaf slots
and keep the k smallest in-radius distances of each row, ties to the
lower flat position slot·M + m (``kernels.ops.knn_browse_topk``). On the
card that is one launch that picks the winners on chip: no ``[B, K·M]``
view of distances or ids exists there, and nothing is sorted.

Exactness: every point within distance ``r`` of the centre lies inside
the probe box, so it sits in a visited leaf. If the visited set did not
overflow its slot table and at least ``k`` candidates fell within ``r``,
the k smallest in-radius distances are the global k nearest. Rows where
either condition fails are flagged ``truncated`` and re-served by the
wide tier of ``make_knn_steps`` (radius doubled, slot table widened)
through ``schedule.serve_workload``; residual truncation stays flagged.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.device_tree import DeviceTree
from repro_torch.core.traversal import visited_leaves_compact
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import smallest_k  # the oracle's selection

# The brute-force oracles hold at most this many (row, point) cells per
# chunk (a few GB of temporaries on the card), whatever the point count.
BRUTE_CELLS = 2 ** 28


class KnnResult(NamedTuple):
    neighbor_ids: torch.Tensor   # [B, k] i32 entry ids, -1 padded
    neighbor_d2: torch.Tensor    # [B, k] f32 squared distances, +inf padded
    n_within: torch.Tensor       # [B] i32 candidates within the radius
    n_visited: torch.Tensor      # [B] i32 leaves the probe box visited
    leaf_accesses: torch.Tensor  # [B] i32 leaf tiles actually browsed
    truncated: torch.Tensor      # [B] bool — result not provably exact


def query_centers(queries: torch.Tensor) -> torch.Tensor:
    """[B, 4] rects (or [B, 2] points) → [B, 2] f32 centres."""
    q = queries.to(torch.float32)
    if q.shape[-1] == 2:
        return q
    return torch.stack([(q[:, 0] + q[:, 2]) * 0.5,
                        (q[:, 1] + q[:, 3]) * 0.5], dim=1)


def knn_query(tree: DeviceTree, queries: torch.Tensor, *, k: int,
              radius: float, max_visited: int = 64) -> KnnResult:
    """Radius-probed exact kNN: queries [B, 4] rects (centres taken) or
    [B, 2] points → ``KnnResult``. A row is exact unless ``truncated``
    (see the module docstring)."""
    centers = query_centers(queries)
    r = torch.tensor(radius, dtype=torch.float32, device=centers.device)
    box = torch.cat([centers - r, centers + r], dim=1)
    cv = visited_leaves_compact(tree, box, max_visited)
    c3 = torch.cat([centers, (r * r).expand(centers.shape[0], 1)], dim=1)
    d2k, idk, n_within = kops.knn_browse_topk(
        c3, tree.leaf_entries, tree.leaf_entry_ids, cv.leaf_idx, cv.valid, k)
    kk = d2k.shape[1]
    if kk < k:          # degenerate tiny trees: keep the static [B, k]
        d2k = torch.nn.functional.pad(d2k, (0, k - kk), value=torch.inf)
        idk = torch.nn.functional.pad(idk, (0, k - kk), value=-1)
    return KnnResult(
        neighbor_ids=idk,
        neighbor_d2=d2k,
        n_within=n_within,
        n_visited=cv.n_visited,
        leaf_accesses=torch.clamp(cv.n_visited, max=max_visited),
        truncated=cv.overflow | (n_within < k),
    )


def make_knn_steps(tree: DeviceTree, *, k: int, radius: float,
                   max_visited: int = 64, wide_factor: int = 8):
    """Two-tier kNN serve steps ``(narrow, wide)`` for
    ``schedule.serve_workload``: the wide tier doubles the radius and
    widens the slot table by ``wide_factor``. Both tiers return the
    static ``[B, k]`` result width, so the merge keeps wide rows whole."""
    def narrow(q):
        return knn_query(tree, q, k=k, radius=radius,
                         max_visited=max_visited)

    def wide(q):
        return knn_query(tree, q, k=k, radius=radius * 2.0,
                         max_visited=max_visited * wide_factor)

    return narrow, wide


def default_radius(tree: DeviceTree, k: int, margin: float = 2.0) -> float:
    """Density-derived probe radius: for ~uniform data a disc holding
    ``k`` points has radius ``sqrt(k·A / (π·n))``; ``margin`` buys slack
    so the narrow tier usually resolves in one pass."""
    root = tree.levels[0].mbrs.cpu().numpy().astype(np.float64)
    area = float(max((root[:, 2].max() - root[:, 0].min())
                     * (root[:, 3].max() - root[:, 1].min()), 1e-12))
    n = max(int(tree.n_points), 1)
    return float(margin * math.sqrt(max(k, 1) * area / (math.pi * n)))


def knn_brute(points: np.ndarray, centers: np.ndarray, k: int, *,
              device: str | torch.device = "cuda", chunk: int = 32
              ) -> tuple[np.ndarray, np.ndarray]:
    """Brute-force oracle on ``device``: all-pairs f32 distances →
    ``(d2 [B, k], ids [B, k])`` ascending, ``chunk`` centres at a time.

    The arithmetic is the serving path's: ``dx*dx + dy*dy`` as three
    separately rounded ops, then the same stable selection, so distances
    compare bit for bit; ids are comparable only where distances are
    distinct. ``chunk`` shrinks so that a chunk holds at most
    ``BRUTE_CELLS`` distances.
    """
    dev = resolve_device(device)
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    c = torch.from_numpy(np.asarray(centers, np.float32)).to(dev)
    chunk = max(1, min(chunk, BRUTE_CELLS // max(pts.shape[0], 1)))
    kk = min(k, pts.shape[0])
    d2s, ids = [], []
    for o in range(0, c.shape[0], chunk):
        cc = c[o:o + chunk]
        dx = pts[None, :, 0] - cc[:, None, 0]
        dy = pts[None, :, 1] - cc[:, None, 1]
        vals, pos = smallest_k(dx * dx + dy * dy, kk)
        d2s.append(vals.cpu().numpy())
        ids.append(pos.cpu().numpy())
    out_d2 = np.concatenate(d2s, axis=0)
    idx = np.concatenate(ids, axis=0).astype(np.int64)
    if kk < k:
        pad = ((0, 0), (0, k - kk))
        out_d2 = np.pad(out_d2, pad, constant_values=np.inf)
        idx = np.pad(idx, pad, constant_values=-1)
    return out_d2, idx
