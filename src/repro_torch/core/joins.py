"""Batched spatial join: index-nested-loop over the compacting traversal.

A spatial join ``outer ⋈ points`` streams the outer-side rectangles
through the same serving machinery as the range path: outer batches are
formed on the Hilbert curve (``schedule.serve_workload``), each batch
runs the compacting traversal + refine (``range_query_compact``), and
the qualifying (outer, point) pairs come back through the
``[B, max_pairs]`` pair-slot table (its ``result_ids``). On the card the
dense ``[B, L]`` mask never exists.

Overflowing rows (visited-set or pair-table truncation) re-serve on a
wide tier with both bounds scaled by ``wide_factor``. A join's payload
is the pair table itself, which ``schedule._merge_rows`` would slice
back to the narrow width, so ``spatial_join`` runs the two tiers itself:
each tier's pairs are flattened on the host at that tier's full width
before any merge, and the only possible loss — wide-tier truncation — is
counted (``residual_truncated``), never silent.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import schedule
from repro_torch.core.device_tree import DeviceTree
from repro_torch.core.traversal import range_query_compact


class JoinStats(NamedTuple):
    """Per-outer-row join stats (a serve-step stats tuple)."""
    n_pairs: torch.Tensor        # [B] i32 qualifying pairs (full count)
    pair_ids: torch.Tensor       # [B, max_pairs] i32 point ids, -1 padded
    n_visited: torch.Tensor      # [B] i32 leaves visited
    leaf_accesses: torch.Tensor  # [B] i32 leaf tiles actually refined
    truncated: torch.Tensor      # [B] bool — pair table or visited set
    #                              overflowed


def join_step(tree: DeviceTree, outer: torch.Tensor, *, max_pairs: int = 16,
              max_visited: int = 64) -> JoinStats:
    """One join batch: outer rects [B, 4] → ``JoinStats``."""
    rq = range_query_compact(tree, outer, max_visited=max_visited,
                             max_results=max_pairs)
    return JoinStats(
        n_pairs=rq.n_results,
        pair_ids=rq.result_ids,
        n_visited=rq.n_visited,
        leaf_accesses=torch.clamp(rq.n_visited, max=max_visited),
        truncated=rq.truncated,
    )


def make_join_steps(tree: DeviceTree, *, max_pairs: int = 16,
                    max_visited: int = 64, wide_factor: int = 8
                    ) -> tuple[Callable, Callable]:
    """Two-tier join serve steps ``(narrow, wide)``; the wide tier scales
    both bounds by ``wide_factor``."""
    def narrow(q):
        return join_step(tree, q, max_pairs=max_pairs,
                         max_visited=max_visited)

    def wide(q):
        return join_step(tree, q, max_pairs=max_pairs * wide_factor,
                         max_visited=max_visited * wide_factor)

    return narrow, wide


class JoinReport(NamedTuple):
    """Aggregate result of one spatial join."""
    pairs: np.ndarray           # [P, 2] i64 (outer index, point id)
    stats: JoinStats            # per-outer-row stats (numpy), submission order
    n_outer: int
    n_pairs: int                # == pairs.shape[0]
    n_batches: int
    n_reserved: int             # outer rows re-served on the wide tier
    residual_truncated: int     # rows still truncated after the wide tier
    sort: str


def _flatten_pairs(stats, rows: np.ndarray) -> np.ndarray:
    """Extract (outer, point) pairs for ``rows`` from a tier's stats at
    that tier's full static pair width."""
    ids = np.asarray(stats.pair_ids)
    npairs = np.asarray(stats.n_pairs)
    out = []
    for local, outer_i in enumerate(rows):
        n = min(int(npairs[local]), ids.shape[1])
        if n:
            out.append(np.stack(
                [np.full((n,), outer_i, np.int64),
                 ids[local, :n].astype(np.int64)], axis=1))
    if not out:
        return np.zeros((0, 2), np.int64)
    return np.concatenate(out, axis=0)


def _tier_rows(stats, rows: np.ndarray):
    """Row-select a stats tuple (numpy) onto ``rows``."""
    return type(stats)(**{f: np.asarray(getattr(stats, f))[rows]
                          for f in type(stats)._fields})


def spatial_join(tree: DeviceTree, outer: np.ndarray, *, batch: int,
                 max_pairs: int = 16, max_visited: int = 64,
                 sort: str = "hilbert", wide_factor: int = 8,
                 bbox: Optional[np.ndarray] = None,
                 device: str | torch.device = "cuda") -> JoinReport:
    """Join every outer rect against the tree's points.

    Outer batches form on the ``sort`` curve; truncated rows re-serve on
    the wide tier with pairs kept at the wide tier's full width (see the
    module docstring). ``pairs`` is sorted by (outer index, point id), so
    the result does not depend on batch formation.
    """
    outer = np.asarray(outer, np.float32)
    narrow, wide = make_join_steps(tree, max_pairs=max_pairs,
                                   max_visited=max_visited,
                                   wide_factor=wide_factor)
    rep = schedule.serve_workload(narrow, outer, batch=batch, sort=sort,
                                  bbox=bbox, wide_fn=None, trunc_field=None,
                                  device=device)
    trunc = np.asarray(rep.stats.truncated).astype(bool)
    idx = np.flatnonzero(trunc)
    ok = np.flatnonzero(~trunc)
    pairs = [_flatten_pairs(_tier_rows(rep.stats, ok), ok)]
    n_batches, residual = rep.n_batches, 0
    stats = rep.stats
    if idx.size:
        wrep = schedule.serve_workload(wide, outer[idx], batch=batch,
                                       sort=sort, bbox=bbox, wide_fn=None,
                                       trunc_field=None, device=device)
        n_batches += wrep.n_batches
        pairs.append(_flatten_pairs(wrep.stats, idx))
        residual = int(np.asarray(wrep.stats.truncated).sum())
        stats = schedule._merge_rows(stats, wrep.stats, idx)
    allp = np.concatenate(pairs, axis=0)
    if allp.shape[0]:
        allp = allp[np.lexsort((allp[:, 1], allp[:, 0]))]
    return JoinReport(pairs=allp, stats=stats, n_outer=outer.shape[0],
                      n_pairs=int(allp.shape[0]), n_batches=n_batches,
                      n_reserved=int(idx.size),
                      residual_truncated=residual, sort=sort)


def join_brute(points: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """Brute-force pair-set oracle: [P, 2] i64 (outer index, point id),
    sorted, via dense closed-rect containment in f32."""
    p = np.asarray(points, np.float32)
    r = np.asarray(rects, np.float32)
    inside = ((p[None, :, 0] >= r[:, None, 0])
              & (p[None, :, 0] <= r[:, None, 2])
              & (p[None, :, 1] >= r[:, None, 1])
              & (p[None, :, 1] <= r[:, None, 3]))
    oi, pj = np.nonzero(inside)
    out = np.stack([oi.astype(np.int64), pj.astype(np.int64)], axis=1)
    order = np.lexsort((out[:, 1], out[:, 0]))
    return out[order]
