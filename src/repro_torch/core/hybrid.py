"""The "AI+R"-tree (paper §IV): router-dispatched hybrid of AI- and R-paths.

For each query the binary router predicts high-/low-overlap; high-overlap
queries take the AI path (predicted leaves only), low-overlap queries take
the classical R path. AI-path queries whose prediction is unusable fall back
to the R path (exactness). Per-query *leaf access* counts are tracked the
way the paper costs them: the AI path pays its predicted accesses, plus the
full R-tree visit set if it had to fall back.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.aitree import AITree, ai_query_compact
from repro_torch.core.classifiers.router import Router, route_high
from repro_torch.core.device_tree import DeviceTree
from repro_torch.core.grid import cells_of_queries
from repro_torch.core import traversal


@dataclasses.dataclass(frozen=True)
class HybridTree:
    tree: DeviceTree
    ait: AITree
    router: Router


class HybridResult(NamedTuple):
    routed_high: torch.Tensor    # [B] router verdict (True → AI path)
    used_ai: torch.Tensor        # [B] answered by the AI path (no fallback)
    n_results: torch.Tensor      # [B] qualifying points
    result_ids: torch.Tensor     # [B, max_results]
    leaf_accesses: torch.Tensor  # [B] paper cost unit (leaf I/Os)
    n_visited_r: torch.Tensor    # [B] classical visit count
    n_true: torch.Tensor         # [B] true leaf count
    truncated: torch.Tensor      # [B] R-path static bounds overflowed — the
    #                              scheduler re-serves these on a wide tier
    guarded: torch.Tensor        # [B] routed-high but demoted to the R path
    #                              by the cell guard
    mispredict: torch.Tensor     # [B] AI-path attempt hit the paper's
    #                              misprediction signal
    cell_id: torch.Tensor        # [B] i32 anchor grid cell of the query
    #                              (-1 on cell-window overflow)


def guard_demoted(ait: AITree, queries: torch.Tensor) -> torch.Tensor:
    """[B] bool: query overlaps a cell the guard holds back from the AI
    path (``cell_ok`` False — under-fit at build time)."""
    cell_ids, valid, _ = cells_of_queries(ait.grid, queries, ait.max_cells)
    return torch.any(valid & ~ait.cell_ok[cell_ids.long()], dim=-1)


def is_point_query(queries: torch.Tensor) -> torch.Tensor:
    """[B, 4] → [B] bool: degenerate rects (zero extent on both axes)."""
    q = queries.to(torch.float32)
    return (q[:, 0] == q[:, 2]) & (q[:, 1] == q[:, 3])


def point_query(h: HybridTree, queries: torch.Tensor, *,
                max_visited: int = 32, max_results: int = 64,
                force_path: str = "auto", guard: bool = True
                ) -> HybridResult:
    """Point-query fast path: degenerate rects served with single-cell
    AI routing (``max_cells=1``) and point-sized traversal bounds.
    Everything else is ``hybrid_query``; callers assert ``truncated``
    stays empty instead of re-serving."""
    ait1 = dataclasses.replace(h.ait, max_cells=1)
    h1 = dataclasses.replace(h, ait=ait1)
    return hybrid_query(h1, queries, max_visited=max_visited,
                        max_results=max_results, force_path=force_path,
                        guard=guard)


def hybrid_query(h: HybridTree, queries: torch.Tensor, *,
                 max_visited: int = 256, max_results: int = 512,
                 force_path: str = "auto", guard: bool = True
                 ) -> HybridResult:
    """Masked single-dispatch execution of both paths.

    ``force_path``: "auto" (router), "ai" (AI-tree only + fallback), or "r"
    (classical only) — the latter two give the paper's standalone baselines.

    ``guard`` (auto routing only): demote queries overlapping a not-ok
    cell (``AITree.cell_ok``) to the exact R path *before* prediction.
    The R path is the dense-mask ``range_query``, as in the reference.
    """
    if force_path not in ("auto", "ai", "r"):
        raise ValueError(f"force_path must be auto, ai or r, got "
                         f"{force_path!r}")
    queries = queries.to(torch.float32)
    B = queries.shape[0]
    dev = queries.device

    if force_path == "r":
        high = torch.zeros((B,), dtype=torch.bool, device=dev)
    elif force_path == "ai":
        high = torch.ones((B,), dtype=torch.bool, device=dev)
    else:
        high = route_high(h.router, queries)

    if guard and force_path == "auto":
        demoted = high & guard_demoted(h.ait, queries)
    else:
        demoted = torch.zeros((B,), dtype=torch.bool, device=dev)
    eligible = high & ~demoted

    ai = ai_query_compact(h.ait, h.tree, queries, max_results=max_results)
    r = traversal.range_query(h.tree, queries, max_visited=max_visited,
                              max_results=max_results)

    used_ai = eligible & ~ai.fallback
    n_results = torch.where(used_ai, ai.n_results, r.n_results)
    result_ids = torch.where(used_ai[:, None], ai.result_ids, r.result_ids)
    # cost accounting (paper §IV-A): AI path pays prediction + its accesses;
    # a fallback additionally pays the classical visit set. Guard-demoted
    # rows never reach prediction, so they pay the classical cost only.
    leaf_accesses = torch.where(
        eligible,
        ai.n_pred + torch.where(ai.fallback, r.n_visited, 0),
        r.n_visited,
    ).to(torch.int32)
    return HybridResult(
        routed_high=high,
        used_ai=used_ai,
        n_results=n_results,
        result_ids=result_ids,
        leaf_accesses=leaf_accesses,
        n_visited_r=r.n_visited,
        n_true=r.n_true,
        # only flag rows the R path answered — used_ai rows are exact
        truncated=r.truncated & ~used_ai,
        guarded=demoted,
        mispredict=eligible & ai.mispredict,
        cell_id=ai.cell_id,
    )
