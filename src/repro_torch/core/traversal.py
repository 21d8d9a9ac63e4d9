"""Batched, level-synchronous R-tree range queries on device.

The frontier at each level is a ``[B, N_l]`` boolean mask; expansion to the
next level is one gather (child → parent) plus one batched
rectangle-intersection. On a CUDA device the whole root→leaf walk is one
fused kernel (``kernels.ops.traverse_fused``), and on the serving paths
one kernel that also compacts the visited set into a slot table
(``kernels.ops.traverse_compact``: the ``[B, L]`` mask never exists); a
tree too large for one CTA's shared memory walks through its ancestor
windows (``DeviceTree.aslices``), and past even that level by level, one
``mbr_intersect`` launch a level that also folds in the level above's
mask through the parents. On the CPU the plain versions run the
per-level loop. Mask→index compaction is sort-free (prefix-count ranks +
a rowwise binary search).

Also implements the *refinement* step (exact point-in-rect filtering of the
visited/predicted leaves) and the overlap ratio α = TN/VN (§III-A2).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.device_tree import DeviceTree
from repro_torch.kernels import ops as kops, ref


def visited_leaf_mask(tree: DeviceTree, queries: torch.Tensor
                      ) -> torch.Tensor:
    """Leaves the classical R-tree would visit for each query: [B, L] bool.

    Exactly reproduces the recursive traversal's visited set: a leaf is
    visited iff every ancestor MBR (and its own) intersects the query.
    """
    return kops.traverse_fused(queries, [lv.mbrs for lv in tree.levels],
                               [lv.parent for lv in tree.levels],
                               slices=tree.aslices, pack=tree.wpack)


def visited_leaf_mask_per_level(tree: DeviceTree, queries: torch.Tensor
                                ) -> torch.Tensor:
    """Level-synchronous traversal in plain PyTorch on any device: one
    [B, N_l] intersection per level (the fused kernel's plain version)."""
    return ref.traverse_fused(queries, [lv.mbrs for lv in tree.levels],
                              [lv.parent for lv in tree.levels])


class RefineResult(NamedTuple):
    counts: torch.Tensor      # [B, K] qualifying points per (query, leaf slot)
    inside: torch.Tensor      # [B, K, M_pad] bool, per-entry containment
    leaf_idx: torch.Tensor    # [B, K] leaf ids refined (padding slots arbitrary)
    valid: torch.Tensor       # [B, K] slot validity


def _searchsorted_rows(cs: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the first position where the inclusive prefix count
    ``cs`` reaches 1..k (``searchsorted(side="left")``): [B, N] → [B, k]."""
    targets = torch.arange(1, k + 1, dtype=cs.dtype, device=cs.device)
    values = targets.expand(cs.shape[0], k).contiguous()
    return torch.searchsorted(cs, values, right=False)


def compact_mask_counted(mask: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, L] bool → (indices [B, k] i32, valid [B, k] bool, count [B] i32).

    Takes the first ``k`` set columns per row (column order). Sort-free:
    the ``j``-th set bit's column is the first position where the row's
    inclusive prefix count reaches ``j + 1``. ``count`` is the row's total
    set bits, so overflow (``count > k``) and validity come from the same
    scan. Invalid slots hold 0.
    """
    cs = torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)
    count = cs[:, -1]
    idx = _searchsorted_rows(cs, k)
    valid = torch.arange(k, dtype=torch.int32,
                         device=mask.device)[None, :] < count[:, None]
    return torch.where(valid, idx.to(torch.int32), 0), valid, count


def compact_mask(mask: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, L] bool → (indices [B, k] i32, valid [B, k] bool):
    ``compact_mask_counted`` without the count; overflow is reported by
    ``overflowed``."""
    idx, valid, _ = compact_mask_counted(mask, k)
    return idx, valid


def compact_candidates(ids: torch.Tensor, ok: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First ``k`` **distinct** ids (ascending) among masked candidates.

    ``ids`` [B, N] (≥ 0 where ``ok``), ``ok`` [B, N] bool → ``(slots
    [B, k] i32, valid [B, k] bool, count [B] i32)`` with ``count`` the
    distinct-id total. Equal to ``compact_mask_counted`` of the ids
    scattered into a ``[B, L]`` mask — same slot order, zero-filled
    invalid slots, same count — without that table, and without a
    ``[B, N, N]`` pairwise one: each row is sorted with the masked ids
    parked past every id, an id is kept where it differs from its left
    neighbour, and the prefix count of the kept ids ranks them.
    """
    park = torch.iinfo(torch.int64).max
    key = torch.where(ok, ids.to(torch.int64), park)
    srt, _ = torch.sort(key, dim=-1)
    first = torch.ones_like(ok)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    keep = first & (srt != park)
    cs = torch.cumsum(keep.to(torch.int32), dim=-1, dtype=torch.int32)
    count = cs[:, -1]
    pos = torch.clamp(_searchsorted_rows(cs, k), max=ids.shape[1] - 1)
    valid = torch.arange(k, dtype=torch.int32,
                         device=ids.device)[None, :] < count[:, None]
    # a negative id under ``ok`` lands as 0, as the reference's max-scatter
    # onto a zero table leaves it
    slots = torch.gather(srt, 1, pos).clamp(min=0)
    return torch.where(valid, slots, 0).to(torch.int32), valid, count


def _stable_topk(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of each row of a 0/1 ``key``, ties to
    the lower index (``lax.top_k``'s order): ``torch.topk`` of the
    distinct keys ``key·N + (N − 1 − i)``."""
    N = key.shape[-1]
    rank = torch.arange(N - 1, -1, -1, dtype=torch.int64, device=key.device)
    return torch.topk(key.to(torch.int64) * N + rank, k, dim=-1).indices


def compact_mask_topk(mask: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``top_k``-based compaction the sort-free one replaced, kept as
    its equivalence oracle: (indices [B, k] i32, valid [B, k] bool), the
    slots past the row width padded with (0, False)."""
    k_eff = min(k, mask.shape[-1])
    idx = _stable_topk(mask, k_eff)
    valid = torch.gather(mask.to(torch.bool), 1, idx)
    pad = (0, k - k_eff)
    return (torch.nn.functional.pad(idx, pad).to(torch.int32),
            torch.nn.functional.pad(valid, pad))


def overflowed(mask: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] → [B] bool: more than ``k`` set (a compaction would
    truncate)."""
    return torch.sum(mask.to(torch.int32), dim=-1, dtype=torch.int32) > k


def refine_leaves(tree: DeviceTree, queries: torch.Tensor,
                  leaf_idx: torch.Tensor, valid: torch.Tensor
                  ) -> RefineResult:
    """Exact containment test over the entries of selected leaves.

    ``queries``: [B, 4]; ``leaf_idx``: [B, K]; ``valid``: [B, K].
    Guarantees no false positives (paper §III-C): every reported entry is
    re-checked against the query rectangle.
    """
    inside, counts = kops.leaf_refine_counted(queries, tree.leaf_entries,
                                              leaf_idx, valid)
    return RefineResult(counts=counts, inside=inside, leaf_idx=leaf_idx,
                        valid=valid)


class CompactVisit(NamedTuple):
    leaf_idx: torch.Tensor    # [B, k] i32 — first k visited leaves, id order
    valid: torch.Tensor       # [B, k] bool slot validity
    n_visited: torch.Tensor   # [B] i32 total visited leaves (may exceed k)
    overflow: torch.Tensor    # [B] bool — more than k leaves visited


def visited_leaves_compact(tree: DeviceTree, queries: torch.Tensor, k: int
                           ) -> CompactVisit:
    """Classical visited set, compacted: the first ``k`` visited leaves
    per row (``kernels.ops.traverse_compact``)."""
    idx, valid, count = kops.traverse_compact(
        queries, [lv.mbrs for lv in tree.levels],
        [lv.parent for lv in tree.levels], k, slices=tree.aslices,
        pack=tree.wpack)
    return CompactVisit(leaf_idx=idx, valid=valid, n_visited=count,
                        overflow=count > k)


class QueryResult(NamedTuple):
    visited: torch.Tensor        # [B, L] bool — classical visited set
    true_leaves: torch.Tensor    # [B, L] bool — leaves with qualifying points
    n_visited: torch.Tensor      # [B] i32
    n_true: torch.Tensor         # [B] i32
    n_results: torch.Tensor      # [B] i32 total qualifying points
    result_ids: torch.Tensor     # [B, max_results] i32, -1 padded
    truncated: torch.Tensor      # [B] bool — static bounds overflowed


def scatter_rows(base: torch.Tensor, idx: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Rowwise max-scatter: base [B, L], idx [B, K], vals [B, K] → [B, L]."""
    return base.scatter_reduce(1, idx.long(), vals.to(base.dtype),
                               reduce="amax", include_self=True)


def gather_result_ids(tree: DeviceTree, refine: RefineResult,
                      max_results: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten qualifying entry ids to [B, max_results] (padded with -1).

    Sort-free, same scheme as ``compact_mask_counted``: the ``j``-th
    qualifying entry's flat (leaf-slot, entry) position is a rowwise binary
    search of ``j + 1`` over the inclusive prefix count.
    """
    li = torch.clamp(refine.leaf_idx.long(), 0, tree.n_leaves - 1)
    ids = tree.leaf_entry_ids[li]                          # [B, K, M]
    B = ids.shape[0]
    flat_ids = ids.reshape(B, -1)
    cs = torch.cumsum(refine.inside.reshape(B, -1).to(torch.int32), dim=-1,
                      dtype=torch.int32)
    pos = _searchsorted_rows(cs, max_results)
    n_in = cs[:, -1]
    targets = torch.arange(1, max_results + 1, dtype=torch.int32,
                           device=cs.device)
    valid = targets[None, :] <= n_in[:, None]
    safe = torch.clamp(pos, max=flat_ids.shape[-1] - 1)
    out = torch.where(valid, torch.gather(flat_ids, 1, safe), -1)
    return out.to(torch.int32), n_in > max_results


def gather_result_ids_topk(tree: DeviceTree, refine: RefineResult,
                           max_results: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``top_k``-based gather ``gather_result_ids`` replaced, kept as
    its equivalence oracle (``max_results`` ≤ K·M)."""
    li = torch.clamp(refine.leaf_idx.long(), 0, tree.n_leaves - 1)
    B = li.shape[0]
    flat_ids = tree.leaf_entry_ids[li].reshape(B, -1)
    flat_in = refine.inside.reshape(B, -1)
    slot = _stable_topk(flat_in, max_results)
    take = torch.gather(flat_in, 1, slot)
    out = torch.where(take, torch.gather(flat_ids, 1, slot), -1)
    return out.to(torch.int32), overflowed(flat_in, max_results)


def range_query(tree: DeviceTree, queries: torch.Tensor, *,
                max_visited: int = 256, max_results: int = 512
                ) -> QueryResult:
    """Full classical batched range query: traverse → compact → refine.

    This is the **R** path of the "AI+R"-tree. It also produces the
    (visited, true) leaf sets that define α and the training labels.
    """
    queries = queries.to(torch.float32)
    visited = visited_leaf_mask(tree, queries)                # [B, L]
    leaf_idx, valid, n_vis = compact_mask_counted(visited, max_visited)
    ref = refine_leaves(tree, queries, leaf_idx, valid)
    B, L = visited.shape
    true_rows = scatter_rows(
        torch.zeros((B, L), dtype=torch.int32, device=queries.device),
        leaf_idx, ((ref.counts > 0) & valid).to(torch.int32))
    true_leaves = true_rows > 0
    result_ids, trunc_r = gather_result_ids(tree, ref, max_results)
    trunc_v = n_vis > max_visited
    return QueryResult(
        visited=visited,
        true_leaves=true_leaves,
        n_visited=n_vis,
        n_true=torch.sum(true_leaves.to(torch.int32), dim=-1,
                         dtype=torch.int32),
        n_results=torch.sum(ref.counts * valid.to(torch.int32), dim=-1,
                            dtype=torch.int32),
        result_ids=result_ids,
        truncated=trunc_v | trunc_r,
    )


class CompactQueryResult(NamedTuple):
    leaf_idx: torch.Tensor       # [B, max_visited] i32 compacted visited set
    valid: torch.Tensor          # [B, max_visited] bool slot validity
    n_visited: torch.Tensor      # [B] i32
    n_true: torch.Tensor         # [B] i32
    n_results: torch.Tensor      # [B] i32 total qualifying points
    result_ids: torch.Tensor     # [B, max_results] i32, -1 padded
    truncated: torch.Tensor      # [B] bool — static bounds overflowed


def range_query_compact(tree: DeviceTree, queries: torch.Tensor, *,
                        max_visited: int = 256, max_results: int = 512
                        ) -> CompactQueryResult:
    """Serving-path classical range query: traverse+compact → refine.

    Per-field equal to ``range_query`` (``n_visited``/``n_true``/
    ``n_results``/``result_ids``/``truncated`` and the compacted slots),
    without the dense visited and true-leaf masks: use ``range_query``
    where those are needed (labels, α).
    """
    queries = queries.to(torch.float32)
    cv = visited_leaves_compact(tree, queries, max_visited)
    ref = refine_leaves(tree, queries, cv.leaf_idx, cv.valid)
    result_ids, trunc_r = gather_result_ids(tree, ref, max_results)
    validi = cv.valid.to(torch.int32)
    return CompactQueryResult(
        leaf_idx=cv.leaf_idx,
        valid=cv.valid,
        n_visited=cv.n_visited,
        # compacted slots hold distinct leaves, so the slot-level count is
        # the leaf-level count — no [B, L] scatter needed
        n_true=torch.sum((ref.counts > 0).to(torch.int32) * validi, dim=-1,
                         dtype=torch.int32),
        n_results=torch.sum(ref.counts * validi, dim=-1, dtype=torch.int32),
        result_ids=result_ids,
        truncated=cv.overflow | trunc_r,
    )


def alpha(n_true: torch.Tensor, n_visited: torch.Tensor) -> torch.Tensor:
    """Overlap ratio α = TN(Q)/VN(Q) ∈ [0, 1] (§III-A2).

    Queries that visit no leaves (empty region) get α = 1 — nothing was
    extraneous, so they are maximally low-overlap.
    """
    return torch.where(n_visited > 0,
                       n_true / torch.clamp(n_visited, min=1), 1.0)
