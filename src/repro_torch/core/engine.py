"""Batched serving engine for the "AI+R"-tree, over one rank or a mesh.

The reference's engine (``src/repro/core/engine.py``) is a ``shard_map``
over a (pod, data, model) mesh: queries split over (pod, data), leaf
entries and grid-cell experts over ``model``, with two collectives a
batch over ``model`` (a ``pmax`` of the dense score union, ``psum``s of
the refine counts). Here every stage takes a ``ModelAxis``: at one rank
its collectives are identities (``ONE_RANK``); past one rank they act on
a ``torch.distributed`` process group (``model_axis(n, group)``), and
each rank serves its shard of the padded hybrid (``shard_for_rank``).
The data axis, the rows of a batch, is ``launch.mesh``'s.

A serve step is a composition of stages, each a function of the hybrid
tree and the query batch:

* ``_r_path`` — the classical path: the compact walk
  (``traversal.visited_leaves_compact`` → ``ops.traverse_compact``, the
  ``[B, L]`` visited mask never exists on the card) and the shared
  refine stage;
* ``_ai_path`` — the learned path: grid routing, the cell guard, the
  score union (``topk``: compact prediction slots, with an MLP bank on
  the card ``ops.mlp_predict_compact``, united across shards through the
  all-gathered slot lists; ``pmax``: the paper's dense ``[B, L]`` union)
  and the shared refine stage;
* ``_delta_path`` — the insert buffer's hit count (``ops.delta_probe``);
* ``_route_combine`` — the router (``ops.forest_infer``) and the
  paper's cost accounting.

``_refine_slots`` is the refine stage both paths share: a compact
``[B, K]`` slot table in (``ops.leaf_refine_counted``, one launch),
per-query counts out. The steps return ``ServeStats``;
``make_two_tier_steps`` pairs a narrow step with a wide one for the
scheduler's ``r_truncated`` re-serve (``schedule.serve_workload``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import traversal
from repro_torch.core.aitree import bank_n_cells, cell_slot_probs
from repro_torch.core.classifiers.forest import Forest
from repro_torch.core.classifiers.knn import KNNBank
from repro_torch.core.classifiers.mlp import MLPBank, global_scores
from repro_torch.core.classifiers.router import route_high
from repro_torch.core.device_tree import (
    Level, build_ancestor_table, build_walk_pack)
from repro_torch.core.grid import cells_of_queries
from repro_torch.core.hybrid import HybridTree
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's ``EngineConfig`` without ``use_kernel`` (the
    tensors' device picks kernel or plain version)."""
    max_visited: int = 64        # per-rank compact bound (R path)
    max_pred: int = 16           # per-rank compact bound (AI path)
    max_cells: int = 4
    threshold: float = 0.5
    # AI-path score union: "topk" (each rank's first max_pred distinct
    # predicted leaves) or "pmax" (the paper's dense [B, L] score union)
    score_union: str = "topk"
    # demote queries overlapping a not-ok cell (``AITree.cell_ok``) to the
    # exact R path before prediction
    guard: bool = True
    # delta-probe slot bound; only the exact per-query hit count is used
    delta_k: int = 64


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The reference's ``model`` mesh axis as the stages see it: this
    rank's ``index``, the axis ``size`` and its collectives over
    ``group``, a ``torch.distributed`` process group (None: the default
    group). At one rank every collective is the identity. Bools go
    through int32, as the reference's ``.astype(jnp.int32)`` does. With
    ``via_host`` (a ``gloo`` group) CUDA tensors are staged through host
    memory for the collective and come back on their device."""
    index: int = 0
    size: int = 1
    group: Any = None
    via_host: bool = False

    def _buffer(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh contiguous copy of ``x`` for a collective to fill."""
        dev = torch.device("cpu") if self.via_host else x.device
        dtype = torch.int32 if x.dtype == torch.bool else x.dtype
        return x.to(device=dev, dtype=dtype, copy=True).contiguous()

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return x
        buf = self._buffer(x)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the axis (int32 for a bool ``x``)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the axis."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in axis-index
        order (``jax.lax.all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return x
        buf = self._buffer(x)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        out = torch.cat(parts, dim=dim).to(x.device)
        return out.bool() if x.dtype == torch.bool else out


ONE_RANK = ModelAxis()


def model_axis(world_size: int = 1, group=None) -> ModelAxis:
    """The model axis of a ``world_size``-rank engine over ``group`` (a
    ``torch.distributed`` process group; None: the default group). One
    rank is ``ONE_RANK``. More ranks need an initialised process group
    of exactly ``world_size`` ranks: ``RuntimeError`` when none is
    initialised, ``ValueError`` when its size differs."""
    if world_size == 1:
        return ONE_RANK
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a model axis of {world_size} ranks needs an initialised "
            "torch.distributed process group (init_process_group); none "
            "is, and one rank is never served in its place")
    size = dist.get_world_size(group)
    if size != world_size:
        raise ValueError(f"a model axis of {world_size} ranks got a group "
                         f"of {size}")
    return ModelAxis(index=dist.get_rank(group), size=size, group=group,
                     via_host=dist.get_backend(group) == "gloo")


def _pad_rows(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``a`` with ``n`` rows of ``fill`` appended along dim 0."""
    pad = torch.full((n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad])


def pad_tree_for_sharding(h: HybridTree, n_shards: int) -> HybridTree:
    """Pad leaf-level arrays (and expert cells) to multiples of
    ``n_shards``.

    Padding leaves get never-intersecting MBRs, +inf entries, -1 ids and
    the last real parent; padding cells get -1 label maps, empty label
    masks and ``cell_ok`` False. Semantics are unchanged. The ancestor
    table is rebuilt on the padded leaf axis where its tile grid divides
    evenly across the shards and dropped otherwise, as the reference
    does; the walk pack is rebuilt for a padded leaf level.
    """
    t = h.tree
    L = t.n_leaves
    Lp = -(-L // n_shards) * n_shards
    if Lp != L:
        pad = Lp - L
        dev = t.device
        never = torch.tensor([np.inf, np.inf, -np.inf, -np.inf],
                             dtype=torch.float32, device=dev)
        leaf = t.levels[-1]
        # the repeated last parent keeps the parents non-decreasing and
        # the rebuilt ancestor windows tight
        new_leaf = Level(
            mbrs=torch.cat([leaf.mbrs, never.expand(pad, 4)]),
            parent=torch.cat([leaf.parent, leaf.parent[-1:].expand(pad)]))
        levels = t.levels[:-1] + (new_leaf,)
        t = dataclasses.replace(
            t, levels=levels,
            leaf_entries=_pad_rows(t.leaf_entries, pad, np.inf),
            leaf_entry_ids=_pad_rows(t.leaf_entry_ids, pad, -1),
            leaf_counts=_pad_rows(t.leaf_counts, pad, 0),
            wpack=build_walk_pack([lv.mbrs for lv in levels],
                                  [lv.parent for lv in levels]))
    if t.aslices is not None:
        tl = t.aslices.tl
        if Lp % tl == 0 and (Lp // tl) % n_shards == 0:
            t = dataclasses.replace(t, aslices=build_ancestor_table(
                [lv.parent for lv in t.levels], tl=tl))
        else:
            t = dataclasses.replace(t, aslices=None)
    bank = h.ait.bank
    C = bank_n_cells(bank)
    Cp = -(-C // n_shards) * n_shards
    cell_ok = h.ait.cell_ok
    if Cp != C:
        pc = Cp - C
        cell_ok = _pad_rows(cell_ok, pc, False)
        common = dict(label_map=_pad_rows(bank.label_map, pc, -1),
                      lmask=_pad_rows(bank.lmask, pc, False))
        if isinstance(bank, KNNBank):
            bank = dataclasses.replace(
                bank, feats=_pad_rows(bank.feats, pc, np.inf),
                labels=_pad_rows(bank.labels, pc, 0), **common)
        elif isinstance(bank, MLPBank):
            bank = dataclasses.replace(
                bank, w1=_pad_rows(bank.w1, pc, 0),
                b1=_pad_rows(bank.b1, pc, 0), w2=_pad_rows(bank.w2, pc, 0),
                b2=_pad_rows(bank.b2, pc, 0), **common)
        else:   # the forest bank
            bank = dataclasses.replace(
                bank, feat_idx=_pad_rows(bank.feat_idx, pc, 0),
                thresh=_pad_rows(bank.thresh, pc, np.inf),
                tables=_pad_rows(bank.tables, pc, 0), **common)
    ait = dataclasses.replace(h.ait, bank=bank, cell_ok=cell_ok)
    return dataclasses.replace(h, tree=t, ait=ait)


# the bank fields split over the model axis, a row a cell (the reference's
# ``tree_shardings_p``); ``mu`` / ``sd`` and every other field replicate
_BANK_SHARDED = {
    KNNBank: ("feats", "labels", "label_map", "lmask"),
    MLPBank: ("w1", "b1", "w2", "b2", "label_map", "lmask"),
    Forest: ("feat_idx", "thresh", "tables", "label_map", "lmask"),
}


def shard_for_rank(h: HybridTree, axis: ModelAxis) -> HybridTree:
    """This rank's shard of a hybrid padded for ``axis.size`` shards
    (``pad_tree_for_sharding``): the reference's ``tree_shardings_p``
    split, taken at ``axis.index``.

    Split over the model axis, each rank keeping its contiguous run: the
    leaf level's ``mbrs`` and ``parent``, ``leaf_entries``,
    ``leaf_entry_ids`` and ``leaf_counts``; the ancestor table's
    ``starts`` columns (its leaf tiles); the bank's per-cell rows and
    ``cell_ok``. Everything else is replicated: the internal levels, the
    grid, the MLP bank's ``mu`` / ``sd`` and the router. The local leaf
    level's parents still index the replicated level above, so the walk
    pack is built anew from the local levels (``build_walk_pack``): a run
    of non-decreasing parents is non-decreasing, and internal nodes whose
    children live on another rank get empty child ranges. The shards are
    copies, so the padded hybrid can be freed.
    """
    n, r = axis.size, axis.index
    if n == 1:
        return h
    t = h.tree
    C = bank_n_cells(h.ait.bank)
    if t.n_leaves % n or C % n:
        raise ValueError(
            f"shard_for_rank: {t.n_leaves} leaves and {C} cells do not "
            f"split over {n} shards (pad_tree_for_sharding first)")

    def part(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
        w = a.shape[dim] // n
        piece = a.narrow(dim, r * w, w)
        return piece.clone(memory_format=torch.contiguous_format)
    leaf = t.levels[-1]
    levels = t.levels[:-1] + (Level(mbrs=part(leaf.mbrs),
                                    parent=part(leaf.parent)),)
    aslices = t.aslices
    if aslices is not None:
        if aslices.n_tiles % n or \
                aslices.n_tiles // n * aslices.tl != t.n_leaves // n:
            raise ValueError(
                f"shard_for_rank: an ancestor table of {aslices.n_tiles} "
                f"tiles of {aslices.tl} leaves does not match {n} shards "
                f"of {t.n_leaves // n} leaves")
        aslices = dataclasses.replace(aslices,
                                      starts=part(aslices.starts, 1))
    t = dataclasses.replace(
        t, levels=levels, leaf_entries=part(t.leaf_entries),
        leaf_entry_ids=part(t.leaf_entry_ids),
        leaf_counts=part(t.leaf_counts), aslices=aslices,
        wpack=build_walk_pack([lv.mbrs for lv in levels],
                              [lv.parent for lv in levels]))
    bank = h.ait.bank
    bank = dataclasses.replace(bank, **{
        f: part(getattr(bank, f)) for f in _BANK_SHARDED[type(bank)]})
    ait = dataclasses.replace(h.ait, bank=bank, cell_ok=part(h.ait.cell_ok))
    return dataclasses.replace(h, tree=t, ait=ait)


class ServeStats(NamedTuple):
    n_results: torch.Tensor      # [B] i32
    leaf_accesses: torch.Tensor  # [B] i32
    routed_high: torch.Tensor    # [B] bool
    used_ai: torch.Tensor        # [B] bool
    r_truncated: torch.Tensor    # [B] R-path refine bound overflow — the
    #                              caller re-serves these on the wide tier
    guarded: torch.Tensor        # [B] routed-high but demoted to the R path
    #                              by the cell guard
    delta_hits: torch.Tensor     # [B] i32 insert-buffer hits (already in
    #                              n_results; zeros without a buffer)
    mispredict: torch.Tensor     # [B] AI-path attempt hit the
    #                              misprediction signal
    cell_id: torch.Tensor        # [B] i32 anchor grid cell (-1 on window
    #                              overflow) — the monitor's key


class RPathOut(NamedTuple):
    """Per-query R-path stage output (collectives already reduced)."""
    r_counts: torch.Tensor     # [B] qualifying points via the classical path
    n_visited: torch.Tensor    # [B] classical visit count
    n_true: torch.Tensor       # [B] true-leaf count
    r_truncated: torch.Tensor  # [B] max_visited overflow on any rank


class AIPathOut(NamedTuple):
    """Per-query AI-path stage output (collectives already reduced)."""
    ai_counts: torch.Tensor    # [B] qualifying points via predicted leaves
    n_pred: torch.Tensor       # [B] predicted leaf accesses
    fallback: torch.Tensor     # [B] prediction unusable → R answer
    guarded: torch.Tensor      # [B] overlaps a not-ok cell → demoted
    mispredict: torch.Tensor   # [B] a predicted leaf held no qualifier
    cell_id: torch.Tensor      # [B] i32 anchor cell (-1 on window overflow)


class SlotRefineOut(NamedTuple):
    """Shared refine-stage output over one [B, K] slot table."""
    n_results: torch.Tensor    # [B] qualifying points across valid slots
    n_hit: torch.Tensor        # [B] valid slots with ≥ 1 qualifying point
    n_valid: torch.Tensor      # [B] valid slots


def _sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x.to(torch.int32), dim=-1, dtype=torch.int32)


def _refine_slots(h: HybridTree, queries: torch.Tensor,
                  leaf_idx: torch.Tensor, valid: torch.Tensor,
                  axis: ModelAxis) -> SlotRefineOut:
    """Shared refine stage: a compact ``[B, K]`` slot table of local leaf
    ids in, reduced per-query counts out. ``n_valid − n_hit > 0`` is the
    paper's misprediction signal."""
    counts = traversal.refine_leaves(h.tree, queries, leaf_idx,
                                     valid).counts
    return SlotRefineOut(
        n_results=axis.psum(_sum(counts * valid.to(torch.int32))),
        n_hit=axis.psum(_sum((counts > 0) & valid)),
        n_valid=axis.psum(_sum(valid)))


def _r_path(h: HybridTree, queries: torch.Tensor, cfg: EngineConfig,
            axis: ModelAxis) -> RPathOut:
    """Classical stage over the local leaf shard: the compact walk, then
    the shared refine stage."""
    cv = traversal.visited_leaves_compact(h.tree, queries, cfg.max_visited)
    r_trunc = axis.psum(cv.overflow.to(torch.int32)) > 0
    ro = _refine_slots(h, queries, cv.leaf_idx, cv.valid, axis)
    return RPathOut(r_counts=ro.n_results,
                    n_visited=axis.psum(cv.n_visited), n_true=ro.n_hit,
                    r_truncated=r_trunc)


def _ai_slots_topk(h: HybridTree, queries: torch.Tensor,
                   cfg: EngineConfig, loc_ids: torch.Tensor,
                   local: torch.Tensor, axis: ModelAxis, L_glob: int):
    """Compact prediction slots (``topk`` union): each rank compacts its
    local cells' predictions to the first ``max_pred`` distinct global
    leaf ids. With an MLP bank on the card this is the fused prediction
    kernel; otherwise ``compact_candidates`` over the [B, S·Cl] candidate
    labels. At one rank the slots are the answer. Past one, the
    all-gathered ``[B, size·k]`` slot lists are scattered into this
    rank's ``[B, L_loc]`` leaf range and compacted there; ``n_pred`` is
    the psum of the local counts (each distinct leaf lies in one rank's
    range), and any rank's overflow flags the row (a fallback, never a
    wrong answer).

    Returns ``(p_idx, p_valid, n_pred, overflow)``, ``p_idx`` local leaf
    ids.
    """
    B, k, bank = queries.shape[0], cfg.max_pred, h.ait.bank
    if h.ait.kind == "mlp" and queries.device.type == "cuda":
        idx, valid, cnt = kops.mlp_predict_compact(
            queries, bank, loc_ids, local, n_leaves=L_glob, k=k,
            threshold=cfg.threshold)
    else:
        probs = cell_slot_probs(h.ait, queries, loc_ids)
        li = loc_ids.long()
        ok = local[:, :, None] & bank.lmask[li] & (probs > cfg.threshold)
        idx, valid, cnt = traversal.compact_candidates(
            bank.label_map[li].reshape(B, -1), ok.reshape(B, -1), k)
    if axis.size == 1:
        return idx, valid, cnt, cnt > k
    trunc = axis.psum((cnt > k).to(torch.int32)) > 0
    ag_i = axis.all_gather(idx, 1)
    ag_v = axis.all_gather(valid, 1)
    L_loc = h.tree.n_leaves
    lo = axis.index * L_loc
    keep = ag_v & (ag_i >= lo) & (ag_i < lo + L_loc)
    li = torch.clamp(ag_i - lo, 0, L_loc - 1).long()
    pred = torch.zeros((B, L_loc), dtype=torch.int32, device=idx.device)
    pred = pred.scatter_reduce(1, li, keep.to(torch.int32), reduce="amax") > 0
    n_pred = axis.psum(_sum(pred))
    p_idx, p_valid, _ = traversal.compact_mask_counted(pred, k)
    return p_idx, p_valid, n_pred, (n_pred > k) | trunc


def _ai_path(h: HybridTree, queries: torch.Tensor, cfg: EngineConfig,
             axis: ModelAxis) -> AIPathOut:
    """Learned stage: per-cell experts → score union → shared refine.

    Both ``score_union`` modes end in the same compact ``[B, max_pred]``
    slot table handed to ``_refine_slots``."""
    L_loc = h.tree.n_leaves
    cell_ids, cvalid, cell_over = cells_of_queries(h.ait.grid, queries,
                                                   cfg.max_cells)
    C_loc = bank_n_cells(h.ait.bank)
    c0 = axis.index * C_loc
    local = (cell_ids >= c0) & (cell_ids < c0 + C_loc) & cvalid
    loc_ids = torch.clamp(cell_ids - c0, 0, C_loc - 1)
    if cfg.guard:
        bad = torch.any(local & ~h.ait.cell_ok[loc_ids.long()], dim=-1)
        guarded = axis.psum(bad.to(torch.int32)) > 0
    else:
        guarded = torch.zeros_like(cvalid[:, 0])
    L_glob = L_loc * axis.size
    if cfg.score_union == "pmax":
        probs = cell_slot_probs(h.ait, queries, loc_ids)
        scores = axis.pmax(global_scores(h.ait.bank, probs, local, loc_ids,
                                         L_glob))
        pred = scores > cfg.threshold
        lo = axis.index * L_loc
        n_pred = _sum(pred)
        p_idx, p_valid, p_cnt = traversal.compact_mask_counted(
            pred[:, lo:lo + L_loc], cfg.max_pred)
        over = (p_cnt > cfg.max_pred) | (n_pred > cfg.max_pred)
        over = axis.psum(over.to(torch.int32)) > 0
    elif cfg.score_union == "topk":
        p_idx, p_valid, n_pred, over = _ai_slots_topk(
            h, queries, cfg, loc_ids, local, axis, L_glob)
    else:
        raise ValueError(f"score_union must be topk or pmax, got "
                         f"{cfg.score_union!r}")
    ro = _refine_slots(h, queries, p_idx, p_valid, axis)
    mis = ro.n_valid > ro.n_hit
    fallback = (n_pred == 0) | mis | cell_over | over
    cell_id = torch.where(cvalid[:, 0], cell_ids[:, 0], -1).to(torch.int32)
    return AIPathOut(ai_counts=ro.n_results, n_pred=n_pred,
                     fallback=fallback, guarded=guarded, mispredict=mis,
                     cell_id=cell_id)


def _delta_path(queries: torch.Tensor, delta_xy: torch.Tensor,
                cfg: EngineConfig) -> torch.Tensor:
    """Freshness stage: the insert buffer's exact per-query hit count
    [B] i32 (``ops.delta_probe``). Staged points are invisible to both
    tree paths, so the count adds to whichever path answered."""
    return kops.delta_probe(queries, delta_xy, k=cfg.delta_k)[2]


def _route_combine(h: HybridTree, queries: torch.Tensor, rp: RPathOut,
                   ap: AIPathOut,
                   d_hits: Optional[torch.Tensor] = None) -> ServeStats:
    """Router dispatch and the paper's cost accounting over the stage
    outputs. Guard-demoted rows take the R answer and pay the classical
    cost only; only rows the R path answered report ``r_truncated``
    (``used_ai`` rows are exact), and only rows that attempted the AI
    path can mispredict."""
    high = route_high(h.router, queries)
    demoted = high & ap.guarded
    eligible = high & ~demoted
    used_ai = eligible & ~ap.fallback
    if d_hits is None:
        d_hits = torch.zeros_like(rp.r_counts)
    n_results = torch.where(used_ai, ap.ai_counts, rp.r_counts) + d_hits
    leaf_accesses = torch.where(
        eligible, ap.n_pred + torch.where(ap.fallback, rp.n_visited, 0),
        rp.n_visited)
    return ServeStats(n_results=n_results, leaf_accesses=leaf_accesses,
                      routed_high=high, used_ai=used_ai,
                      r_truncated=rp.r_truncated & ~used_ai,
                      guarded=demoted, delta_hits=d_hits,
                      mispredict=eligible & ap.mispredict,
                      cell_id=ap.cell_id)


ServeStep = Callable[..., ServeStats]


def make_serve_step(cfg: EngineConfig, *, kind: str,
                    axis: ModelAxis = ONE_RANK) -> ServeStep:
    """The hybrid serve step: ``(hybrid, queries [B, 4], delta_xy=None)
    → ServeStats``. ``delta_xy`` ([cap, 2] f32, +inf on unstaged slots —
    ``core.delta.DeltaStore.xy``) is the insert buffer; when passed, its
    hits fold into ``n_results``. ``kind`` names the hybrid's bank
    (``mlp``, ``knn`` or ``forest``), as in the reference."""
    if kind not in ("mlp", "knn", "forest"):
        raise ValueError(f"unknown bank kind {kind!r}")

    def serve_step(h: HybridTree, queries: torch.Tensor,
                   delta_xy: Optional[torch.Tensor] = None) -> ServeStats:
        if h.ait.kind != kind:
            raise ValueError(f"a {kind} step got a {h.ait.kind} bank")
        rp = _r_path(h, queries, cfg, axis)
        ap = _ai_path(h, queries, cfg, axis)
        d = None if delta_xy is None else _delta_path(queries, delta_xy,
                                                      cfg)
        return _route_combine(h, queries, rp, ap, d)

    return serve_step


def wide_config(cfg: EngineConfig, factor: int = 8) -> EngineConfig:
    """The wide-bound tier's config: ``max_visited`` scaled by ``factor``."""
    return dataclasses.replace(cfg, max_visited=cfg.max_visited * factor)


def point_config(cfg: EngineConfig, max_visited: int = 32) -> EngineConfig:
    """The point-query fast path's config: single-cell AI routing (a
    degenerate rect overlaps exactly one grid cell) and a traversal
    narrowed to point-sized bounds. No wide tier pairs with it — the
    caller asserts ``r_truncated`` stays empty instead."""
    return dataclasses.replace(cfg, max_cells=1,
                               max_visited=min(cfg.max_visited, max_visited))


def make_point_serve_step(cfg: EngineConfig, *, kind: str,
                          max_visited: int = 32,
                          axis: ModelAxis = ONE_RANK) -> ServeStep:
    """``make_serve_step`` for degenerate-rect point queries
    (``point_config``); the same closure shape as the range step."""
    return make_serve_step(point_config(cfg, max_visited), kind=kind,
                           axis=axis)


def make_two_tier_steps(cfg: EngineConfig, *, kind: str,
                        wide_factor: int = 8,
                        axis: ModelAxis = ONE_RANK
                        ) -> tuple[ServeStep, ServeStep]:
    """``(narrow_step, wide_step)`` realizing the ``r_truncated``
    contract: the scheduler (``schedule.serve_workload``) re-serves the
    narrow step's ``r_truncated`` rows through the wide step, whose
    ``max_visited`` is ``wide_factor``× larger."""
    return (make_serve_step(cfg, kind=kind, axis=axis),
            make_serve_step(wide_config(cfg, wide_factor), kind=kind,
                            axis=axis))
