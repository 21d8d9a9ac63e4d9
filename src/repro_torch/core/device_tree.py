"""Flattened, device-resident form of the R-tree.

The host ``RTree`` (pointer style) is converted to a structure-of-arrays
suitable for batched traversal on the card:

* one ``Level`` per tree depth, nodes ordered so that every parent's children
  are **contiguous** and leaf order equals the paper's DFS leaf-ID order
  (§III-A1 — sibling leaves get consecutive IDs);
* each level stores node MBRs ``[N_l, 4]`` and a ``parent`` index into the
  level above, so frontier expansion is one gather + one rect-intersection;
* the leaf level additionally stores a padded entry tensor ``[L, M_pad, 2]``
  (pad = +inf, so containment tests fail on padding) and the corresponding
  point ids ``[L, M_pad]`` (pad = -1);
* an ``AncestorTable`` of per-(internal level, leaf tile) ancestor windows,
  which the ancestor-sliced walks read so that their shared memory does
  not grow with the tree;
* a ``WalkPack``: the internal levels packed root first, each internal
  node's child range in the level below, and the host offsets — what the
  walk kernels take, built once per tree instead of on every batch.

All device tensors are float32/int32 — the f64 host build is only a builder.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.rtree import RTree


@dataclasses.dataclass(frozen=True)
class Level:
    mbrs: torch.Tensor    # [N_l, 4] f32
    parent: torch.Tensor  # [N_l] i32 index into previous level


# The ancestor table's defaults, the reference's (``DEF_TL`` and ``LANE`` of
# ``src/repro/kernels/traverse_fused.py``), so both packages build the same
# table from one tree.
SLICE_TL = 512      # leaves per tile
LANE = 128          # window width quantum


@dataclasses.dataclass(frozen=True)
class AncestorTable:
    """Per-(internal level, leaf tile) ancestor windows for the sliced walks.

    The level-order flatten gives every parent's children contiguous ids,
    so each ``tl``-wide leaf tile's ancestors at internal level ``l`` form
    a contiguous index range. ``starts[l, t]`` is the *block index* of the
    ``widths[l]``-wide aligned window holding that range (element offset
    ``starts[l, t] * widths[l]``); ``widths[l]`` is the smallest power-of-two
    multiple of ``LANE`` that puts every tile's range in one aligned window,
    capped at the lane-padded level width (the window is then the whole
    level). The sliced walks (``kernels.ops``) stage only each tile's
    windows, so their shared memory depends on ``widths`` and ``tl``, not
    on the tree's size.
    """
    starts: torch.Tensor        # [n_int, n_tiles] i32 window block indices
    widths: Tuple[int, ...]     # window width per internal level
    tl: int                     # leaves per tile

    @property
    def n_tiles(self) -> int:
        return int(self.starts.shape[1])


def build_ancestor_table(level_parents, *, tl: int | None = None,
                         device: str | torch.device | None = None
                         ) -> AncestorTable | None:
    """Host-side ancestor-window table of a level hierarchy.

    ``level_parents``: one ``[N_l]`` parent array (numpy or tensor) per
    level, root first, leaf level last (entry 0 of the root's is unused).
    ``tl`` defaults to ``SLICE_TL``. ``starts`` goes to ``device`` (the
    parents' device when they are tensors, else the CPU). Returns None
    for a single-level tree (root == leaves: nothing to slice).

    Ranges are taken bottom-up by min/max over each tile's slice; widths
    double from ``LANE`` until every tile's range fits one aligned window,
    capped at the lane-padded level width.
    """
    tl = int(tl or SLICE_TL)
    if device is None:
        first = level_parents[0]
        device = first.device if torch.is_tensor(first) else "cpu"
    parents = [p.cpu().numpy() if torch.is_tensor(p) else np.asarray(p)
               for p in level_parents]
    n_int = len(parents) - 1
    if n_int < 1:
        return None
    L = parents[-1].shape[0]
    n_tiles = -(-L // tl)
    los = np.empty((n_int, n_tiles), np.int64)
    his = np.empty((n_int, n_tiles), np.int64)
    edges = np.arange(0, L, tl)
    los[n_int - 1] = np.minimum.reduceat(parents[-1], edges)
    his[n_int - 1] = np.maximum.reduceat(parents[-1], edges)
    for l in range(n_int - 1, 0, -1):
        p = parents[l]
        for t in range(n_tiles):
            seg = p[los[l, t]:his[l, t] + 1]
            los[l - 1, t] = seg.min()
            his[l - 1, t] = seg.max()
    widths = []
    starts = np.zeros((n_int, n_tiles), np.int32)
    for l in range(n_int):
        cap = -(-max(parents[l].shape[0], 1) // LANE) * LANE
        w = LANE
        while w < cap and not np.all(los[l] // w == his[l] // w):
            w *= 2
        if w >= cap:
            w = cap          # the whole (lane-padded) level in one window
        else:
            starts[l] = (los[l] // w).astype(np.int32)
        widths.append(int(w))
    return AncestorTable(starts=torch.from_numpy(starts).to(device),
                         widths=tuple(widths), tl=tl)


@dataclasses.dataclass(frozen=True)
class WalkPack:
    """The walk kernels' per-tree arguments, built once per tree.

    ``flatten`` lays every parent's children out contiguously, in parent
    order, so each internal node owns the child range ``[first, end)`` of
    the level below (empty when it has no children). A walk that visits
    live nodes in increasing id and their children in order meets the
    visited leaves in id order. Internal level ``l`` lies at
    ``[offsets[l], offsets[l + 1])`` of the packed arrays.
    """
    int_mbrs: torch.Tensor      # [N_int, 4] f32, the internal levels
    int_parents: torch.Tensor   # [N_int] i32, into the level above
    child_ranges: torch.Tensor  # [N_int, 2] i32: [first, end) a node
    offsets: Tuple[int, ...]    # n_int + 1 host offsets into the packs
    level_sizes: Tuple[int, ...]  # nodes per level, leaves last


def child_ranges(parents, n_above: int) -> torch.Tensor:
    """``[n_above, 2]`` i32: each node's ``[first, end)`` among the nodes
    whose ``parents`` (an ``[N]`` int tensor into a level of ``n_above``
    nodes) name it. Raises ``ValueError`` unless the parents are
    non-decreasing and in ``[0, n_above)``: the children of each parent
    must be contiguous, in parent order."""
    p = parents.to(torch.int64)
    if p.numel() and (bool((p[1:] < p[:-1]).any()) or int(p[0]) < 0
                      or int(p[-1]) >= n_above):
        raise ValueError(
            "the walk needs each level's parents non-decreasing and inside "
            f"the level above ({n_above} nodes): children contiguous, in "
            "parent order, as flatten lays them out")
    nodes = torch.arange(n_above, dtype=torch.int64, device=p.device)
    return torch.stack([torch.searchsorted(p, nodes),
                        torch.searchsorted(p, nodes, right=True)],
                       dim=1).to(torch.int32)


def build_walk_pack(level_mbrs, level_parents) -> WalkPack:
    """The ``WalkPack`` of a level hierarchy (one ``[N_l, 4]`` MBR and one
    ``[N_l]`` parent tensor per level, root first, leaves last), on the
    tensors' device. Raises ``ValueError`` where ``child_ranges`` does."""
    sizes = tuple(int(m.shape[0]) for m in level_mbrs)
    dev = level_mbrs[0].device
    n_int = len(sizes) - 1
    offsets = [0]
    for n in sizes[:-1]:
        offsets.append(offsets[-1] + n)
    ranges = [child_ranges(level_parents[l + 1], sizes[l])
              for l in range(n_int)]
    if n_int:
        mbrs = torch.cat([m.to(torch.float32) for m in level_mbrs[:-1]])
        pars = torch.cat([p.to(torch.int32) for p in level_parents[:-1]])
        rng = torch.cat(ranges)
    else:
        mbrs = torch.empty((0, 4), dtype=torch.float32, device=dev)
        pars = torch.empty((0,), dtype=torch.int32, device=dev)
        rng = torch.empty((0, 2), dtype=torch.int32, device=dev)
    return WalkPack(int_mbrs=mbrs.contiguous(), int_parents=pars.contiguous(),
                    child_ranges=rng.contiguous(), offsets=tuple(offsets),
                    level_sizes=sizes)


@dataclasses.dataclass(frozen=True)
class DeviceTree:
    levels: Tuple[Level, ...]        # levels[0] has exactly 1 node (the root)
    leaf_entries: torch.Tensor       # [L, M_pad, 2] f32, +inf padded
    leaf_entry_ids: torch.Tensor     # [L, M_pad] i32, -1 padded
    leaf_counts: torch.Tensor        # [L] i32
    n_points: int
    max_entries: int
    # the sliced walks' windows; ``flatten`` always attaches them (None
    # for a single-level tree)
    aslices: AncestorTable | None = None
    # the walk kernels' packed levels and child ranges; ``flatten``
    # always attaches them (a tree without one is packed on each walk)
    wpack: WalkPack | None = None

    @property
    def n_leaves(self) -> int:
        return int(self.levels[-1].mbrs.shape[0])

    @property
    def leaf_mbrs(self) -> torch.Tensor:
        return self.levels[-1].mbrs

    @property
    def height(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.leaf_entries.device

    def byte_size(self) -> int:
        total = 0
        for lv in self.levels:
            total += lv.mbrs.numel() * 4 + lv.parent.numel() * 4
        total += self.leaf_entries.numel() * 4 + self.leaf_entry_ids.numel() * 4
        total += self.leaf_counts.numel() * 4
        return total


def flatten(tree: RTree, pad_to: int | None = None,
            device: str | torch.device = "cuda",
            slice_tl: int | None = None) -> DeviceTree:
    """Flatten a host ``RTree`` to a ``DeviceTree`` on ``device``.

    ``pad_to`` overrides the per-leaf entry padding (defaults to ``tree.M``,
    rounded up to a multiple of 8). ``slice_tl`` overrides the ancestor
    table's leaf tile (defaults to ``SLICE_TL``); the table and the
    ``WalkPack`` are always attached.
    """
    if tree.points is None:
        raise ValueError("flatten() needs a built tree")
    dev = resolve_device(device)
    M_pad = pad_to if pad_to is not None else tree.M
    M_pad = int(np.ceil(M_pad / 8) * 8)

    # ---- level-order walk with parent-ordered children (== DFS leaf order)
    level_nodes: List[List[int]] = [[tree.root]]
    while not all(tree.is_leaf[n] for n in level_nodes[-1]):
        nxt: List[int] = []
        for n in level_nodes[-1]:
            if tree.is_leaf[n]:
                raise ValueError("unbalanced host tree")
            nxt.extend(tree.children[n])
        level_nodes.append(nxt)

    levels: List[Level] = []
    np_parents: List[np.ndarray] = []
    for depth, nodes in enumerate(level_nodes):
        mbrs = tree.mbrs[nodes].astype(np.float32)
        if depth == 0:
            parent = np.zeros((1,), dtype=np.int32)
        else:
            pos_above = {n: i for i, n in enumerate(level_nodes[depth - 1])}
            parent = np.array(
                [pos_above[tree.parent[n]] for n in nodes], dtype=np.int32)
        np_parents.append(parent)
        levels.append(Level(mbrs=torch.from_numpy(mbrs).to(dev),
                            parent=torch.from_numpy(parent).to(dev)))

    # ---- leaf entries, padded
    leaves = level_nodes[-1]
    L = len(leaves)
    entries = np.full((L, M_pad, 2), np.inf, dtype=np.float32)
    entry_ids = np.full((L, M_pad), -1, dtype=np.int32)
    counts = np.zeros((L,), dtype=np.int32)
    for i, n in enumerate(leaves):
        ids = tree.children[n]
        k = len(ids)
        if k > M_pad:
            raise ValueError(f"leaf fill {k} exceeds pad {M_pad}")
        if k:
            entries[i, :k] = tree.points[ids].astype(np.float32)
            entry_ids[i, :k] = np.asarray(ids, dtype=np.int32)
        counts[i] = k

    return DeviceTree(
        levels=tuple(levels),
        leaf_entries=torch.from_numpy(entries).to(dev),
        leaf_entry_ids=torch.from_numpy(entry_ids).to(dev),
        leaf_counts=torch.from_numpy(counts).to(dev),
        n_points=int(tree.points.shape[0]),
        max_entries=tree.M,
        aslices=build_ancestor_table(np_parents, tl=slice_tl, device=dev),
        wpack=build_walk_pack([lv.mbrs for lv in levels],
                              [lv.parent for lv in levels]),
    )
