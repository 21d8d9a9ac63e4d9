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
  point ids ``[L, M_pad]`` (pad = -1).

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


@dataclasses.dataclass(frozen=True)
class DeviceTree:
    levels: Tuple[Level, ...]        # levels[0] has exactly 1 node (the root)
    leaf_entries: torch.Tensor       # [L, M_pad, 2] f32, +inf padded
    leaf_entry_ids: torch.Tensor     # [L, M_pad] i32, -1 padded
    leaf_counts: torch.Tensor        # [L] i32
    n_points: int
    max_entries: int

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
            device: str | torch.device = "cuda") -> DeviceTree:
    """Flatten a host ``RTree`` to a ``DeviceTree`` on ``device``.

    ``pad_to`` overrides the per-leaf entry padding (defaults to ``tree.M``,
    rounded up to a multiple of 8).
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
    for depth, nodes in enumerate(level_nodes):
        mbrs = tree.mbrs[nodes].astype(np.float32)
        if depth == 0:
            parent = np.zeros((1,), dtype=np.int32)
        else:
            pos_above = {n: i for i, n in enumerate(level_nodes[depth - 1])}
            parent = np.array(
                [pos_above[tree.parent[n]] for n in nodes], dtype=np.int32)
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
    )
