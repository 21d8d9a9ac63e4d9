"""Host-side R-tree builder (numpy) — the classical substrate of the paper.

The paper (§V-B1) constructs the R-tree with *one-at-a-time tuple insertion*
(to replicate a dynamic environment), Guttman's **linear** node-splitting
algorithm, and ``m = M/2``. That exact build path is implemented here, plus an
STR bulk loader as a beyond-paper option for fast test setup.

The host tree is a *builder*; query serving happens on device via the
flattened structure-of-arrays form (see ``device_tree.py`` / ``traversal.py``).
A reference host ``query()`` is kept for ground-truth label preparation
(§III-A4) and for property tests.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import geometry as geo


@dataclasses.dataclass
class RTreeStats:
    n_points: int
    n_leaves: int
    n_internal: int
    height: int  # number of levels, root = level 0
    max_entries: int
    min_entries: int
    array_bytes: int  # serialized structure-of-arrays footprint


class RTree:
    """Dynamic R-tree with Guttman linear split.

    Nodes live in parallel python/numpy storage:

    * ``self.mbrs``     — [cap, 4] float64 node MBRs
    * ``self.children`` — list of lists; for internal nodes: child node ids,
                          for leaves: entry (point) ids
    * ``self.is_leaf``  — list of bool
    * ``self.parent``   — list of Optional[int]
    """

    def __init__(self, max_entries: int = 200, min_entries: Optional[int] = None):
        if max_entries < 4:
            raise ValueError("max_entries must be >= 4")
        self.M = int(max_entries)
        self.m = int(min_entries) if min_entries is not None else self.M // 2
        if not (1 <= self.m <= self.M // 2):
            raise ValueError("min_entries must be in [1, M/2]")
        self._cap = 1024
        self.mbrs = np.full((self._cap, 4), np.nan, dtype=np.float64)
        self.children: List[List[int]] = []
        self.is_leaf: List[bool] = []
        self.parent: List[Optional[int]] = []
        self.n_nodes = 0
        self.root = self._new_node(is_leaf=True)
        self.points: Optional[np.ndarray] = None  # set by build()/insert_all()
        self._n_points = 0

    # -- node storage -------------------------------------------------------

    def _new_node(self, is_leaf: bool) -> int:
        if self.n_nodes == self._cap:
            self._cap *= 2
            grown = np.full((self._cap, 4), np.nan, dtype=np.float64)
            grown[: self.n_nodes] = self.mbrs[: self.n_nodes]
            self.mbrs = grown
        nid = self.n_nodes
        self.n_nodes += 1
        self.children.append([])
        self.is_leaf.append(is_leaf)
        self.parent.append(None)
        return nid

    # -- insertion (paper path) --------------------------------------------

    def insert_all(self, points: np.ndarray, progress_every: int = 0) -> "RTree":
        """One-at-a-time insertion of ``points`` [N, 2] (paper §V-B1)."""
        points = np.asarray(points, dtype=np.float64)
        if self.points is None:
            self.points = points
        else:
            self.points = np.concatenate([self.points, points], axis=0)
        for i in range(points.shape[0]):
            self._insert_one(self._n_points + i, points[i])
            if progress_every and (i + 1) % progress_every == 0:
                print(f"  inserted {i + 1}/{points.shape[0]}")
        self._n_points += points.shape[0]
        return self

    def _insert_one(self, pid: int, pt: np.ndarray) -> None:
        rect = np.array([pt[0], pt[1], pt[0], pt[1]], dtype=np.float64)
        leaf = self._choose_leaf(rect)
        self.children[leaf].append(pid)
        self._enlarge_upward(leaf, rect)
        if len(self.children[leaf]) > self.M:
            self._split(leaf)

    def _choose_leaf(self, rect: np.ndarray) -> int:
        node = self.root
        while not self.is_leaf[node]:
            kids = self.children[node]
            kid_mbrs = self.mbrs[kids]
            enl = geo.np_enlargement(kid_mbrs, rect[None, :])
            areas = geo.np_area(kid_mbrs)
            # least enlargement; ties by least area (Guttman).
            best = np.lexsort((areas, enl))[0]
            node = kids[best]
        return node

    def _enlarge_upward(self, node: int, rect: np.ndarray) -> None:
        cur: Optional[int] = node
        while cur is not None:
            mbr = self.mbrs[cur]
            if np.isnan(mbr[0]):
                self.mbrs[cur] = rect
            else:
                new = geo.np_union(mbr, rect)
                if np.array_equal(new, mbr):
                    return  # ancestors already cover it
                self.mbrs[cur] = new
            cur = self.parent[cur]

    # -- Guttman linear split ------------------------------------------------

    def _entry_rects(self, node: int) -> np.ndarray:
        """MBRs of a node's entries: child node MBRs or degenerate point rects."""
        if self.is_leaf[node]:
            pts = self.points[self.children[node]]
            return np.concatenate([pts, pts], axis=1)  # [k, 4]
        return self.mbrs[self.children[node]].copy()

    @staticmethod
    def _linear_pick_seeds(rects: np.ndarray) -> Tuple[int, int]:
        """Greatest normalized separation along any dimension (Guttman LINEAR)."""
        best_sep, seeds = -np.inf, (0, 1)
        for lo_ax, hi_ax in ((geo.XMIN, geo.XMAX), (geo.YMIN, geo.YMAX)):
            width = rects[:, hi_ax].max() - rects[:, lo_ax].min()
            if width <= 0:
                continue
            # entry with highest low side vs entry with lowest high side
            hi_lo = int(np.argmax(rects[:, lo_ax]))
            lo_hi = int(np.argmin(rects[:, hi_ax]))
            if hi_lo == lo_hi:
                continue
            sep = (rects[hi_lo, lo_ax] - rects[lo_hi, hi_ax]) / width
            if sep > best_sep:
                best_sep, seeds = sep, (hi_lo, lo_hi)
        if seeds[0] == seeds[1]:  # fully degenerate input; arbitrary split
            seeds = (0, 1)
        return seeds

    def _split(self, node: int) -> None:
        entries = self.children[node]
        rects = self._entry_rects(node)
        k = len(entries)
        s1, s2 = self._linear_pick_seeds(rects)
        g1, g2 = [s1], [s2]
        mbr1, mbr2 = rects[s1].copy(), rects[s2].copy()
        rest = [i for i in range(k) if i not in (s1, s2)]
        for i in rest:
            need1 = self.m - len(g1)
            need2 = self.m - len(g2)
            remaining = k - len(g1) - len(g2)
            if need1 >= remaining:  # must all go to g1 to reach min fill
                g1.append(i)
                mbr1 = geo.np_union(mbr1, rects[i])
                continue
            if need2 >= remaining:
                g2.append(i)
                mbr2 = geo.np_union(mbr2, rects[i])
                continue
            d1 = geo.np_enlargement(mbr1, rects[i])
            d2 = geo.np_enlargement(mbr2, rects[i])
            if d1 < d2 or (d1 == d2 and geo.np_area(mbr1) <= geo.np_area(mbr2)):
                g1.append(i)
                mbr1 = geo.np_union(mbr1, rects[i])
            else:
                g2.append(i)
                mbr2 = geo.np_union(mbr2, rects[i])

        sibling = self._new_node(is_leaf=self.is_leaf[node])
        ids = entries  # original entry ids
        self.children[node] = [ids[i] for i in g1]
        self.children[sibling] = [ids[i] for i in g2]
        self.mbrs[node] = mbr1
        self.mbrs[sibling] = mbr2
        if not self.is_leaf[node]:
            for c in self.children[sibling]:
                self.parent[c] = sibling

        par = self.parent[node]
        if par is None:  # root split → grow tree
            new_root = self._new_node(is_leaf=False)
            self.children[new_root] = [node, sibling]
            self.parent[node] = new_root
            self.parent[sibling] = new_root
            self.mbrs[new_root] = geo.np_union(mbr1, mbr2)
            self.root = new_root
        else:
            self.parent[sibling] = par
            self.children[par].append(sibling)
            # parent MBR already covers both halves (it covered the original)
            if len(self.children[par]) > self.M:
                self._split(par)

    # -- STR bulk load (beyond-paper fast path) ------------------------------

    @classmethod
    def str_bulk(cls, points: np.ndarray, max_entries: int = 200,
                 min_entries: Optional[int] = None, fill: float = 0.7) -> "RTree":
        """Sort-Tile-Recursive bulk load. Produces a packed tree quickly; used
        by tests and as a baseline-quality comparison (the paper's dynamic
        build deliberately has worse overlap)."""
        points = np.asarray(points, dtype=np.float64)
        tree = cls(max_entries=max_entries, min_entries=min_entries)
        tree.points = points
        tree._n_points = points.shape[0]
        cap = max(2, int(tree.M * fill))
        n = points.shape[0]
        # --- leaf level via STR tiling
        order = np.argsort(points[:, 0], kind="stable")
        n_leaves = int(np.ceil(n / cap))
        n_slices = int(np.ceil(np.sqrt(n_leaves)))
        per_slice = int(np.ceil(n / n_slices))
        leaf_ids: List[int] = []
        for s in range(n_slices):
            sl = order[s * per_slice:(s + 1) * per_slice]
            if sl.size == 0:
                continue
            sl = sl[np.argsort(points[sl, 1], kind="stable")]
            for o in range(0, sl.size, cap):
                grp = sl[o:o + cap]
                nid = tree._new_node(is_leaf=True)
                tree.children[nid] = grp.tolist()
                tree.mbrs[nid] = geo.np_mbr_of_points(points[grp])
                leaf_ids.append(nid)
        # --- build upward
        level = leaf_ids
        while len(level) > 1:
            nxt: List[int] = []
            for o in range(0, len(level), cap):
                grp = level[o:o + cap]
                nid = tree._new_node(is_leaf=False)
                tree.children[nid] = grp
                for c in grp:
                    tree.parent[c] = nid
                tree.mbrs[nid] = geo.np_mbr_of_rects(tree.mbrs[grp])
                nxt.append(nid)
            level = nxt
        tree.root = level[0]
        # drop the unused node 0 created by __init__ if it is empty & orphaned
        if tree.root != 0 and not tree.children[0]:
            tree.mbrs[0] = np.array([np.inf, np.inf, -np.inf, -np.inf])
        return tree

    # -- host reference query (ground truth for labels & tests) --------------

    def query(self, rect: np.ndarray) -> Tuple[List[int], List[int], np.ndarray]:
        """Classical recursive range query.

        Returns ``(visited_leaf_node_ids, true_leaf_node_ids, result_point_ids)``
        where *visited* leaves are every leaf whose MBR intersects ``rect`` and
        *true* leaves are those actually containing qualifying points (§III-A2).
        """
        rect = np.asarray(rect, dtype=np.float64)
        visited: List[int] = []
        true: List[int] = []
        results: List[np.ndarray] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            mbr = self.mbrs[node]
            if np.isnan(mbr[0]) or not geo.np_intersects(mbr, rect):
                continue
            if self.is_leaf[node]:
                visited.append(node)
                if self.children[node]:
                    pts_idx = np.asarray(self.children[node])
                    inside = geo.np_contains_point(rect, self.points[pts_idx])
                    if inside.any():
                        true.append(node)
                        results.append(pts_idx[inside])
            else:
                # push in reverse so traversal order matches DFS child order
                stack.extend(reversed(self.children[node]))
        out = np.concatenate(results) if results else np.empty((0,), dtype=np.int64)
        return visited, true, out

    # -- introspection --------------------------------------------------------

    def leaves_dfs(self) -> List[int]:
        """Leaf node ids in DFS order (§III-A1 — consecutive sibling IDs)."""
        order: List[int] = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            if self.is_leaf[node]:
                order.append(node)
            else:
                stack.extend(reversed(self.children[node]))
        return order

    def height(self) -> int:
        h, node = 1, self.root
        while not self.is_leaf[node]:
            node = self.children[node][0]
            h += 1
        return h

    def stats(self) -> RTreeStats:
        n_leaves = sum(1 for i in range(self.n_nodes) if self.is_leaf[i] and
                       (self.children[i] or i == self.root))
        n_internal = sum(1 for i in range(self.n_nodes) if not self.is_leaf[i])
        entry_bytes = sum(len(self.children[i]) for i in range(self.n_nodes)) * 8
        mbr_bytes = self.n_nodes * 4 * 8
        return RTreeStats(
            n_points=self._n_points,
            n_leaves=n_leaves,
            n_internal=n_internal,
            height=self.height(),
            max_entries=self.M,
            min_entries=self.m,
            array_bytes=entry_bytes + mbr_bytes,
        )

    # -- invariants (property tests) -----------------------------------------

    def check_invariants(self) -> None:
        """Raise AssertionError if any classical R-tree invariant is violated."""
        assert self.points is not None
        depth_of: dict = {self.root: 0}
        stack = [self.root]
        leaf_depths = set()
        seen_points: List[int] = []
        while stack:
            node = stack.pop()
            mbr = self.mbrs[node]
            kids = self.children[node]
            if node != self.root and not self.is_leaf[node]:
                assert self.m <= len(kids) <= self.M, (
                    f"internal fill {len(kids)} outside [{self.m},{self.M}]")
            if self.is_leaf[node]:
                leaf_depths.add(depth_of[node])
                if node != self.root:
                    assert self.m <= len(kids) <= self.M, (
                        f"leaf fill {len(kids)} outside [{self.m},{self.M}]")
                if kids:
                    pts = self.points[kids]
                    got = geo.np_mbr_of_points(pts)
                    assert np.allclose(got, mbr), "leaf MBR != tight MBR of points"
                    seen_points.extend(kids)
            else:
                assert kids, "internal node with no children"
                kid_mbr = geo.np_mbr_of_rects(self.mbrs[kids])
                assert np.allclose(kid_mbr, mbr), "internal MBR != union of children"
                for c in kids:
                    assert self.parent[c] == node, "parent pointer broken"
                    depth_of[c] = depth_of[node] + 1
                stack.extend(kids)
        assert len(leaf_depths) <= 1, f"unbalanced: leaf depths {leaf_depths}"
        assert sorted(seen_points) == list(range(self._n_points)), (
            "points lost or duplicated across leaves")
