"""Cell-span invalidation: which grid cells does a tree change touch?

The online refit pipeline (``build.refit_cells``) retrains only the cells
whose *leaf span* changed across an insert/repack, so the maintenance
loop needs a sound, cheap answer to "did cell ``c``'s world move?". This
module defines that answer:

  * a leaf's **signature** is the sorted tuple of its entry point-ids —
    stable across rebuilds (ids are preserved by ``delta.repack``) and
    unique per leaf (leaves partition the points, so two leaves can only
    share a signature if both are the same set — impossible while they
    are disjoint and non-empty);
  * a cell's **span** is the frozenset of signatures of every leaf whose
    MBR intersects the cell's rectangle *dilated by one cell width per
    side*.

Soundness of the dilation (why an unchanged span ⇒ the cell's model and
certification stay valid): a non-overflow query assigned to cell ``c``
overlaps at most a ``side×side`` window of cells anchored at ``c``
(``grid.cells_of_queries``, side = √max_cells, i.e. 2 for the default
``max_cells=4``), so the query rect — clipped to the grid bbox the
training queries were fit inside — lies within ``c``'s rect dilated by
``side - 1`` cell widths. Every leaf such a query's refinement can touch
intersects the query rect and hence the dilated rect: the cell's true
labels are a function of the span alone. Equal spans ⇒ identical leaf
geometry and contents over everything the cell's queries can see ⇒ the
retrained-model-would-be-identical and the exactness certificates carry
over (after renaming leaf ids through ``leaf_remap``).

An insert always changes the receiving cells' spans: the staged point
lands in some leaf at the next repack, growing that leaf's signature.

Host numpy, as in the JAX package: the device tree and the grid are read
back once per call (``.cpu().numpy()``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.device_tree import DeviceTree
from repro_torch.core.grid import Grid


def leaf_signatures(dtree: DeviceTree) -> list[bytes]:
    """[L] per-leaf stable identity: sorted entry point-ids as bytes."""
    ids = dtree.leaf_entry_ids.cpu().numpy()
    counts = dtree.leaf_counts.cpu().numpy()
    return [np.sort(ids[l, :counts[l]]).astype(np.int64).tobytes()
            for l in range(ids.shape[0])]


def cell_spans(dtree: DeviceTree, grid: Grid, *, dilate: int = 1,
               sigs: list[bytes] | None = None) -> list[frozenset]:
    """[g*g] per-cell leaf spans (cell id = cy * g + cx, as everywhere).

    ``dilate`` is in cell widths per side and must be ≥ ``side - 1`` of
    the serving window (1 for the default ``max_cells=4``).
    """
    g = grid.g
    x0, y0, x1, y1 = (float(v) for v in grid.bbox.cpu().numpy())
    cw = (x1 - x0) / g
    ch = (y1 - y0) / g
    if sigs is None:
        sigs = leaf_signatures(dtree)
    mbrs = dtree.leaf_mbrs.cpu().numpy()                   # [L, 4]
    spans: list[frozenset] = []
    for cy in range(g):
        for cx in range(g):
            rx0 = x0 + (cx - dilate) * cw
            ry0 = y0 + (cy - dilate) * ch
            rx1 = x0 + (cx + 1 + dilate) * cw
            ry1 = y0 + (cy + 1 + dilate) * ch
            hit = ((mbrs[:, 0] <= rx1) & (rx0 <= mbrs[:, 2])
                   & (mbrs[:, 1] <= ry1) & (ry0 <= mbrs[:, 3]))
            spans.append(frozenset(sigs[l] for l in np.flatnonzero(hit)))
    return spans


def diff_spans(old_spans: list[frozenset], new_spans: list[frozenset],
               old_sigs: list[bytes], new_sigs: list[bytes]
               ) -> tuple[np.ndarray, np.ndarray]:
    """Compare spans across a tree change.

    Returns ``(changed [C] bool, leaf_remap [L_old] i32)``: ``changed[c]``
    iff cell ``c``'s span differs (its model must retrain and its
    certificates are void); ``leaf_remap[l]`` is the new DFS leaf id of
    the old leaf with signature ``old_sigs[l]``, or -1 if no new leaf has
    that exact point set. Signatures are unique per tree (disjoint
    non-empty point sets), so the remap is well-defined.
    """
    assert len(old_spans) == len(new_spans), "span diff needs equal grids"
    changed = np.array([o != n for o, n in zip(old_spans, new_spans)], bool)
    pos = {s: i for i, s in enumerate(new_sigs)}
    remap = np.array([pos.get(s, -1) for s in old_sigs], np.int32)
    return changed, remap


def remap_label_map(label_map: np.ndarray, lmask: np.ndarray,
                    leaf_remap: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Rewrite a bank's global leaf ids through ``leaf_remap``.

    For cells whose span did NOT change, every in-span leaf survives with
    the same signature, and every label the cell's training queries
    produced is in-span (see module docstring) — so no valid slot maps to
    -1 in practice. Defensively, a slot whose leaf vanished is cleared
    (map -1, mask off): ``global_scores`` then parks it at the out-of-
    range column and it can never score a leaf.
    """
    lm = np.asarray(label_map)
    msk = np.asarray(lmask).copy()
    out = np.where(msk, leaf_remap[np.where(msk, lm, 0)], -1).astype(np.int32)
    msk &= out >= 0
    return out, msk
