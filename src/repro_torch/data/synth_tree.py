"""Synthetic device-tree level hierarchies (no host RTree build).

Bottom-up construction: leaf MBRs are generated (optionally STR-packed so
sibling leaves are spatially tight, as a bulk-loaded R-tree would be), and
each level above unions ``fanout`` consecutive children — preserving the
contiguous-sibling invariant that ``device_tree.flatten`` guarantees.

Used by the walk tests and ``chip_smoke.py``, which need controlled shapes
(leaf counts off tile multiples, exact depths, levels past one CTA's
shared memory) that a real insert-built tree cannot pin down. Host numpy,
the same arrays as the reference's ``synth_levels`` from the same ``rng``.
"""
from __future__ import annotations

import numpy as np


def synth_levels(L: int, fanout: int, rng: np.random.Generator, *,
                 str_pack: bool = False, leaf_scale: float = 1.0,
                 leaf_width: float = 0.05):
    """Build level arrays for an ``L``-leaf, ``fanout``-ary hierarchy.

    Returns ``(mbrs, parents)``: one ``[N_l, 4]`` float32 and one ``[N_l]``
    int32 array per level, root first, leaf level last (``parents[0]`` is
    unused — the root has no parent).
    """
    sizes = [L]
    while sizes[0] > 1:
        sizes.insert(0, (sizes[0] + fanout - 1) // fanout)
    mbrs = [None] * len(sizes)
    parents = [np.zeros(s, np.int32) for s in sizes]

    lo = rng.uniform(-leaf_scale, leaf_scale, (L, 2))
    w = rng.uniform(0, leaf_width, (L, 2))
    if str_pack:
        # STR packing: sort by x, slab into √L chunks, sort each slab by y
        n_slabs = max(1, int(np.sqrt(L)))
        slab = L // n_slabs + 1
        order = np.argsort(lo[:, 0], kind="stable")
        for s in range(0, L, slab):
            chunk = order[s:s + slab]
            order[s:s + slab] = chunk[np.argsort(lo[chunk, 1],
                                                 kind="stable")]
        lo = lo[order]
        w = w[order]
    mbrs[-1] = np.concatenate([lo, lo + w], 1).astype(np.float32)

    for lvl in range(len(sizes) - 1, 0, -1):
        n, n_par = sizes[lvl], sizes[lvl - 1]
        par = np.minimum(np.arange(n) // fanout, n_par - 1).astype(np.int32)
        parents[lvl] = par
        # children are consecutive runs, so each parent's MBR is a
        # segment min/max (the reference's per-parent loop, vectorized)
        starts = np.flatnonzero(np.r_[True, par[1:] != par[:-1]])
        ch = mbrs[lvl]
        pm = np.empty((n_par, 4), np.float32)
        pm[:, 0] = np.minimum.reduceat(ch[:, 0], starts)
        pm[:, 1] = np.minimum.reduceat(ch[:, 1], starts)
        pm[:, 2] = np.maximum.reduceat(ch[:, 2], starts)
        pm[:, 3] = np.maximum.reduceat(ch[:, 3], starts)
        mbrs[lvl - 1] = pm
    return mbrs, parents
