"""Oblivious decision trees — the router's host-side trainer.

An oblivious tree makes one (feature, threshold) test per depth level,
shared across the whole level, so evaluating it is ``D`` compares and one
table lookup (``kernels.ops.forest_infer``). Training is greedy top-down
on host numpy. The per-cell ``Forest`` classifier bank comes with a later
slice of the port; the router (``classifiers.router``) needs only this
trainer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _fit_oblivious_tree(X: np.ndarray, Y: np.ndarray, depth: int,
                        n_thresholds: int, rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy level-wise fit. X [n, F], Y [n, Cl] → (feat [D], th [D],
    table [2^D, Cl]). Split criterion: sum of per-leaf label variance
    (Brier impurity), the multi-label generalization of gini.
    """
    n, F = X.shape
    Cl = Y.shape[1]
    leaf = np.zeros(n, np.int64)
    feats = np.zeros(depth, np.int32)
    ths = np.zeros(depth, np.float32)
    for d in range(depth):
        best = (np.inf, 0, 0.0)
        n_leaves = 2 ** d
        for f in range(F):
            xs = X[:, f]
            qs = np.unique(np.quantile(
                xs, np.linspace(0.05, 0.95, n_thresholds)))
            for t in qs:
                bit = (xs > t).astype(np.int64)
                nl = leaf * 2 + bit
                # impurity = Σ_leaf Σ_label n_l p(1-p)
                sums = np.zeros((n_leaves * 2, Cl))
                cnts = np.zeros(n_leaves * 2)
                np.add.at(sums, nl, Y)
                np.add.at(cnts, nl, 1.0)
                nz = cnts > 0
                p = sums[nz] / cnts[nz, None]
                imp = float(np.sum(cnts[nz, None] * p * (1 - p)))
                if imp < best[0]:
                    best = (imp, f, float(t))
        feats[d] = best[1]
        ths[d] = best[2]
        leaf = leaf * 2 + (X[:, best[1]] > best[2]).astype(np.int64)
    table = np.zeros((2 ** depth, Cl), np.float32)
    cnts = np.zeros(2 ** depth)
    np.add.at(table, leaf, Y)
    np.add.at(cnts, leaf, 1.0)
    nz = cnts > 0
    table[nz] /= cnts[nz, None]
    return feats, ths, table
