"""Oblivious decision forests — the paper-faithful classifier family.

The paper uses multi-label decision trees (max_depth 30). Pointer trees do
not vectorize, so the bank holds the closest vectorizable member of the
family: **oblivious** trees, one (feature, threshold) test per depth
level, shared across the whole level, so evaluating a tree is ``D``
compares and one table-row read. Training is greedy top-down on host
numpy (``fit_forest``, the reference's, bit-equal under the same seed,
with a faster exact split search); the router (``classifiers.router``)
reuses the same trainer.

Inference on the device, two forms, as in the reference:

* ``cell_probs_for`` — the gathered ``[B, S, Cl]`` form the AI-tree
  serves through (``aitree.cell_slot_probs``): each (query, slot, tree)
  reads its one leaf row of its cell's table;
* ``cell_probs_dense`` — every cell for every query, ``[B, C, Cl]``,
  through ``kernels.ops.forest_infer_cells`` (the CUDA kernel on the
  card, its plain version on the CPU).

Multi-label handling: each leaf stores the mean multi-hot label vector of
the training queries that land in it; a forest's prediction is the mean
over its trees, thresholded by the AI-tree.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops, ref as kref


@dataclasses.dataclass(frozen=True)
class Forest:
    """A bank of per-cell oblivious forests, stacked for batched inference
    on one device: ``C`` cells × ``T`` trees × depth ``D`` × ``Cl`` local
    labels."""
    feat_idx: torch.Tensor   # [C, T, D] i32
    thresh: torch.Tensor     # [C, T, D] f32 (+inf: always left)
    tables: torch.Tensor     # [C, T, 2^D, Cl] f32 leaf label means
    label_map: torch.Tensor  # [C, Cl] i32
    lmask: torch.Tensor      # [C, Cl] bool

    @property
    def n_cells(self) -> int:
        return self.feat_idx.shape[0]

    @property
    def n_trees(self) -> int:
        return self.feat_idx.shape[1]

    @property
    def depth(self) -> int:
        return self.feat_idx.shape[2]

    def byte_size(self) -> int:
        return sum(a.numel() * a.element_size() for a in
                   (self.feat_idx, self.thresh, self.tables, self.label_map))


def _fit_oblivious_tree(X: np.ndarray, Y: np.ndarray, depth: int,
                        n_thresholds: int, rng: np.random.Generator
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy level-wise fit. X [n, F], Y [n, Cl] → (feat [D], th [D],
    table [2^D, Cl]). Split criterion: sum of per-leaf label variance
    (Brier impurity), the multi-label generalization of gini.

    The reference accumulates each candidate split's per-leaf label sums
    with ``np.add.at(sums, nl, Y)``, which walks all n·Cl entries. Here
    one ``np.bincount`` over Y's nonzero entries (in row-major order)
    does it: every bin receives the same nonzero terms in the same order
    (the zeros ``add.at`` also adds change no sum), so the sums, the
    impurities and the fitted arrays are bit-equal, and a candidate costs
    the nonzeros (a few labels per query) instead of n·Cl.
    """
    n, F = X.shape
    Cl = Y.shape[1]
    nz_r, nz_c = np.nonzero(Y)
    nz_w = Y[nz_r, nz_c].astype(np.float64)
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
                sums = np.bincount(nl[nz_r] * Cl + nz_c, weights=nz_w,
                                   minlength=n_leaves * 2 * Cl
                                   ).reshape(n_leaves * 2, Cl)
                cnts = np.bincount(nl, minlength=n_leaves * 2).astype(
                    np.float64)
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


def fit_forest(feats_pc: np.ndarray, labels_pc: np.ndarray,
               qmask: np.ndarray, label_map: np.ndarray, lmask: np.ndarray,
               *, n_trees: int = 1, depth: int = 8, n_thresholds: int = 16,
               bootstrap: bool = False, seed: int = 0,
               device: str | torch.device = "cuda") -> Forest:
    """Fit one oblivious forest per non-empty cell, on ``device``.

    Inputs are the padded stacks from ``CellDataset``: feats [C, Qp, F],
    labels [C, Qp, Cl]. ``n_trees > 1`` with ``bootstrap`` bags the
    cell's queries. An empty cell keeps ``thresh = +inf`` (every query
    goes left) and an all-zero table.
    """
    C, Qp, F = feats_pc.shape
    Cl = labels_pc.shape[-1]
    rng = np.random.default_rng(seed)
    fi = np.zeros((C, n_trees, depth), np.int32)
    th = np.full((C, n_trees, depth), np.inf, np.float32)  # inf → always-left
    tb = np.zeros((C, n_trees, 2 ** depth, Cl), np.float32)
    for c in range(C):
        sel = qmask[c]
        if not sel.any():
            continue
        X, Y = feats_pc[c][sel], labels_pc[c][sel]
        for t in range(n_trees):
            if bootstrap and X.shape[0] > 1:
                idx = rng.integers(0, X.shape[0], X.shape[0])
                Xt, Yt = X[idx], Y[idx]
            else:
                Xt, Yt = X, Y
            fi[c, t], th[c, t], tb[c, t] = _fit_oblivious_tree(
                Xt, Yt, depth, n_thresholds, rng)
    dev = resolve_device(device)
    return Forest(
        feat_idx=torch.from_numpy(fi).to(dev),
        thresh=torch.from_numpy(th).to(dev),
        tables=torch.from_numpy(tb).to(dev),
        label_map=torch.from_numpy(np.asarray(label_map, np.int32)).to(dev),
        lmask=torch.from_numpy(np.asarray(lmask, bool)).to(dev))


def cell_probs_for(forest: Forest, feats: torch.Tensor,
                   cell_ids: torch.Tensor) -> torch.Tensor:
    """Per-(query, cell-slot) forest prediction: feats [B, F] × cell_ids
    [B, S] → [B, S, Cl], the mean of the T trees' leaf rows.

    Each (query, slot, tree) reads only the one table row its leaf code
    names (``[B, S, T, Cl]``), never its cell's whole ``[T, 2^D, Cl]``
    table. Feature ids are taken as the reference's gather takes them
    (``ref.feature_ids``).
    """
    ci = cell_ids.long()
    x = feats.to(torch.float32)
    fi = kref.feature_ids(forest.feat_idx[ci], x.shape[1])  # [B, S, T, D]
    B, S, T, D = fi.shape
    sel = torch.gather(x, 1, fi.reshape(B, -1)).reshape(B, S, T, D)
    bits = (sel > forest.thresh[ci]).long()
    powers = 2 ** torch.arange(D - 1, -1, -1, dtype=torch.int64,
                               device=x.device)
    leaf = torch.sum(bits * powers, dim=-1)             # [B, S, T]
    t = torch.arange(T, device=x.device)
    votes = forest.tables[ci[:, :, None], t[None, None, :], leaf]
    return torch.mean(votes, dim=2)                     # [B, S, Cl]


def cell_probs_dense(forest: Forest, feats: torch.Tensor) -> torch.Tensor:
    """All-cells dense prediction: feats [B, F] → [B, C, Cl], each cell's
    T tree votes summed in tree order, then divided by T.

    One ``ops.forest_infer_cells`` call over the flattened (cell, tree)
    axis: the CUDA kernel for tensors on the card, its plain version on
    the CPU.
    """
    C, T, D = forest.feat_idx.shape
    Cl = forest.tables.shape[-1]
    votes = kops.forest_infer_cells(
        feats, forest.feat_idx.reshape(C * T, D),
        forest.thresh.reshape(C * T, D),
        forest.tables.reshape(C * T, 2 ** D, Cl), n_cells=C)
    return votes / T
