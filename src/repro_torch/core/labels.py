"""Training-data preparation for the AI-tree (paper §III-A3..5).

Step 1: execute the query workload on the (device-form) R-tree, capturing for
every query the *visited* leaf IDs and the *true* leaf IDs (Table I).
Step 2: the query rectangle is the feature vector, the true leaf IDs are the
multi-hot class labels (Table II — one-hot per leaf, unioned).

Everything is batched through ``traversal.range_query`` — the DeviceTree's
leaf order *is* the paper's DFS leaf-ID order, so mask columns are labels.
Batches are zero-padded to ``batch_size`` rows, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device_tree import DeviceTree
from repro_torch.core import traversal


@dataclasses.dataclass
class Workload:
    """A labelled query workload over one tree."""
    queries: np.ndarray        # [Q, 4] f32
    visited: np.ndarray        # [Q, L] bool
    true_labels: np.ndarray    # [Q, L] bool — the multi-hot classifier target
    n_visited: np.ndarray      # [Q] i32
    n_true: np.ndarray         # [Q] i32
    n_results: np.ndarray      # [Q] i32
    alpha: np.ndarray          # [Q] f32

    @property
    def n_queries(self) -> int:
        return int(self.queries.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.true_labels.shape[1])


def make_workload(tree: DeviceTree, queries: np.ndarray, *,
                  batch_size: int = 256, max_visited: int = 256,
                  max_results: int = 1024) -> Workload:
    """Run the workload through the batched traversal and collect labels."""
    queries = np.asarray(queries, dtype=np.float32)
    Q = queries.shape[0]
    vis, tru, nv, nt, nr = [], [], [], [], []
    for o in range(0, Q, batch_size):
        qb = queries[o:o + batch_size]
        pad = batch_size - qb.shape[0]
        if pad:
            qb = np.concatenate([qb, np.zeros((pad, 4), np.float32)], axis=0)
        res = traversal.range_query(
            tree, torch.from_numpy(qb).to(tree.device),
            max_visited=max_visited, max_results=max_results)
        take = qb.shape[0] - pad
        vis.append(res.visited[:take].cpu().numpy())
        tru.append(res.true_leaves[:take].cpu().numpy())
        nv.append(res.n_visited[:take].cpu().numpy())
        nt.append(res.n_true[:take].cpu().numpy())
        nr.append(res.n_results[:take].cpu().numpy())
    n_visited = np.concatenate(nv)
    n_true = np.concatenate(nt)
    a = np.where(n_visited > 0, n_true / np.maximum(n_visited, 1), 1.0)
    return Workload(
        queries=queries,
        visited=np.concatenate(vis),
        true_labels=np.concatenate(tru),
        n_visited=n_visited,
        n_true=n_true,
        n_results=np.concatenate(nr),
        alpha=a.astype(np.float32),
    )
