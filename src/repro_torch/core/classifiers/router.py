"""The binary high/low-overlap query router (paper §IV, §V-C2).

The paper uses a scikit-learn random forest trained to *generalize* (80/20
split, ~80% accuracy). The router is bagged oblivious trees (host-trained,
device-evaluated through ``kernels.ops.forest_infer``) over simple
geometric features of the query rectangle.

Label convention: ``1`` ⇔ high-overlap ⇔ α ≤ τ ⇔ route to the AI-tree.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.classifiers.forest import _fit_oblivious_tree
from repro_torch.kernels import ops as kops


def router_features(queries: torch.Tensor) -> torch.Tensor:
    """[Q, 4] rects → [Q, 6] features: corners + width/height.

    The single feature map of the router: device inference
    (``predict_proba``) and the host trainer both call it.
    """
    q = queries.to(torch.float32)
    return torch.cat([q, (q[:, 2] - q[:, 0])[:, None],
                      (q[:, 3] - q[:, 1])[:, None]], dim=1)


@dataclasses.dataclass(frozen=True)
class Router:
    feat_idx: torch.Tensor   # [T, D] i32
    thresh: torch.Tensor     # [T, D] f32
    tables: torch.Tensor     # [T, 2^D, 1] f32 — P(high-overlap) per leaf
    tau: float

    def byte_size(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.feat_idx, self.thresh, self.tables))


def predict_proba(router: Router, queries: torch.Tensor) -> torch.Tensor:
    """[B, 4] → [B] P(high-overlap), through the forest kernel."""
    votes = kops.forest_infer(router_features(queries), router.feat_idx,
                              router.thresh, router.tables)   # [B, 1]
    return votes[:, 0] / router.feat_idx.shape[0]


def route_high(router: Router, queries: torch.Tensor,
               threshold: float = 0.5) -> torch.Tensor:
    """[B, 4] → [B] bool — True ⇒ send to the AI-tree."""
    return predict_proba(router, queries) > threshold


@dataclasses.dataclass
class RouterReport:
    train_acc: float
    test_acc: float
    n_train: int
    n_test: int
    base_rate: float  # fraction of high-overlap queries overall


def train_router(queries: np.ndarray, alpha: np.ndarray, *, tau: float = 0.75,
                 n_trees: int = 16, depth: int = 6, n_thresholds: int = 16,
                 test_frac: float = 0.2, seed: int = 0,
                 device: str | torch.device = "cuda"
                 ) -> Tuple[Router, RouterReport]:
    """80/20 split training (paper §V-C2); reports both-set accuracy.
    The fitted router's tensors live on ``device``."""
    rng = np.random.default_rng(seed)
    X = router_features(torch.from_numpy(
        np.asarray(queries, np.float32))).numpy()
    y = (np.asarray(alpha) <= tau).astype(np.float32)[:, None]
    n = X.shape[0]
    perm = rng.permutation(n)
    n_test = max(1, int(n * test_frac))
    test, train = perm[:n_test], perm[n_test:]
    Xtr, ytr = X[train], y[train]

    fis, ths, tbs = [], [], []
    for t in range(n_trees):
        idx = rng.integers(0, Xtr.shape[0], Xtr.shape[0])  # bootstrap
        fi, th, tb = _fit_oblivious_tree(
            Xtr[idx], ytr[idx], depth, n_thresholds, rng)
        fis.append(fi)
        ths.append(th)
        tbs.append(tb)
    dev = torch.device(device)
    router = Router(
        feat_idx=torch.from_numpy(np.stack(fis)).to(dev),
        thresh=torch.from_numpy(np.stack(ths)).to(dev),
        tables=torch.from_numpy(np.stack(tbs)).to(dev),
        tau=float(tau),
    )

    def acc(idx: np.ndarray) -> float:
        q = torch.from_numpy(np.asarray(queries[idx], np.float32)).to(dev)
        p = predict_proba(router, q).cpu().numpy()
        return float(np.mean((p > 0.5) == (y[idx, 0] > 0.5)))

    report = RouterReport(
        train_acc=acc(train), test_acc=acc(test), n_train=len(train),
        n_test=len(test), base_rate=float(y.mean()))
    return router, report
