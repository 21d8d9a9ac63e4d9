"""Per-cell exact-memorization classifier (nearest-stored-query lookup).

The paper's decision trees (max_depth 30) effectively *memorize* the
training workload — that is what gives the AI-tree its 100% training-set
accuracy (§V-B3). This bank is the memorization-complete equivalent:
each cell stores its training queries and their label sets; at query
time the nearest stored query (L∞ over the rectangle corners) within ε
answers. Unseen queries (distance > ε) yield an empty prediction, which
triggers the hybrid's exact fallback. Fitting trains nothing, so a bank
is a deterministic function of its cell datasets — the property the
refit loop's parity with the JAX package rests on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.celldata import CellDataset


@dataclasses.dataclass(frozen=True)
class KNNBank:
    feats: torch.Tensor      # [C, Qp, F] stored queries (+inf padded)
    labels: torch.Tensor     # [C, Qp, Cl] stored multi-hot label sets
    label_map: torch.Tensor  # [C, Cl] i32
    lmask: torch.Tensor      # [C, Cl] bool
    eps: float

    @property
    def n_cells(self) -> int:
        return self.feats.shape[0]

    def byte_size(self) -> int:
        return sum(a.numel() * a.element_size() for a in
                   (self.feats, self.labels, self.label_map))


def fit_knn(ds: CellDataset, eps: float = 1e-6,
            device: str | torch.device = "cuda") -> KNNBank:
    dev = resolve_device(device)
    feats = ds.feats.copy()
    feats[~ds.qmask] = np.inf          # padding can never be nearest
    return KNNBank(
        feats=torch.from_numpy(feats).to(dev),
        labels=torch.from_numpy(np.asarray(ds.labels, np.float32)).to(dev),
        label_map=torch.from_numpy(ds.label_map).to(dev),
        lmask=torch.from_numpy(ds.lmask).to(dev),
        eps=float(eps),
    )


def cell_probs_for(bank: KNNBank, queries: torch.Tensor,
                   cell_ids: torch.Tensor) -> torch.Tensor:
    """[B, 4] × [B, S] → [B, S, Cl] — nearest stored query's labels, or 0s.

    Only the winning row's label vector is gathered ([B, S, Cl], not
    [B, S, Qp, Cl]). Ties go to the lowest stored row, as ``argmin`` does
    in both packages.
    """
    ci = cell_ids.long()
    stored = bank.feats[ci]                        # [B, S, Qp, F]
    q = queries.to(torch.float32)[:, None, None, :]
    d = torch.amax(torch.abs(torch.where(torch.isfinite(stored), stored,
                                         1e30) - q), dim=-1)  # [B, S, Qp]
    best = torch.argmin(d, dim=-1)                 # [B, S]
    bestd = torch.amin(d, dim=-1)
    hit = (bestd <= bank.eps)[..., None]           # [B, S, 1]
    picked = bank.labels[ci, best]                 # [B, S, Cl]
    return torch.where(hit, picked, 0.0)
