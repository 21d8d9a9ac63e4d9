"""Stacked multi-label MLP experts — the cell classifier bank.

One tiny MLP per grid cell, all cells stacked into single tensors
``[C, ...]``. Serving runs only the ≤ ``max_cells`` experts a query
overlaps (``cell_logits_for`` here, or the fused CUDA kernel behind
``kernels.ops.mlp_predict_compact``).

The paper intentionally **overfits** its per-cell models (§III-B); training
is full-batch AdamW until the training workload is exactly fit (predicted
set == true set under the 0.5 threshold) or an epoch cap is hit. Residual
misfit is absorbed by the hybrid fallback rule and the cell guard.

Training is cell-granular, as in the reference: each cell's initial
weights come from its own ``default_rng((seed, cell, tensor))`` stream
(the reference's exact initial values), the normalizer derives from the
grid alone, the loss is a per-cell mean summed over cells, and a cell that
reaches exact fit at a ``check_every`` boundary freezes (parameters and
Adam state). The optimizer is written out by hand on autograd gradients;
its float32 trajectory is not bit-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.celldata import CellDataset


@dataclasses.dataclass(frozen=True)
class MLPBank:
    w1: torch.Tensor         # [C, F, H]
    b1: torch.Tensor         # [C, H]
    w2: torch.Tensor         # [C, H, Cl]
    b2: torch.Tensor         # [C, Cl]
    mu: torch.Tensor         # [F] feature normalizer
    sd: torch.Tensor         # [F]
    label_map: torch.Tensor  # [C, Cl] i32 (-1 pad)
    lmask: torch.Tensor      # [C, Cl] bool

    @property
    def n_cells(self) -> int:
        return self.w1.shape[0]

    @property
    def n_local_labels(self) -> int:
        return self.w2.shape[-1]

    def byte_size(self) -> int:
        return sum(a.numel() * a.element_size() for a in
                   (self.w1, self.b1, self.w2, self.b2, self.label_map))


def cell_logits_for(bank: MLPBank, feats: torch.Tensor,
                    cell_ids: torch.Tensor) -> torch.Tensor:
    """Gathered forward for (query, cell-slot) pairs.

    feats [B, F], cell_ids [B, S] → logits [B, S, Cl] (sum over F, then
    over H).
    """
    x = (feats - bank.mu) / bank.sd
    ci = cell_ids.long()
    h = torch.relu(torch.einsum("bf,bsfh->bsh", x, bank.w1[ci])
                   + bank.b1[ci])
    return torch.einsum("bsh,bshl->bsl", h, bank.w2[ci]) + bank.b2[ci]


def global_scores(bank: MLPBank, probs: torch.Tensor,
                  slot_valid: torch.Tensor, cell_ids: torch.Tensor,
                  n_leaves: int) -> torch.Tensor:
    """Union of per-cell predictions (paper: union of model outputs).

    probs [B, S, Cl] sigmoid scores, slot_valid [B, S], cell_ids [B, S]
    → [B, n_leaves] max-combined scores over the models a query overlaps.
    """
    B, S, Cl = probs.shape
    ci = cell_ids.long()
    lm = bank.label_map[ci].long()                        # [B, S, Cl]
    # a label id outside [0, L) (a bank not yet renamed to a repacked
    # tree) is dropped, as the reference's scatter drops it
    ok = slot_valid[:, :, None] & bank.lmask[ci] & (lm >= 0) & (lm < n_leaves)
    tgt = torch.where(ok, lm, n_leaves)                   # park invalid at L
    flat_t = tgt.reshape(B, S * Cl)
    flat_p = torch.where(ok, probs, 0.0).reshape(B, S * Cl)
    out = torch.zeros((B, n_leaves + 1), dtype=probs.dtype,
                      device=probs.device)
    out.scatter_reduce_(1, flat_t, flat_p, reduce="amax", include_self=True)
    return out[:, :n_leaves]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def grid_norm(grid) -> tuple[np.ndarray, np.ndarray]:
    """Feature normalizer derived from the grid bbox alone: rect corners
    centered on the bbox center and scaled by its half-extents."""
    b = grid.bbox.detach().cpu().numpy().astype(np.float32)
    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    hx = max((b[2] - b[0]) / 2, 1e-6)
    hy = max((b[3] - b[1]) / 2, 1e-6)
    return (np.array([cx, cy, cx, cy], np.float32),
            np.array([hx, hy, hx, hy], np.float32))


def init_cell_params(cell_ids: np.ndarray, n_feats: int, hidden: int,
                     n_labels: int, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    """Per-cell fold-in init: cell ``c``'s weights come from rng streams
    keyed ``(seed, c, tensor)`` — identical whether ``c`` is initialized
    alone or inside the full bank."""
    w1, w2 = [], []
    for c in np.asarray(cell_ids, np.int64):
        r1 = np.random.default_rng((seed, int(c), 0))
        r2 = np.random.default_rng((seed, int(c), 1))
        w1.append(r1.normal(0, 1.0 / np.sqrt(n_feats),
                            (n_feats, hidden)).astype(np.float32))
        w2.append(r2.normal(0, 1.0 / np.sqrt(hidden),
                            (hidden, n_labels)).astype(np.float32))
    C = len(w1)
    dev = torch.device(device)
    return {"w1": torch.from_numpy(np.stack(w1)).to(dev),
            "b1": torch.zeros((C, hidden), dtype=torch.float32, device=dev),
            "w2": torch.from_numpy(np.stack(w2)).to(dev),
            "b2": torch.zeros((C, n_labels), dtype=torch.float32,
                              device=dev)}


def _cell_logits_p(params: dict, feats, mu, sd) -> torch.Tensor:
    x = (feats - mu) / sd
    h = torch.relu(torch.einsum("cqf,cfh->cqh", x, params["w1"])
                   + params["b1"][:, None, :])
    return torch.einsum("cqh,chl->cql", h, params["w2"]) \
        + params["b2"][:, None, :]


def _bce_cells(params: dict, feats, labels, m, live, mu, sd
               ) -> torch.Tensor:
    """Decoupled loss: per-cell masked mean, summed over live cells.
    ``m`` is the [C, Q, Cl] float mask of valid (query, label) pairs."""
    z = torch.clamp(_cell_logits_p(params, feats, mu, sd), -30, 30)
    ce = torch.relu(z) - z * labels + torch.log1p(torch.exp(-torch.abs(z)))
    # positive-class upweighting: multi-hot targets are sparse
    w = torch.where(labels > 0, 4.0, 1.0)
    per = torch.sum(ce * w * m, dim=(1, 2)) \
        / torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    return torch.sum(per * live)


def cell_fit_fractions(params: dict, feats, labels, qmask, lmask, mu, sd,
                       threshold: float = 0.5) -> torch.Tensor:
    """[C] per-cell fraction of valid training queries whose predicted set
    equals the true set. Cells with no valid query are vacuously 1.0."""
    logits = _cell_logits_p(params, feats, mu, sd)
    pred = (torch.sigmoid(logits) > threshold) & lmask[:, None, :]
    ok = torch.all(pred == (labels > 0.5), dim=-1) | ~qmask
    n = torch.sum(qmask, dim=1)
    return torch.where(
        n > 0, torch.sum(ok & qmask, dim=1) / torch.clamp(n, min=1), 1.0)


@dataclasses.dataclass
class TrainReport:
    epochs: int
    final_loss: float
    exact_fit: float


def train_cells(feats: np.ndarray, labels: np.ndarray, qmask: np.ndarray,
                lmask: np.ndarray, mu: np.ndarray, sd: np.ndarray,
                cell_ids: np.ndarray, *, hidden: int = 64, lr: float = 3e-3,
                weight_decay: float = 0.0, max_epochs: int = 3000,
                check_every: int = 200, target_fit: float = 1.0,
                seed: int = 0, device: str | torch.device = "cuda"
                ) -> Tuple[dict, TrainReport]:
    """Train a stack of per-cell experts over ``[C, Qp, ...]`` data rows
    on ``device`` with full-batch AdamW (written out as in the reference:
    bias-corrected moments, ``p -= lr * (m̂ / (√v̂ + 1e-8) + wd * p)``).

    ``cell_ids`` names each row's *global* cell id — the fold-in init key.
    Returns the trained ``{w1, b1, w2, b2}`` rows and a ``TrainReport``.
    """
    dev = torch.device(device)
    Cl = labels.shape[-1]
    params = init_cell_params(cell_ids, feats.shape[-1], hidden, Cl,
                              seed=seed, device=dev)
    feats_t = torch.as_tensor(feats, dtype=torch.float32, device=dev)
    labels_t = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    qmask_t = torch.as_tensor(qmask, dtype=torch.bool, device=dev)
    lmask_t = torch.as_tensor(lmask, dtype=torch.bool, device=dev)
    mu_t = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    sd_t = torch.as_tensor(sd, dtype=torch.float32, device=dev)
    m = (qmask_t[:, :, None] & lmask_t[:, None, :]).to(torch.float32)
    opt_m = {k: torch.zeros_like(v) for k, v in params.items()}
    opt_v = {k: torch.zeros_like(v) for k, v in params.items()}
    live = torch.ones((feats.shape[0],), dtype=torch.float32, device=dev)
    nq = qmask.sum(axis=1)
    b1c, b2c = 0.9, 0.999

    loss = torch.tensor(float("inf"))
    fit = 0.0
    epoch = 0
    for epoch in range(1, max_epochs + 1):
        for p in params.values():
            p.requires_grad_(True)
        loss = _bce_cells(params, feats_t, labels_t, m, live, mu_t, sd_t)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            keep = live > 0
            for (name, p), g in zip(list(params.items()), grads):
                lv = keep.reshape((-1,) + (1,) * (p.ndim - 1))
                m2 = b1c * opt_m[name] + (1 - b1c) * g
                v2 = b2c * opt_v[name] + (1 - b2c) * g * g
                mhat = m2 / (1 - b1c ** epoch)
                vhat = v2 / (1 - b2c ** epoch)
                new = p - lr * (mhat / (torch.sqrt(vhat) + 1e-8)
                                + weight_decay * p)
                # frozen cells hold params AND optimizer state
                params[name] = torch.where(lv, new, p).detach()
                opt_m[name] = torch.where(lv, m2, opt_m[name])
                opt_v[name] = torch.where(lv, v2, opt_v[name])
        if epoch % check_every == 0 or epoch == max_epochs:
            with torch.no_grad():
                fr = cell_fit_fractions(params, feats_t, labels_t, qmask_t,
                                        lmask_t, mu_t, sd_t)
                live = torch.where(fr >= 1.0, 0.0, live)
            frh = fr.cpu().numpy()
            fit = float((frh * nq).sum() / max(nq.sum(), 1))
            if not bool((live > 0).any()) or fit >= target_fit:
                break
    params = {k: v.detach() for k, v in params.items()}
    return params, TrainReport(epochs=epoch, final_loss=float(loss.detach()),
                               exact_fit=float(fit))


def train_bank(ds: CellDataset, *, hidden: int = 64, lr: float = 3e-3,
               weight_decay: float = 0.0, max_epochs: int = 3000,
               check_every: int = 200, target_fit: float = 1.0,
               seed: int = 0, device: str | torch.device = "cuda"
               ) -> Tuple[MLPBank, TrainReport]:
    """Full-bank fit: ``train_cells`` over every grid cell + assembly."""
    C = ds.feats.shape[0]
    dev = torch.device(device)
    mu, sd = grid_norm(ds.grid)
    params, rep = train_cells(
        ds.feats, ds.labels, ds.qmask, ds.lmask, mu, sd,
        np.arange(C, dtype=np.int64), hidden=hidden, lr=lr,
        weight_decay=weight_decay, max_epochs=max_epochs,
        check_every=check_every, target_fit=target_fit, seed=seed,
        device=dev)
    bank = MLPBank(
        w1=params["w1"], b1=params["b1"], w2=params["w2"], b2=params["b2"],
        mu=torch.from_numpy(mu).to(dev), sd=torch.from_numpy(sd).to(dev),
        label_map=torch.from_numpy(ds.label_map).to(dev),
        lmask=torch.from_numpy(ds.lmask).to(dev))
    return bank, rep
