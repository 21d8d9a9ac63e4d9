"""Carry a fitted reference ``HybridTree`` across into the port.

``hybrid_from_reference(h, device)`` reads the reference object's arrays
by attribute and converts each with ``np.asarray`` — so it accepts the
JAX package's arrays without importing JAX — then builds the port's
``HybridTree`` on ``device``: tree levels, leaf entries and ids, the
ancestor table, the grid,
``cell_ok``, the MLP, kNN or forest bank and the router.
``fit_state_from_reference(s)`` carries a reference ``build.FitState``
across (host numpy, lists of ``bytes`` and ``frozenset``s), so a port
``FreshServer`` can run the maintenance loop on the same fitted world.
The tests use both to run the two packages side by side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.aitree import make_aitree
from repro_torch.core.build import FitState
from repro_torch.core.classifiers.forest import Forest
from repro_torch.core.classifiers.knn import KNNBank
from repro_torch.core.classifiers.mlp import MLPBank
from repro_torch.core.classifiers.router import Router
from repro_torch.core.device_tree import (
    AncestorTable, DeviceTree, Level, build_ancestor_table)
from repro_torch.core.grid import Grid
from repro_torch.core.hybrid import HybridTree


def _t(a, dev: torch.device, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if dtype is not None:
        arr = arr.astype(dtype)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def _table_from_reference(sl, parents, dev: torch.device
                          ) -> AncestorTable | None:
    """A reference ``AncestorTable`` (or None) → the port's, checked
    against the port's own ``build_ancestor_table`` of the same parents
    at the same tile."""
    own = build_ancestor_table(parents, tl=None if sl is None else sl.tl,
                               device=dev)
    if sl is None:
        if own is not None:
            raise ValueError("the reference tree has no ancestor table")
        return None
    got = AncestorTable(starts=_t(sl.starts, dev, np.int32),
                        widths=tuple(int(w) for w in sl.widths),
                        tl=int(sl.tl))
    if own is None or got.widths != own.widths or \
            not torch.equal(got.starts, own.starts):
        raise ValueError("the reference's ancestor table differs from the "
                         "port's build of the same tree")
    return got


def tree_from_reference(tree, device: str | torch.device = "cuda"
                        ) -> DeviceTree:
    """A reference ``DeviceTree`` → the port's, on ``device``."""
    dev = resolve_device(device)
    parents = [np.asarray(lv.parent, np.int32) for lv in tree.levels]
    return DeviceTree(
        levels=tuple(Level(mbrs=_t(lv.mbrs, dev, np.float32),
                           parent=_t(lv.parent, dev, np.int32))
                     for lv in tree.levels),
        leaf_entries=_t(tree.leaf_entries, dev, np.float32),
        leaf_entry_ids=_t(tree.leaf_entry_ids, dev, np.int32),
        leaf_counts=_t(tree.leaf_counts, dev, np.int32),
        n_points=int(tree.n_points),
        max_entries=int(tree.max_entries),
        aslices=_table_from_reference(getattr(tree, "aslices", None),
                                      parents, dev),
    )


def _bank_from_reference(bank, kind: str,
                        device: str | torch.device = "cuda"):
    """A reference MLP, kNN or forest bank → the port's, on ``device``
    (the forest's ``feat_idx`` as i32, ``thresh`` and ``tables`` as f32,
    bit for bit)."""
    dev = resolve_device(device)
    if kind == "mlp":
        return MLPBank(
            w1=_t(bank.w1, dev, np.float32), b1=_t(bank.b1, dev, np.float32),
            w2=_t(bank.w2, dev, np.float32), b2=_t(bank.b2, dev, np.float32),
            mu=_t(bank.mu, dev, np.float32), sd=_t(bank.sd, dev, np.float32),
            label_map=_t(bank.label_map, dev, np.int32),
            lmask=_t(bank.lmask, dev, bool))
    if kind == "knn":
        return KNNBank(feats=_t(bank.feats, dev, np.float32),
                       labels=_t(bank.labels, dev, np.float32),
                       label_map=_t(bank.label_map, dev, np.int32),
                       lmask=_t(bank.lmask, dev, bool), eps=float(bank.eps))
    if kind == "forest":
        return Forest(feat_idx=_t(bank.feat_idx, dev, np.int32),
                      thresh=_t(bank.thresh, dev, np.float32),
                      tables=_t(bank.tables, dev, np.float32),
                      label_map=_t(bank.label_map, dev, np.int32),
                      lmask=_t(bank.lmask, dev, bool))
    raise ValueError(f"unknown bank kind {kind!r}")


def hybrid_from_reference(h, device: str | torch.device = "cuda"
                          ) -> HybridTree:
    """A fitted reference ``HybridTree`` (MLP, kNN or forest bank) → the
    port's."""
    dev = resolve_device(device)
    ait, router = h.ait, h.router
    grid = Grid(bbox=_t(ait.grid.bbox, dev, np.float32), g=int(ait.grid.g))
    port_ait = make_aitree(grid, _bank_from_reference(ait.bank, ait.kind, dev),
                           max_cells=int(ait.max_cells),
                           max_pred=int(ait.max_pred),
                           threshold=float(ait.threshold),
                           cell_ok=_t(ait.cell_ok, dev, bool))
    port_router = Router(feat_idx=_t(router.feat_idx, dev, np.int32),
                         thresh=_t(router.thresh, dev, np.float32),
                         tables=_t(router.tables, dev, np.float32),
                         tau=float(router.tau))
    return HybridTree(tree=tree_from_reference(h.tree, dev), ait=port_ait,
                      router=port_router)


def fit_state_from_reference(state) -> FitState:
    """A reference ``build.FitState`` → the port's (host values copied;
    the port's ``make_workload`` takes no ``use_kernel``, the device
    decides, so that labelling setting is dropped)."""
    return FitState(
        queries=np.array(state.queries, np.float32),
        true_rows=[np.array(r, np.int64) for r in state.true_rows],
        exact=np.array(state.exact, bool),
        exact_valid=np.array(state.exact_valid, bool),
        cell_ids=np.array(state.cell_ids, np.int32),
        cell_valid=np.array(state.cell_valid, bool),
        overflow=np.array(state.overflow, bool),
        qp=int(state.qp), cl=int(state.cl),
        spans=list(state.spans), sigs=list(state.sigs),
        cell_stale=np.array(state.cell_stale, bool),
        kind=str(state.kind), mlp_hidden=int(state.mlp_hidden),
        mlp_epochs=int(state.mlp_epochs),
        target_fit=float(state.target_fit), seed=int(state.seed),
        label_kwargs={k: v for k, v in state.label_kwargs.items()
                      if k != "use_kernel"})
