"""Device-side insert delta store: dynamic inserts without a rebuild.

The paper's structure is static — the R-tree is built once and the
AI-tree is overfit to a fixed workload — so this module absorbs inserts
into a fixed-capacity append-only point buffer that serves *alongside*
the tree:

* ``stage_inserts`` appends points between batches: it returns a store
  with a new ``xy`` tensor, so a serve step that already holds the old one
  never sees a buffer change under it;
* every query batch probes the buffer (``probe`` → ``ops.delta_probe``,
  the CUDA kernel on the card) and merges the hits into its results
  (``merge_hybrid_result``) — staged points are invisible to both the R
  and AI paths until then;
* ``repack`` merges the buffer into a fresh ``RTree.str_bulk`` →
  ``DeviceTree`` and returns an empty store, so the server can swap the
  tree between batches (the online repack).

ID convention: the point staged into buffer slot ``j`` has global id
``base + j`` where ``base`` is the number of points already in the tree.
``repack`` appends the staged points (rounded to f32 when staged, widened
back to f64) to the base point array in slot order, so ``str_bulk``
assigns exactly those ids and the rebuilt tree sees the coordinates the
probe saw.

Unstaged capacity holds +inf coordinates: closed-rect containment fails
on them, so neither the kernel nor its plain version reads the staged
count.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.device_tree import DeviceTree, flatten
from repro_torch.core.rtree import RTree
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class DeltaStore:
    """Append-only insert buffer (functional updates): the host fields
    drive staging and repack decisions, ``xy`` is what a serve step
    probes."""
    capacity: int
    base: int            # global id of buffer slot 0 (= points in tree)
    n: int               # staged inserts
    xy: torch.Tensor     # [capacity, 2] f32 on the server's device,
    #                      +inf past ``n``


def make_delta(capacity: int, base: int = 0,
               device: str | torch.device = "cuda") -> DeltaStore:
    if capacity < 1:
        raise ValueError(f"delta capacity must be >= 1, got {capacity}")
    xy = torch.full((capacity, 2), torch.inf, dtype=torch.float32,
                    device=resolve_device(device))
    return DeltaStore(capacity=int(capacity), base=int(base), n=0, xy=xy)


def stage_inserts(store: DeltaStore, points: np.ndarray) -> DeltaStore:
    """Append ``points`` [m, 2] (rounded to f32); the staged point ids
    continue the tree's numbering (``store.base + slot``). Raises when the
    buffer would overflow — callers repack first (``FreshServer`` does).
    """
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    m = pts.shape[0]
    if m == 0:
        return store
    if store.n + m > store.capacity:
        raise ValueError(
            f"delta store overflow: {store.n} staged + {m} new > capacity "
            f"{store.capacity} — repack first")
    xy = store.xy.clone()
    xy[store.n:store.n + m] = torch.from_numpy(pts).to(xy.device)
    return dataclasses.replace(store, n=store.n + m, xy=xy)


def staged_points(store: DeltaStore) -> np.ndarray:
    """The staged inserts as a host array [n, 2] f64 (the tree build's dtype)."""
    return store.xy[:store.n].cpu().numpy().astype(np.float64)


class DeltaHits(NamedTuple):
    """Per-query probe result over one batch."""
    slot_idx: torch.Tensor   # [B, k] i32 buffer slots (insertion order)
    valid: torch.Tensor      # [B, k] bool slot validity
    count: torch.Tensor      # [B] i32 full hit total (exact past k)
    ids: torch.Tensor        # [B, k] i32 global point ids, -1 invalid


def probe(store_xy: torch.Tensor, queries: torch.Tensor, *, k: int,
          base: int) -> DeltaHits:
    """Probe the buffer for a query batch: [B, 4] → ``DeltaHits``
    (``ops.delta_probe``: the kernel on the card, its plain version on the
    CPU). ``count`` is the full per-row hit total, so result counts stay
    exact even when the slot table overflows ``k``."""
    slot_idx, valid, count = kops.delta_probe(queries, store_xy, k=k)
    ids = torch.where(valid, base + slot_idx, -1).to(torch.int32)
    return DeltaHits(slot_idx=slot_idx, valid=valid, count=count, ids=ids)


def merge_hybrid_result(res, hits: DeltaHits):
    """Fold delta hits into a ``HybridResult``: counts add exactly, hit
    ids land in the result table's -1 padding (after the tree's ids, up
    to the table's own width), and rows whose merged ids no longer fit
    raise ``truncated`` so the scheduler's wide tier re-serves them.
    ``leaf_accesses`` is untouched — the probe is not tree I/O (the
    paper's cost unit).
    """
    B, k = hits.ids.shape
    mr = res.result_ids.shape[1]
    dev = hits.ids.device
    pos = res.n_results[:, None] + torch.arange(
        k, dtype=torch.int32, device=dev)[None, :]
    ok = hits.valid & (pos < mr)
    out = torch.cat([res.result_ids,
                     torch.full((B, 1), -1, dtype=torch.int32, device=dev)],
                    dim=1)
    # a row's valid positions n_results + j are distinct, so only the dump
    # column (index mr, sliced off) receives duplicate writes — all of -1,
    # so their order cannot matter
    out.scatter_(1, torch.where(ok, pos, mr).long(),
                 torch.where(ok, hits.ids, -1))
    over = (hits.count > k) | (res.n_results + hits.count > mr)
    return res._replace(
        n_results=res.n_results + hits.count,
        result_ids=out[:, :mr],
        truncated=res.truncated | over)


def repack(base_points: np.ndarray, store: DeltaStore, *, max_entries: int
           ) -> Tuple[RTree, DeviceTree, np.ndarray, DeltaStore]:
    """Online repack: merge the buffer into a fresh ``str_bulk`` tree on
    the store's device.

    Returns ``(host_tree, device_tree, all_points, empty_store)``; point
    ids are preserved (staged points are appended to ``base_points`` in
    slot order).
    """
    pts = np.asarray(base_points, np.float64)
    if pts.shape[0] != store.base:
        raise ValueError(
            f"repack id contract broken: {pts.shape[0]} base points but "
            f"store.base={store.base}")
    allp = np.concatenate([pts, staged_points(store)], axis=0)
    tree = RTree.str_bulk(allp, max_entries=max_entries)
    dev = store.xy.device
    return (tree, flatten(tree, device=dev), allp,
            make_delta(store.capacity, base=allp.shape[0], device=dev))
