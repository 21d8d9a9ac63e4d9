"""Plain PyTorch versions of the CUDA kernels on the serving paths.

Each function computes exactly what its kernel computes and is what
``kernels.ops`` runs for tensors on the CPU. The tests hold these against
the JAX package's kernels; ``chip_smoke.py`` holds the CUDA kernels
against these on the card. They are not a speed yardstick.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import geometry as geo


def mbr_intersect(queries: torch.Tensor, mbrs: torch.Tensor) -> torch.Tensor:
    """[B, 4] × [N, 4] → [B, N] bool (closed-rectangle intersection)."""
    return geo.torch_cross_intersects(queries.to(torch.float32),
                                      mbrs.to(torch.float32))


def traverse_fused(queries: torch.Tensor, level_mbrs: Sequence[torch.Tensor],
                   level_parents: Sequence[torch.Tensor]) -> torch.Tensor:
    """Level-synchronous root→leaf walk: [B, 4] → visited-leaf mask [B, L].

    ``level_mbrs``: one [N_l, 4] per level, root first (leaf level last);
    ``level_parents``: matching [N_l] i32 (entry 0 unused). A leaf is
    visited iff every ancestor MBR and its own intersect the query.
    """
    mask = mbr_intersect(queries, level_mbrs[0])
    for mbrs, parent in zip(level_mbrs[1:], level_parents[1:]):
        mask = mask[:, parent.long()] & mbr_intersect(queries, mbrs)
    return mask


def traverse_compact(queries: torch.Tensor,
                     level_mbrs: Sequence[torch.Tensor],
                     level_parents: Sequence[torch.Tensor], k: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk, compacted: ``(leaf_idx [B, k] i32, valid [B, k] bool,
    count [B] i32)`` — the first ``k`` visited leaves in id order and the
    row's visited count (``compact_mask_counted`` of ``traverse_fused``)."""
    from repro_torch.core.traversal import compact_mask_counted
    return compact_mask_counted(
        traverse_fused(queries, level_mbrs, level_parents), k)


def traverse_fused_sliced(queries: torch.Tensor,
                          level_mbrs: Sequence[torch.Tensor],
                          level_parents: Sequence[torch.Tensor],
                          starts: torch.Tensor, widths: Sequence[int],
                          tl: int) -> torch.Tensor:
    """The walk through an ``AncestorTable``'s windows: [B, 4] → [B, L].

    For leaf tile ``t`` each internal level ``l`` is seen only through its
    ``widths[l]`` nodes from ``starts[l, t] * widths[l]``; a window past
    the level's end reads never-intersecting rectangles. Parent indices
    are rebased to the window of the level above, and an out-of-window
    parent is dead. With a correctly built table this equals
    ``traverse_fused`` exactly.
    """
    q = queries.to(torch.float32)
    n_int = len(level_mbrs) - 1
    L = level_mbrs[-1].shape[0]
    st = starts.to(torch.int64).cpu().tolist()
    # each level's hits once, padded with misses to its furthest window
    hits, pars = [], []
    for l in range(n_int):
        n = level_mbrs[l].shape[0]
        end = max(max(st[l]) * widths[l] + widths[l], n)
        h = torch.zeros((q.shape[0], end), dtype=torch.bool, device=q.device)
        h[:, :n] = mbr_intersect(q, level_mbrs[l])
        par = torch.zeros((end,), dtype=torch.int64, device=q.device)
        par[:n] = level_parents[l].long()
        hits.append(h)
        pars.append(par)
    outs = []
    for t in range(-(-L // tl)):
        mask, prev_s = None, 0
        for l in range(n_int):
            s, w = st[l][t] * widths[l], widths[l]
            if l == 0:
                mask = hits[0][:, s:s + w]
            else:
                rel = pars[l][s:s + w] - prev_s
                ok = (rel >= 0) & (rel < widths[l - 1])
                mask = (mask[:, torch.clamp(rel, 0, widths[l - 1] - 1)]
                        & ok[None, :] & hits[l][:, s:s + w])
            prev_s = s
        lm = level_mbrs[-1][t * tl:(t + 1) * tl]
        rel = level_parents[-1][t * tl:(t + 1) * tl].long() - prev_s
        ok = (rel >= 0) & (rel < widths[-1])
        outs.append(mask[:, torch.clamp(rel, 0, widths[-1] - 1)]
                    & ok[None, :] & mbr_intersect(q, lm))
    return torch.cat(outs, dim=1)


def traverse_compact_sliced(queries: torch.Tensor,
                            level_mbrs: Sequence[torch.Tensor],
                            level_parents: Sequence[torch.Tensor],
                            starts: torch.Tensor, widths: Sequence[int],
                            tl: int, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The windowed walk, compacted: ``compact_mask_counted`` of
    ``traverse_fused_sliced`` — ``(leaf_idx [B, k] i32, valid [B, k]
    bool, count [B] i32)``."""
    from repro_torch.core.traversal import compact_mask_counted
    return compact_mask_counted(
        traverse_fused_sliced(queries, level_mbrs, level_parents, starts,
                              widths, tl), k)


def leaf_refine(queries: torch.Tensor, ex: torch.Tensor, ey: torch.Tensor,
                leaf_idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """queries [B,4], ex/ey [L,M], leaf_idx [B,K], valid [B,K] → [B,K,M]
    exact point-in-rect containment of the named leaves' entries."""
    li = leaf_idx.long()
    pts = torch.stack([ex[li], ey[li]], dim=-1).to(torch.float32)
    ok = geo.torch_contains_point(
        queries.to(torch.float32)[:, None, None, :], pts)   # [B, K, M]
    return ok & valid.to(torch.bool)[:, :, None]


def knn_browse(centers: torch.Tensor, ex: torch.Tensor, ey: torch.Tensor,
               leaf_idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """centers [B,3] (cx, cy, r²), ex/ey [L,M], leaf_idx/valid [B,K] →
    d2 [B,K,M] f32: squared distance from the centre to each entry of the
    named leaves, +inf outside the radius, on invalid slots and on
    (+inf) padding. ``dx*dx + dy*dy`` is three separately rounded ops,
    as the CUDA kernel computes it."""
    li = leaf_idx.long()
    gx = ex[li].to(torch.float32)                        # [B, K, M]
    gy = ey[li].to(torch.float32)
    q = centers.to(torch.float32)
    dx = gx - q[:, 0, None, None]
    dy = gy - q[:, 1, None, None]
    d2 = dx * dx + dy * dy
    ok = (d2 <= q[:, 2, None, None]) & valid.to(torch.bool)[:, :, None]
    return torch.where(ok, d2, torch.inf)


def spatial_key(cxy: torch.Tensor, curve: str = "hilbert",
                order: int = 15) -> torch.Tensor:
    """Space-filling-curve keys: normalized centres [B, 2] f32 → [B] i32.

    Each coordinate is quantized to ``order`` bits (``c * 2^order``
    truncated, clipped to ``[0, 2^order)``), then the bits are
    interleaved (``morton``, x high) or walked xy→d with quadrant
    rotations as selects (``hilbert``). All int32: the largest Hilbert
    term, 3·4^(order-1), fits. Clamping before the cast gives the same
    integer for every finite input and keeps out-of-range casts defined.
    """
    if curve not in ("hilbert", "morton"):
        raise ValueError(f"curve must be hilbert or morton, got {curve!r}")
    n = 1 << order
    q = torch.clamp(cxy.to(torch.float32) * float(n), 0.0,
                    float(n - 1)).to(torch.int32)
    x, y = q[:, 0], q[:, 1]
    if curve == "morton":
        key = torch.zeros_like(x)
        for i in range(order):
            key = key | (((x >> i) & 1) << (2 * i + 1)) \
                | (((y >> i) & 1) << (2 * i))
        return key
    d = torch.zeros_like(x)
    for i in range(order - 1, -1, -1):
        s = 1 << i
        rx = (x >> i) & 1
        ry = (y >> i) & 1
        d = d + s * s * ((3 * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        fx = torch.where(flip, s - 1 - x, x)
        fy = torch.where(flip, s - 1 - y, y)
        x = torch.where(swap, fy, fx)
        y = torch.where(swap, fx, fy)
    return d


def mlp_predict_scores(x: torch.Tensor, cell_ids: torch.Tensor,
                       slot_ok: torch.Tensor, w1: torch.Tensor,
                       b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                       label_map: torch.Tensor, lmask: torch.Tensor,
                       n_leaves: int) -> torch.Tensor:
    """Dense AI-path scores: normalized features [B, F] → [B, n_leaves].

    Gathered per-cell MLP forward (sum over F, then over H), sigmoid, and
    the max-union scatter of every valid (slot, label) score into its
    global leaf id.
    """
    B, S = cell_ids.shape
    ci = cell_ids.long()
    w1g = w1[ci]                                    # [B, S, F, H]
    w2g = w2[ci]                                    # [B, S, H, Cl]
    h = torch.relu(torch.einsum("bf,bsfh->bsh", x.to(torch.float32), w1g)
                   + b1[ci])
    probs = torch.sigmoid(torch.einsum("bsh,bshl->bsl", h, w2g) + b2[ci])
    lm = label_map[ci].long()                       # [B, S, Cl]
    # a label id outside [0, L) (a bank not yet renamed to a repacked
    # tree) is dropped, as the reference's scatter and the kernel drop it
    ok = slot_ok.to(torch.bool)[:, :, None] & lmask[ci] \
        & (lm >= 0) & (lm < n_leaves)
    tgt = torch.where(ok, lm, n_leaves)             # park invalid at L
    Cl = lm.shape[-1]
    flat_t = tgt.reshape(B, S * Cl)
    flat_p = torch.where(ok, probs, 0.0).reshape(B, S * Cl)
    out = torch.zeros((B, n_leaves + 1), dtype=probs.dtype, device=x.device)
    out.scatter_reduce_(1, flat_t, flat_p, reduce="amax", include_self=True)
    return out[:, :n_leaves]


def mlp_predict_compact(x: torch.Tensor, cell_ids: torch.Tensor,
                        slot_ok: torch.Tensor, w1: torch.Tensor,
                        b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        label_map: torch.Tensor, lmask: torch.Tensor, *,
                        n_leaves: int, k: int, threshold: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense scores → threshold → ``compact_mask_counted``: ``(leaf_idx
    [B, k] i32, valid [B, k] bool, count [B] i32)`` — the first ``k``
    predicted leaves in leaf-id order and the distinct predicted count."""
    from repro_torch.core.traversal import compact_mask_counted
    scores = mlp_predict_scores(x, cell_ids, slot_ok, w1, b1, w2, b2,
                                label_map, lmask, n_leaves)
    return compact_mask_counted(scores > threshold, k)


def forest_infer(sel: torch.Tensor, thresh: torch.Tensor,
                 tables: torch.Tensor) -> torch.Tensor:
    """sel [B,T,D], thresh [T,D], tables [T,2^D,C] → summed votes [B,C].

    Trees are summed in ascending ``t``, the order the CUDA kernel (and the
    TPU kernel's grid) accumulates, so the two agree bit for bit.
    """
    B, T, D = sel.shape
    bits = (sel.to(torch.float32) > thresh[None].to(torch.float32))
    powers = 2 ** torch.arange(D - 1, -1, -1, dtype=torch.int64,
                               device=sel.device)
    leaf = torch.sum(bits.long() * powers[None, None, :], dim=-1)   # [B, T]
    tab = tables.to(torch.float32)
    out = torch.zeros((B, tables.shape[-1]), dtype=torch.float32,
                      device=sel.device)
    for t in range(T):
        out = out + tab[t][leaf[:, t]]
    return out



def forest_infer_percell(sel: torch.Tensor, thresh: torch.Tensor,
                         tables: torch.Tensor) -> torch.Tensor:
    """Per-tree votes (no cross-tree sum): sel [B,T,D], thresh [T,D],
    tables [T,2^D,C] → [B, T, C]."""
    B, T, D = sel.shape
    bits = (sel.to(torch.float32) > thresh[None].to(torch.float32))
    powers = 2 ** torch.arange(D - 1, -1, -1, dtype=torch.int64,
                               device=sel.device)
    leaf = torch.sum(bits.long() * powers[None, None, :], dim=-1)   # [B, T]
    t = torch.arange(T, device=sel.device)
    return tables.to(torch.float32)[t[None, :], leaf]


def forest_infer_cells(features: torch.Tensor, feat_idx: torch.Tensor,
                       thresh: torch.Tensor, tables: torch.Tensor,
                       n_cells: int) -> torch.Tensor:
    """features [B,F], feat_idx/thresh [C·T,D], tables [C·T,2^D,Cl] →
    votes [B, C, Cl]: each cell's T tree votes summed in tree order, by
    an explicit loop — the order the TPU kernel's grid (T innermost) and
    the CUDA kernel accumulate in. Feature indices are clamped into
    [0, F), as a gather does."""
    B, F = features.shape
    CT, D = feat_idx.shape
    T = CT // n_cells
    fi = torch.clamp(feat_idx.long(), 0, F - 1)
    sel = features.to(torch.float32)[:, fi]                    # [B, C·T, D]
    per = forest_infer_percell(sel, thresh, tables)
    per = per.reshape(B, n_cells, T, tables.shape[-1])
    out = per[:, :, 0]
    for t in range(1, T):
        out = out + per[:, :, t]
    return out.contiguous()

def delta_contains(queries: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """queries [B, 4] × buffer points [cap, 2] → [B, cap] bool
    closed-rectangle containment; +inf (unstaged) points never hit."""
    return geo.torch_contains_point(queries.to(torch.float32)[:, None, :],
                                    pts.to(torch.float32)[None, :, :])


def delta_probe(queries: torch.Tensor, pts: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense containment → ``compact_mask_counted``: ``(slot_idx [B, k]
    i32, valid [B, k] bool, count [B] i32)`` — the first ``k`` hit
    positions in buffer (= insertion) order and the full hit count."""
    from repro_torch.core.traversal import compact_mask_counted
    return compact_mask_counted(delta_contains(queries, pts), k)
