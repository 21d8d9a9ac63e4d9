"""Dispatch for the serving paths' kernels: the device decides.

Each wrapper takes its inputs in the reference's layout, does the small
shape work the kernel needs, and then runs

* the plain PyTorch version (``kernels.ref``) when the tensors lie on the
  CPU, or
* the hand-written CUDA kernel (``kernels.cuda``) when they lie on a CUDA
  device — always; a kernel that fails to build or launch raises.

There is no environment switch and no fallback between the two. Each CUDA
launch adds one to that kernel's count (``launch_counts``).

``prepare(name, ...)`` exposes the CUDA path split in two: it validates
and lays out the inputs, allocates the outputs, and returns
``(launch, outputs)`` where ``launch()`` issues only the kernel — what a
benchmark times.

The two walks (``traverse_fused``, ``traverse_compact``) climb the
reference's ladder (``src/repro/kernels/ops.py:244-360``), chosen by
``walk_route`` from the shapes alone: a single-level tree is one
``mbr_intersect``; a tree whose full walk fits one CTA's shared memory
takes the full-walk kernel; past that, the ancestor-sliced kernel over the
tree's ``AncestorTable`` (built from the parents when the caller has
none); and when even the sliced walk does not fit, the per-level loop of
``mbr_intersect`` launches. CPU tensors take none of these rungs: they
run the one plain walk (``ref.traverse_fused`` / ``ref.traverse_compact``),
as the reference does with its kernels off.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from repro_torch.core.device_tree import build_ancestor_table
from repro_torch.kernels import ref
from repro_torch.kernels import cuda as _cuda

# Leaves per CTA along the leaf axis of the traversal kernel's grid, and
# queries per CTA (kQT in csrc/traverse_fused.cu and in
# csrc/traverse_compact.cu).
TRAVERSE_LEAF_CHUNK = 2048
TRAVERSE_QUERY_TILE = 8
COMPACT_QUERY_TILE = 4
SLICED_QUERY_TILE = 8           # kQT in csrc/traverse_fused_sliced.cu
COMPACT_SLICED_QUERY_TILE = 4   # kQT in csrc/traverse_compact_sliced.cu
DELTA_QUERY_TILE = 4      # kQT in csrc/delta_probe.cu
FOREST_QUERY_TILE = 32    # kQT in csrc/forest_infer_cells.cu
CURVES = {"morton": 0, "hilbert": 1}
# Shared memory one CTA may ask for on sm_90 (232,448 bytes, less room
# for the kernels' static shared memory).
MAX_DYNAMIC_SMEM = 227 * 1024 - 1024

launch_counts = _cuda.launch_counts
reset_launch_counts = _cuda.reset_launch_counts


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def _c(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


def _launcher(name: str, device: torch.device, *args) -> Callable[[], None]:
    """A closure that launches kernel ``name`` on ``device``'s current
    stream. ``args`` mixes tensors (passed as device pointers; the closure
    keeps them alive) and plain ints/floats/ctypes values."""
    kernel = _cuda.KERNELS[name]
    cargs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]

    def launch() -> None:
        with torch.cuda.device(device):
            kernel(*cargs, torch.cuda.current_stream(device).cuda_stream)
    launch.tensors = args   # keeps every pointer in cargs alive
    return launch


# ---------------------------------------------------------------------------
# the walk ladder
# ---------------------------------------------------------------------------

def walk_smem(kind: str, route: str, level_sizes: Sequence[int],
              widths: Sequence[int] | None = None,
              tl: int | None = None) -> int:
    """Shared memory one CTA of walk ``kind`` (``"fused"`` or
    ``"compact"``) asks for on ``route`` (``"full"`` or ``"sliced"``),
    for a tree of ``level_sizes`` nodes per level (root first, leaves
    last) and, on the sliced route, the table's window ``widths`` and
    leaf tile ``tl``."""
    if route == "full":
        width = max(level_sizes[:-1], default=1)
        if kind == "fused":
            return 2 * TRAVERSE_QUERY_TILE * width
        n_words = (level_sizes[-1] + 31) // 32
        return COMPACT_QUERY_TILE * (n_words * 4 + 2 * width)
    if route == "sliced":
        if kind == "fused":
            return 2 * SLICED_QUERY_TILE * max(widths)
        return COMPACT_SLICED_QUERY_TILE * ((tl + 31) // 32 * 4 + sum(widths))
    raise ValueError(f"no shared-memory walk on route {route!r}")


def walk_route(kind: str, level_sizes: Sequence[int],
               widths: Sequence[int] | None = None,
               tl: int | None = None) -> str:
    """The rung walk ``kind`` (``"fused"``: dense mask; ``"compact"``:
    slot table) takes for a tree of ``level_sizes`` nodes per level, root
    first: ``"mbr_intersect"`` for a single level, ``"full"`` when the full
    walk's shared memory fits ``MAX_DYNAMIC_SMEM``, else ``"sliced"`` when
    an ancestor table of window ``widths`` and leaf tile ``tl`` is given
    and its walk fits, else ``"per_level"``."""
    if kind not in ("fused", "compact"):
        raise ValueError(f"walk kind must be fused or compact, got {kind!r}")
    if len(level_sizes) == 1:
        return "mbr_intersect"
    if walk_smem(kind, "full", level_sizes) <= MAX_DYNAMIC_SMEM:
        return "full"
    if widths is not None and \
            walk_smem(kind, "sliced", level_sizes, widths, tl) <= \
            MAX_DYNAMIC_SMEM:
        return "sliced"
    return "per_level"


def _slices_usable(sl, n_levels: int, L: int, device: torch.device) -> bool:
    """Does this ``AncestorTable`` match the tree being walked (its level
    count, its leaf count at the table's tile, the walk's device)? A
    table built for another tree must be rejected, not trusted."""
    if sl is None:
        return False
    st = sl.starts
    return (st.ndim == 2 and st.shape[0] == n_levels - 1
            and len(sl.widths) == n_levels - 1
            and st.shape[1] == -(-L // sl.tl) and st.device == device)


def _plan(kind: str, queries, level_mbrs, level_parents, slices):
    """``(route, table)``: the rung ``walk_route`` picks, with the tree's
    table when the full walk does not fit (``slices`` when it matches the
    tree, else one built from the parents)."""
    sizes = [int(m.shape[0]) for m in level_mbrs]
    route = walk_route(kind, sizes)
    if route != "per_level":
        return route, None
    sl = slices if _slices_usable(slices, len(sizes), sizes[-1],
                                  queries.device) else \
        build_ancestor_table(level_parents, device=queries.device)
    return walk_route(kind, sizes, sl.widths, sl.tl), sl


# ---------------------------------------------------------------------------
# preparation of each CUDA launch
# ---------------------------------------------------------------------------

def _walk_args(name, kind, route, queries, level_mbrs, level_parents,
               sl=None):
    """The walk kernels' shared arguments: queries, the internal levels
    packed root first with their host offsets, and the leaf level. A
    walk whose shared memory outgrows one CTA raises."""
    sizes = [int(m.shape[0]) for m in level_mbrs]
    table = () if sl is None else (sl.widths, sl.tl)
    smem = walk_smem(kind, route, sizes, *table)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"{name}: a tree of levels {sizes}"
            + (f" (windows {list(sl.widths)})" if sl is not None else "")
            + f" needs {smem} bytes of shared memory (> {MAX_DYNAMIC_SMEM}); "
            "walk_route sends it to another rung")
    q = _c(queries, torch.float32)
    n_int = len(level_mbrs) - 1
    if n_int:
        int_mbrs = _c(torch.cat(list(level_mbrs[:-1])), torch.float32)
        int_par = _c(torch.cat(list(level_parents[:-1])), torch.int32)
    else:   # never read: the kernel walks zero internal levels
        int_mbrs, int_par = q, q
    offs = [0]
    for n in sizes[:-1]:
        offs.append(offs[-1] + n)
    h_offs = (ctypes.c_int * len(offs))(*offs)
    return (q, q.shape[0], int_mbrs, int_par, h_offs, n_int,
            _c(level_mbrs[-1], torch.float32),
            _c(level_parents[-1], torch.int32), level_mbrs[-1].shape[0])


def _table_args(sl, level_mbrs, device):
    """The sliced kernels' table arguments: starts on the device, the
    widths as a host array, the tile count and the tile."""
    if not _slices_usable(sl, len(level_mbrs), int(level_mbrs[-1].shape[0]),
                          device):
        raise ValueError("the ancestor table does not match the tree "
                         "(level count, leaf tiles or device)")
    h_w = (ctypes.c_int * len(sl.widths))(*sl.widths)
    return _c(sl.starts, torch.int32), h_w, sl.n_tiles, sl.tl


def _prep_traverse_fused(queries, level_mbrs, level_parents):
    B, L = queries.shape[0], level_mbrs[-1].shape[0]
    args = _walk_args("traverse_fused", "fused", "full", queries, level_mbrs,
                      level_parents)
    out = torch.empty((B, L), dtype=torch.bool, device=queries.device)
    launch = _launcher("traverse_fused", queries.device, *args,
                       TRAVERSE_LEAF_CHUNK, out)
    return launch, out


def _prep_traverse_compact(queries, level_mbrs, level_parents, k):
    B, L = queries.shape[0], level_mbrs[-1].shape[0]
    if k <= 0:
        raise ValueError(f"traverse_compact needs k > 0, got {k}")
    args = _walk_args("traverse_compact", "compact", "full", queries,
                      level_mbrs, level_parents)
    idx = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=queries.device)
    launch = _launcher("traverse_compact", queries.device, *args, k, idx,
                       cnt)
    return launch, (idx, cnt)


def _prep_traverse_fused_sliced(queries, level_mbrs, level_parents, sl):
    B, L = queries.shape[0], level_mbrs[-1].shape[0]
    args = _walk_args("traverse_fused_sliced", "fused", "sliced", queries,
                      level_mbrs, level_parents, sl)
    out = torch.empty((B, L), dtype=torch.bool, device=queries.device)
    launch = _launcher("traverse_fused_sliced", queries.device, *args[:6],
                       *_table_args(sl, level_mbrs, queries.device),
                       *args[6:], out)
    return launch, out


def _prep_traverse_compact_sliced(queries, level_mbrs, level_parents, sl, k):
    B = queries.shape[0]
    if k <= 0:
        raise ValueError(f"traverse_compact_sliced needs k > 0, got {k}")
    args = _walk_args("traverse_compact_sliced", "compact", "sliced",
                      queries, level_mbrs, level_parents, sl)
    idx = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=queries.device)
    launch = _launcher("traverse_compact_sliced", queries.device, *args[:6],
                       *_table_args(sl, level_mbrs, queries.device),
                       *args[6:], k, idx, cnt)
    return launch, (idx, cnt)


def _prep_mbr_intersect(queries, mbrs):
    B, N = queries.shape[0], mbrs.shape[0]
    out = torch.empty((B, N), dtype=torch.bool, device=queries.device)
    launch = _launcher("mbr_intersect", queries.device,
                       _c(queries, torch.float32), B, _c(mbrs, torch.float32),
                       N, out)
    return launch, out


def _prep_leaf_refine(queries, leaf_entries, safe_idx, valid):
    B, K = safe_idx.shape
    M = leaf_entries.shape[1]
    out = torch.empty((B, K, M), dtype=torch.bool, device=queries.device)
    launch = _launcher(
        "leaf_refine", queries.device, _c(queries, torch.float32),
        _c(leaf_entries, torch.float32), M, _c(safe_idx, torch.int32),
        _c(valid, torch.bool), B, K, out)
    return launch, out


def _prep_mlp_predict_compact(x, cid, slot_ok, bank, n_leaves, k, threshold):
    C, F, H = bank.w1.shape
    Cl = bank.w2.shape[-1]
    B, S = cid.shape
    smem = (F + H) * 4 + (n_leaves + 31) // 32 * 4
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"mlp_predict_compact: {n_leaves} leaves need "
                         f"{smem} bytes of shared memory")
    idx = torch.empty((B, k), dtype=torch.int32, device=x.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=x.device)
    launch = _launcher(
        "mlp_predict_compact", x.device, _c(x, torch.float32),
        _c(cid, torch.int32), _c(slot_ok, torch.bool),
        _c(bank.w1, torch.float32), _c(bank.b1, torch.float32),
        _c(bank.w2, torch.float32), _c(bank.b2, torch.float32),
        _c(bank.label_map, torch.int32), _c(bank.lmask, torch.bool),
        B, S, F, H, Cl, n_leaves, k, float(threshold), idx, cnt)
    return launch, (idx, cnt)


def _prep_forest_infer(sel, thresh, tables):
    B, T, D = sel.shape
    C = tables.shape[-1]
    if tuple(tables.shape[:2]) != (T, 2 ** D):
        raise ValueError(f"forest tables {tuple(tables.shape)} do not match "
                         f"T={T}, D={D}")
    out = torch.empty((B, C), dtype=torch.float32, device=sel.device)
    launch = _launcher(
        "forest_infer", sel.device, _c(sel, torch.float32),
        _c(thresh, torch.float32), _c(tables, torch.float32), B, T, D, C,
        out)
    return launch, out


def _prep_forest_infer_cells(features, feat_idx, thresh, tables, n_cells):
    B, F = features.shape
    CT, D = feat_idx.shape
    if n_cells <= 0 or CT % n_cells:
        raise ValueError(f"forest_infer_cells: {CT} trees do not split "
                         f"into {n_cells} cells")
    if not 1 <= D <= 24:
        raise ValueError(f"forest_infer_cells: depth {D} not in [1, 24]")
    Cl = tables.shape[-1]
    if tuple(thresh.shape) != (CT, D) or \
            tuple(tables.shape[:2]) != (CT, 2 ** D):
        raise ValueError(f"forest_infer_cells: thresh {tuple(thresh.shape)}"
                         f" / tables {tuple(tables.shape)} do not match "
                         f"feat_idx {(CT, D)}")
    T = CT // n_cells
    smem = FOREST_QUERY_TILE * T * 4
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"forest_infer_cells: {T} trees a cell need {smem} "
                         f"bytes of shared memory (> {MAX_DYNAMIC_SMEM})")
    out = torch.empty((B, n_cells, Cl), dtype=torch.float32,
                      device=features.device)
    launch = _launcher(
        "forest_infer_cells", features.device, _c(features, torch.float32),
        B, F, _c(feat_idx, torch.int32), _c(thresh, torch.float32),
        _c(tables, torch.float32), n_cells, T, D, Cl, out)
    return launch, out


def _prep_knn_browse(centers, leaf_entries, safe_idx, valid):
    B, K = safe_idx.shape
    M = leaf_entries.shape[1]
    out = torch.empty((B, K, M), dtype=torch.float32, device=centers.device)
    launch = _launcher(
        "knn_browse", centers.device, _c(centers, torch.float32),
        _c(leaf_entries, torch.float32), M, _c(safe_idx, torch.int32),
        _c(valid, torch.bool), B, K, out)
    return launch, out


def _prep_spatial_key(cxy, curve, order=15):
    if curve not in CURVES:
        raise ValueError(f"curve must be one of {sorted(CURVES)}, got "
                         f"{curve!r}")
    if not 1 <= order <= 15:
        raise ValueError(f"order must be in [1, 15], got {order}")
    B = cxy.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=cxy.device)
    launch = _launcher("spatial_key", cxy.device, _c(cxy, torch.float32), B,
                       CURVES[curve], order, out)
    return launch, out


def _prep_delta_probe(queries, pts, k):
    B, cap = queries.shape[0], pts.shape[0]
    if k <= 0:
        raise ValueError(f"delta_probe needs k > 0, got {k}")
    smem = DELTA_QUERY_TILE * ((cap + 31) // 32) * 4
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"delta_probe: a buffer of {cap} points needs "
                         f"{smem} bytes of shared memory (> "
                         f"{MAX_DYNAMIC_SMEM})")
    idx = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=queries.device)
    launch = _launcher("delta_probe", queries.device,
                       _c(queries, torch.float32), B, _c(pts, torch.float32),
                       cap, k, idx, cnt)
    return launch, (idx, cnt)


_PREP = {"traverse_fused": _prep_traverse_fused,
         "traverse_compact": _prep_traverse_compact,
         "leaf_refine": _prep_leaf_refine,
         "knn_browse": _prep_knn_browse,
         "mlp_predict_compact": _prep_mlp_predict_compact,
         "forest_infer": _prep_forest_infer,
         "forest_infer_cells": _prep_forest_infer_cells,
         "spatial_key": _prep_spatial_key,
         "delta_probe": _prep_delta_probe,
         "mbr_intersect": _prep_mbr_intersect,
         "traverse_fused_sliced": _prep_traverse_fused_sliced,
         "traverse_compact_sliced": _prep_traverse_compact_sliced}


def prepare(name: str, *args):
    """``(launch, outputs)`` for kernel ``name`` on already-shaped CUDA
    inputs (the arguments of its ``_prep_*`` function)."""
    return _PREP[name](*args)


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def mbr_intersect(queries: torch.Tensor, mbrs: torch.Tensor) -> torch.Tensor:
    """[B, 4] × [N, 4] → [B, N] bool, closed-rectangle intersection."""
    if not _on_cuda(queries, mbrs):
        return ref.mbr_intersect(queries, mbrs)
    launch, out = _prep_mbr_intersect(queries, mbrs)
    if out.numel():
        launch()
    return out


def _per_level_walk(queries, level_mbrs, level_parents) -> torch.Tensor:
    """The ladder's last rung: one ``mbr_intersect`` per level, the
    frontier masks through device memory."""
    mask = mbr_intersect(queries, level_mbrs[0])
    for mbrs, parent in zip(level_mbrs[1:], level_parents[1:]):
        mask = mask[:, parent.long()] & mbr_intersect(queries, mbrs)
    return mask


def traverse_fused(queries: torch.Tensor,
                   level_mbrs: Sequence[torch.Tensor],
                   level_parents: Sequence[torch.Tensor],
                   slices=None) -> torch.Tensor:
    """Root→leaf traversal: [B, 4] → visited-leaf mask [B, L] bool.

    ``level_mbrs``: one [N_l, 4] tensor per level, root first, leaf level
    last; ``level_parents``: matching [N_l] i32 index into the level above
    (entry 0 unused). ``slices`` is the tree's ``AncestorTable``
    (``DeviceTree.aslices``), if the caller has one. On CUDA tensors the
    rung is ``walk_route("fused", ...)``'s; every rung gives the same mask,
    and CPU tensors run the plain walk.
    """
    if not _on_cuda(queries, *level_mbrs, *level_parents):
        return ref.traverse_fused(queries, level_mbrs, level_parents)
    route, sl = _plan("fused", queries, level_mbrs, level_parents, slices)
    if route == "mbr_intersect":
        return mbr_intersect(queries, level_mbrs[0])
    if route == "per_level":
        return _per_level_walk(queries, level_mbrs, level_parents)
    if route == "full":
        launch, out = _prep_traverse_fused(queries, level_mbrs,
                                           level_parents)
    else:
        launch, out = _prep_traverse_fused_sliced(queries, level_mbrs,
                                                  level_parents, sl)
    if out.numel():
        launch()
    return out


def traverse_compact(queries: torch.Tensor,
                     level_mbrs: Sequence[torch.Tensor],
                     level_parents: Sequence[torch.Tensor], k: int,
                     slices=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Traversal + compaction: [B, 4] → ``(leaf_idx [B, k] i32, valid
    [B, k] bool, count [B] i32)`` — the first ``k`` visited leaves in id
    order (0 past the count) and each row's visited count.

    Semantically ``compact_mask_counted(traverse_fused(...), k)``; on the
    full and sliced rungs on the card the ``[B, L]`` visited mask never
    exists. ``slices`` and the rungs as in ``traverse_fused``
    (``walk_route("compact", ...)``).
    """
    from repro_torch.core.traversal import compact_mask_counted
    if not _on_cuda(queries, *level_mbrs, *level_parents):
        return ref.traverse_compact(queries, level_mbrs, level_parents, k)
    route, sl = _plan("compact", queries, level_mbrs, level_parents, slices)
    if route == "mbr_intersect":
        return compact_mask_counted(mbr_intersect(queries, level_mbrs[0]), k)
    if route == "per_level":
        return compact_mask_counted(
            _per_level_walk(queries, level_mbrs, level_parents), k)
    if route == "full":
        launch, (idx, cnt) = _prep_traverse_compact(queries, level_mbrs,
                                                    level_parents, k)
    else:
        launch, (idx, cnt) = _prep_traverse_compact_sliced(
            queries, level_mbrs, level_parents, sl, k)
    if cnt.numel():
        launch()
    valid = torch.arange(k, dtype=torch.int32, device=cnt.device)[None, :] \
        < cnt[:, None]
    return idx, valid, cnt


def leaf_refine(queries: torch.Tensor, leaf_entries: torch.Tensor,
                leaf_idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """queries [B,4], leaf_entries [L,M,2], leaf_idx [B,K], valid [B,K]
    → inside [B, K, M] bool. Slot ids are clamped into [0, L) first
    (padded slots are masked by ``valid``)."""
    safe_idx = torch.clamp(leaf_idx, 0, leaf_entries.shape[0] - 1)
    if not _on_cuda(queries, leaf_entries, leaf_idx, valid):
        return ref.leaf_refine(queries, leaf_entries[..., 0],
                               leaf_entries[..., 1], safe_idx, valid)
    launch, out = _prep_leaf_refine(queries, leaf_entries, safe_idx, valid)
    if out.numel():
        launch()
    return out


def knn_browse(centers: torch.Tensor, leaf_entries: torch.Tensor,
               leaf_idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """centers [B,3] (cx, cy, r²), leaf_entries [L,M,2], leaf_idx/valid
    [B,K] → d2 [B, K, M] f32, +inf where masked. Slot ids are clamped
    into [0, L) first (padded slots are masked by ``valid``)."""
    safe_idx = torch.clamp(leaf_idx, 0, leaf_entries.shape[0] - 1)
    if not _on_cuda(centers, leaf_entries, leaf_idx, valid):
        return ref.knn_browse(centers, leaf_entries[..., 0],
                              leaf_entries[..., 1], safe_idx, valid)
    launch, out = _prep_knn_browse(centers, leaf_entries, safe_idx, valid)
    if out.numel():
        launch()
    return out


def delta_probe(queries: torch.Tensor, pts: torch.Tensor, *, k: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe the insert delta buffer: queries [B, 4] × buffer points
    [cap, 2] → ``(slot_idx [B, k] i32, valid [B, k] bool, count [B]
    i32)``, the first ``k`` hit positions in insertion order (0 past the
    count) and each row's full hit count (exact past ``k``).

    Semantically ``compact_mask_counted(contains(queries, pts), k)``; on
    the card the ``[B, cap]`` containment mask never exists. Unstaged
    buffer slots must hold +inf.
    """
    if not _on_cuda(queries, pts):
        return ref.delta_probe(queries, pts, k)
    launch, (idx, cnt) = _prep_delta_probe(queries, pts, k)
    if cnt.numel():
        launch()
    valid = torch.arange(k, dtype=torch.int32, device=cnt.device)[None, :] \
        < cnt[:, None]
    return idx, valid, cnt


def spatial_key_inputs(queries: torch.Tensor,
                       bbox: torch.Tensor | None = None) -> torch.Tensor:
    """The key kernel's input: rect centres ``(q0+q2)*0.5`` normalized by
    ``bbox`` ([4] xmin/ymin/xmax/ymax; the batch's own centre extent when
    None) as ``(c - lo) / max(hi - lo, 1e-12)`` → [B, 2] f32."""
    q = queries.to(torch.float32)
    cx = (q[:, 0] + q[:, 2]) * 0.5
    cy = (q[:, 1] + q[:, 3]) * 0.5
    if bbox is None:
        bbox = torch.stack([cx.min(), cy.min(), cx.max(), cy.max()])
    bbox = torch.as_tensor(bbox, dtype=torch.float32, device=q.device)
    span = torch.clamp(bbox[2:] - bbox[:2], min=1e-12)
    return (torch.stack([cx, cy], dim=1) - bbox[None, :2]) / span[None, :]


def spatial_key(queries: torch.Tensor, bbox: torch.Tensor | None = None,
                curve: str = "hilbert", order: int = 15) -> torch.Tensor:
    """Space-filling-curve keys of query rects: [B, 4] → [B] i32.

    Centres are normalized by ``bbox`` (pass the workload's, so keys are
    comparable across batches) and quantized to ``order`` bits;
    ``curve`` is ``"hilbert"`` or ``"morton"``.
    """
    cxy = spatial_key_inputs(queries, bbox)
    if not _on_cuda(cxy):
        return ref.spatial_key(cxy, curve=curve, order=order)
    launch, out = _prep_spatial_key(cxy, curve, order)
    if out.numel():
        launch()
    return out


def mlp_inputs(queries: torch.Tensor, bank, cell_ids: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's inputs: normalized features ``(q - mu) / sd`` and
    cell ids clipped into [0, C)."""
    x = (queries.to(torch.float32) - bank.mu) / bank.sd
    cid = torch.clamp(cell_ids.to(torch.int32), 0, bank.w1.shape[0] - 1)
    return x, cid


def mlp_predict_compact(queries: torch.Tensor, bank, cell_ids: torch.Tensor,
                        slot_ok: torch.Tensor, *, n_leaves: int, k: int,
                        threshold: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused AI-path prediction: queries [B, 4] + cell routing → compact
    predicted-leaf slots ``(leaf_idx [B, k] i32, valid [B, k] bool,
    count [B] i32)``.

    Semantically ``compact_mask_counted(predict_scores(...) > threshold,
    k)``; on the card the ``[B, n_leaves]`` score table never exists.
    ``bank`` is an ``MLPBank``; ``cell_ids``/``slot_ok`` [B, S] come from
    ``grid.cells_of_queries``. Requires ``threshold ≥ 0``.
    """
    if threshold < 0:
        raise ValueError("mlp_predict_compact needs threshold >= 0")
    x, cid = mlp_inputs(queries, bank, cell_ids)
    if not _on_cuda(x, cid, slot_ok, bank.w1):
        return ref.mlp_predict_compact(
            x, cid, slot_ok, bank.w1, bank.b1, bank.w2, bank.b2,
            bank.label_map, bank.lmask, n_leaves=n_leaves, k=k,
            threshold=threshold)
    launch, (idx, cnt) = _prep_mlp_predict_compact(
        x, cid, slot_ok, bank, n_leaves, k, threshold)
    if cnt.numel():
        launch()
    valid = torch.arange(k, dtype=torch.int32, device=x.device)[None, :] \
        < cnt[:, None]
    return idx, valid, cnt


def forest_infer(features: torch.Tensor, feat_idx: torch.Tensor,
                 thresh: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """features [B,F], feat_idx [T,D] i32, thresh [T,D], tables [T,2^D,C]
    → scores [B,C] (votes summed over trees in ascending order)."""
    sel = features[:, feat_idx.long()]            # [B, T, D] pre-gather
    if not _on_cuda(sel, thresh, tables):
        return ref.forest_infer(sel, thresh, tables)
    launch, out = _prep_forest_infer(sel, thresh, tables)
    if out.numel():
        launch()
    return out


def forest_infer_cells(features: torch.Tensor, feat_idx: torch.Tensor,
                       thresh: torch.Tensor, tables: torch.Tensor,
                       n_cells: int) -> torch.Tensor:
    """Celled forests: features [B,F], feat_idx/thresh [C·T,D] (cell c
    owns trees c·T .. c·T+T-1), tables [C·T,2^D,Cl] → votes [B, C, Cl],
    each cell's T tree votes summed in tree order (the caller divides by
    T). On the card the ``[B, C·T, D]`` feature gather never exists."""
    if not _on_cuda(features, feat_idx, thresh, tables):
        return ref.forest_infer_cells(features, feat_idx, thresh, tables,
                                      n_cells)
    launch, out = _prep_forest_infer_cells(features, feat_idx, thresh,
                                           tables, n_cells)
    if out.numel():
        launch()
    return out
