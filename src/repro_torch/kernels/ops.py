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
``mbr_intersect``; a tree within the full rung's reach
(``full_rung_bytes``) whose full walk fits one CTA's shared memory takes
the full-walk kernel, over the tree's ``WalkPack`` (packed from the
levels when the caller has none; parents that are not non-decreasing
then raise ``ValueError``); past that, the ancestor-sliced kernel over
the tree's ``AncestorTable`` (built from the parents when the caller has
none) within the sliced rung's reach (``sliced_rung_bytes``); and when
even the sliced walk does not fit, the per-level loop of
``mbr_intersect`` launches. CPU tensors take none of these rungs: they
run the one plain walk (``ref.traverse_fused`` / ``ref.traverse_compact``),
as the reference does with its kernels off.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from repro_torch.core.device_tree import (
    WalkPack, build_ancestor_table, build_walk_pack)
from repro_torch.kernels import ref
from repro_torch.kernels import cuda as _cuda

# The dense walk's queries per CTA (kQT in csrc/traverse_fused.cu) and
# its leaf chunk as a tile row of 32-bit words (kRowWords: kChunk / 4 and
# four words of padding); the compact walk's most warps (queries) a CTA
# (kWarps in csrc/traverse_compact.cu), each with two lists of int2
# child ranges as long as the widest internal level.
TRAVERSE_QUERY_TILE = 16
TRAVERSE_ROW_WORDS = 1024 // 4 + 4
COMPACT_WARPS = 4
# The full rung's reach: the shared memory the full walks asked for before
# their redesign (the dense walk: a byte a (query, node) of the widest
# internal level for 8 queries, twice; the compact walk: also an L-bit
# bitmap a query, for 4). The redesigned kernels' need no longer grows
# with L, so measured by it alone the 40M-point index's compact walk and
# the 1.5M-leaf routing tree would leave the sliced rung for the full one
# unmeasured. A tree takes the full rung only within this reach too, so
# every tree keeps the rung it had (ROADMAP: open question).
FULL_RUNG_ROWS = {"fused": 8, "compact": 4}
# The sliced dense walk's queries per CTA and its leaf round as a tile row
# of 32-bit words (kQT and kRowWords in csrc/traverse_fused_sliced.cu:
# 512 leaves, 2 a thread, and four words of padding), and the sliced
# rung's reach: the redesigned kernel asks for a 32-bit row mask a window
# node of every level where the first asked for a byte a (query, node)
# for 8 queries, twice, at the widest window; measured by its own need
# the routing tree's degenerate windows would leave the per-level rung,
# so a table takes the sliced rung only within the first kernel's need
# too.
SLICED_QUERY_TILE = 32
SLICED_ROW_WORDS = 512 // 4 + 4
SLICED_RUNG_ROWS = 8
COMPACT_SLICED_QUERY_TILE = 8   # kQT in csrc/traverse_compact_sliced.cu
COMPACT_SLICED_ROUND_WORDS = 16  # kRound / 32 there: bitmap words a row
FOREST_QUERY_TILE = 32    # kQT in csrc/forest_infer_cells.cu
ROUTER_QUERY_TILE = 8     # kQT in csrc/forest_infer.cu
KNN_MAX_K = 64            # kMaxK in csrc/knn_browse.cu: the largest k
WKV6_CHUNK = 64           # the reference's DEF_CHUNK (kernels/wkv6.py)
WKV6_HEAD = 64            # kD in csrc/wkv6.cu: its dk = dv (smaller pad)
CURVES = {"morton": 0, "hilbert": 1}
# Shared memory one CTA may ask for on sm_90 (232,448 bytes, less room
# for the kernels' static shared memory).
MAX_DYNAMIC_SMEM = 227 * 1024 - 1024
# The card's SMs (H100 SXM), and the CTAs of each pass of
# traverse_compact_sliced that compact_sliced_segments aims for on each:
# four waves of the four an SM holds (kMinBlocks there), measured best on
# the 40M-point index's kNN batches (PERF.md).
SM_COUNT = 132
COMPACT_SLICED_CTAS_PER_SM = 16

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


def _c16(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_c``, copied when its data does not start on 16 bytes (a view at
    an odd offset): for kernels that load 16 bytes a lane."""
    t = _c(t, dtype)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launcher(name: str, device: torch.device, *args,
              symbol: str | None = None) -> Callable[[], None]:
    """A closure that launches kernel ``name`` (its launcher ``symbol``,
    else its first) on ``device``'s current stream. ``args`` mixes tensors
    (passed as device pointers; the closure keeps them alive) and plain
    ints/floats/ctypes values."""
    kernel = _cuda.KERNELS[name]
    cargs = [a.data_ptr() if torch.is_tensor(a) else a for a in args]

    def launch() -> None:
        with torch.cuda.device(device):
            kernel(*cargs, torch.cuda.current_stream(device).cuda_stream,
                   symbol=symbol)
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
            # the mask tile, kQT rows of a leaf chunk; and a kQT-bit row
            # mask a node of the widest internal level, twice
            return TRAVERSE_QUERY_TILE * TRAVERSE_ROW_WORDS * 4 + \
                2 * width * (TRAVERSE_QUERY_TILE // 8)
        return compact_warps(width) * 2 * width * 8
    if route == "sliced":
        if kind == "fused":
            # the mask tile, kQT rows of a leaf round; and a kQT-bit row
            # mask a node of every level's window
            return SLICED_QUERY_TILE * SLICED_ROW_WORDS * 4 + \
                sum(widths) * (SLICED_QUERY_TILE // 8)
        # one kQT-bit mask per window node (16-byte aligned), and the
        # write pass's bitmap of a round's words a row
        mask = 1 if COMPACT_SLICED_QUERY_TILE <= 8 else \
            2 if COMPACT_SLICED_QUERY_TILE <= 16 else 4
        return -(-sum(widths) * mask // 16) * 16 + \
            COMPACT_SLICED_QUERY_TILE * COMPACT_SLICED_ROUND_WORDS * 4
    raise ValueError(f"no shared-memory walk on route {route!r}")


def compact_warps(width: int) -> int:
    """Warps (queries) a CTA of the full compact walk: ``COMPACT_WARPS``,
    fewer when their lists (2 × ``width`` int2 a warp) would outgrow
    ``MAX_DYNAMIC_SMEM``, at least one (the launch in
    csrc/traverse_compact.cu picks the same)."""
    return max(1, min(COMPACT_WARPS, MAX_DYNAMIC_SMEM // (16 * width)))


def full_rung_bytes(kind: str, level_sizes: Sequence[int]) -> int:
    """The full rung's reach for walk ``kind`` on a tree of
    ``level_sizes``: the shared memory its kernel asked for before the
    redesign (``FULL_RUNG_ROWS``), which must fit ``MAX_DYNAMIC_SMEM``."""
    width = max(level_sizes[:-1], default=1)
    rows = FULL_RUNG_ROWS[kind]
    if kind == "fused":
        return 2 * rows * width
    return rows * ((level_sizes[-1] + 31) // 32 * 4 + 2 * width)


def sliced_rung_bytes(kind: str, level_sizes: Sequence[int],
                      widths: Sequence[int], tl: int) -> int:
    """The sliced rung's reach for walk ``kind`` with a table of window
    ``widths`` and leaf tile ``tl``: for the dense walk the shared memory
    its first kernel asked for (a byte a (query, window node) for
    ``SLICED_RUNG_ROWS`` queries, twice), for the compact walk its
    kernel's own need."""
    if kind == "fused":
        return 2 * SLICED_RUNG_ROWS * max(widths)
    return walk_smem(kind, "sliced", level_sizes, widths, tl)


def walk_route(kind: str, level_sizes: Sequence[int],
               widths: Sequence[int] | None = None,
               tl: int | None = None) -> str:
    """The rung walk ``kind`` (``"fused"``: dense mask; ``"compact"``:
    slot table) takes for a tree of ``level_sizes`` nodes per level, root
    first: ``"mbr_intersect"`` for a single level, ``"full"`` when both
    the full rung's reach (``full_rung_bytes``) and the full walk's shared
    memory fit ``MAX_DYNAMIC_SMEM``, else ``"sliced"`` when
    an ancestor table of window ``widths`` and leaf tile ``tl`` is given
    and both the sliced rung's reach (``sliced_rung_bytes``) and its
    walk's shared memory fit, else ``"per_level"``."""
    if kind not in ("fused", "compact"):
        raise ValueError(f"walk kind must be fused or compact, got {kind!r}")
    if len(level_sizes) == 1:
        return "mbr_intersect"
    if max(full_rung_bytes(kind, level_sizes),
           walk_smem(kind, "full", level_sizes)) <= MAX_DYNAMIC_SMEM:
        return "full"
    if widths is not None and \
            max(sliced_rung_bytes(kind, level_sizes, widths, tl),
                walk_smem(kind, "sliced", level_sizes, widths, tl)) <= \
            MAX_DYNAMIC_SMEM:
        return "sliced"
    return "per_level"


def compact_sliced_segments(B: int, n_tiles: int) -> int:
    """S, the number of contiguous leaf-tile segments the sliced compact
    walk splits its ``n_tiles`` tiles into for ``B`` queries: enough that
    the ``ceil(B / kQT) * S`` CTAs of each pass put
    ``COMPACT_SLICED_CTAS_PER_SM`` on every SM, and no more than gives
    every segment a tile: S segments of ``ceil(n_tiles / S)`` tiles, the
    last one possibly shorter. Each CTA walks its windows once before its
    leaves, so more segments split the dense clusters' leaves finer but
    pay that walk more often."""
    groups = -(-B // COMPACT_SLICED_QUERY_TILE)
    fill = -(-SM_COUNT * COMPACT_SLICED_CTAS_PER_SM // groups)
    per = -(-n_tiles // max(1, min(n_tiles, fill)))
    return -(-n_tiles // per)


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

def _pack_usable(pack, sizes, device: torch.device) -> bool:
    """Does this ``WalkPack`` match the tree being walked (its level
    sizes, the walk's device)? A pack of another tree is rejected."""
    return (pack is not None and pack.level_sizes == tuple(sizes)
            and pack.int_mbrs.device == device)


def walk_pack(level_mbrs, level_parents, pack: WalkPack | None = None
              ) -> WalkPack:
    """``pack`` when it matches the tree, else the tree packed now
    (``build_walk_pack``: a ``ValueError`` when a level's parents are not
    non-decreasing, and then no walk kernel runs)."""
    sizes = [int(m.shape[0]) for m in level_mbrs]
    if _pack_usable(pack, sizes, level_mbrs[0].device):
        return pack
    return build_walk_pack(level_mbrs, level_parents)


def _walk_args(name, kind, route, queries, level_mbrs, level_parents,
               sl=None, pack=None):
    """The walk kernels' shared arguments: queries, the internal levels
    packed root first (the tree's ``WalkPack``) with their host offsets,
    and the leaf level; and the pack. A walk whose shared memory
    outgrows one CTA raises."""
    sizes = [int(m.shape[0]) for m in level_mbrs]
    table = () if sl is None else (sl.widths, sl.tl)
    smem = walk_smem(kind, route, sizes, *table)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"{name}: a tree of levels {sizes}"
            + (f" (windows {list(sl.widths)})" if sl is not None else "")
            + f" needs {smem} bytes of shared memory (> {MAX_DYNAMIC_SMEM}); "
            "walk_route sends it to another rung")
    pk = walk_pack(level_mbrs, level_parents, pack)
    q = _c(queries, torch.float32)
    n_int = len(level_mbrs) - 1
    # a single-level tree's empty packs are never read: pass the queries
    int_mbrs, int_par = (pk.int_mbrs, pk.int_parents) if n_int else (q, q)
    h_offs = (ctypes.c_int * len(pk.offsets))(*pk.offsets)
    return (q, q.shape[0], int_mbrs, int_par, h_offs, n_int,
            _c16(level_mbrs[-1], torch.float32),
            _c16(level_parents[-1], torch.int32), sizes[-1]), pk


def _table_args(sl, level_mbrs, device):
    """The sliced kernels' table arguments: starts on the device, the
    widths as a host array, the tile count and the tile."""
    if not _slices_usable(sl, len(level_mbrs), int(level_mbrs[-1].shape[0]),
                          device):
        raise ValueError("the ancestor table does not match the tree "
                         "(level count, leaf tiles or device)")
    h_w = (ctypes.c_int * len(sl.widths))(*sl.widths)
    return _c(sl.starts, torch.int32), h_w, sl.n_tiles, sl.tl


def _prep_traverse_fused(queries, level_mbrs, level_parents, pack=None):
    B, L = queries.shape[0], level_mbrs[-1].shape[0]
    args, _ = _walk_args("traverse_fused", "fused", "full", queries,
                         level_mbrs, level_parents, pack=pack)
    out = torch.empty((B, L), dtype=torch.bool, device=queries.device)
    launch = _launcher("traverse_fused", queries.device, *args, out)
    return launch, out


def _prep_traverse_compact(queries, level_mbrs, level_parents, k,
                           pack=None):
    B = queries.shape[0]
    if k <= 0:
        raise ValueError(f"traverse_compact needs k > 0, got {k}")
    args, pk = _walk_args("traverse_compact", "compact", "full", queries,
                          level_mbrs, level_parents, pack=pack)
    q, _, int_mbrs, _, h_offs, n_int, leaf_mbrs, _, L = args
    # the walk reads each internal node's child range, not its parent
    ranges = pk.child_ranges if n_int else q
    idx = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=queries.device)
    launch = _launcher("traverse_compact", queries.device, q, B, int_mbrs,
                       ranges, h_offs, n_int, leaf_mbrs, L, k, idx, cnt)
    return launch, (idx, cnt)


def _prep_traverse_fused_sliced(queries, level_mbrs, level_parents, sl,
                                pack=None):
    B, L = queries.shape[0], level_mbrs[-1].shape[0]
    args, _ = _walk_args("traverse_fused_sliced", "fused", "sliced",
                         queries, level_mbrs, level_parents, sl, pack)
    out = torch.empty((B, L), dtype=torch.bool, device=queries.device)
    launch = _launcher("traverse_fused_sliced", queries.device, *args[:6],
                       *_table_args(sl, level_mbrs, queries.device),
                       *args[6:], out)
    return launch, out


def _prep_traverse_compact_sliced(queries, level_mbrs, level_parents, sl, k,
                                  pack=None):
    B = queries.shape[0]
    if k <= 0:
        raise ValueError(f"traverse_compact_sliced needs k > 0, got {k}")
    args, _ = _walk_args("traverse_compact_sliced", "compact", "sliced",
                         queries, level_mbrs, level_parents, sl, pack)
    S = compact_sliced_segments(B, sl.n_tiles)
    idx = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=queries.device)
    # each (row, segment)'s visit count, then its first rank; and the
    # first leaf of the round of its first visit there
    scratch = torch.empty((2, B, S), dtype=torch.int32,
                          device=queries.device)
    launch = _launcher("traverse_compact_sliced", queries.device, *args[:6],
                       *_table_args(sl, level_mbrs, queries.device),
                       *args[6:], k, idx, cnt, scratch, S)
    return launch, (idx, cnt)


def _prep_mbr_intersect(queries, mbrs, parent_mask=None, parents=None):
    B, N = queries.shape[0], mbrs.shape[0]
    fold = (None, None, 0)
    if parents is not None:
        Np = parent_mask.shape[-1]
        if parent_mask.shape != (B, Np) or parents.shape != (N,) or \
                (N and not Np):
            raise ValueError(f"mbr_intersect: parent_mask "
                             f"{tuple(parent_mask.shape)} / parents "
                             f"{tuple(parents.shape)} do not match {B} "
                             f"queries and {N} MBRs")
        fold = (_c(parent_mask, torch.bool), _c(parents, torch.int32), Np)
    out = torch.empty((B, N), dtype=torch.bool, device=queries.device)
    launch = _launcher("mbr_intersect", queries.device,
                       _c16(queries, torch.float32), B,
                       _c16(mbrs, torch.float32), N, *fold, out)
    return launch, out


def _prep_leaf_refine(queries, leaf_entries, leaf_idx, valid):
    B, K = leaf_idx.shape
    L, M = leaf_entries.shape[:2]
    if L <= 0 or M <= 0 or M % 4:
        raise ValueError(f"leaf_refine: the kernel takes leaves of a "
                         f"positive multiple of 4 entries, got [{L}, {M}]")
    dev = queries.device
    inside = torch.empty((B, K, M), dtype=torch.bool, device=dev)
    counts = torch.empty((B, K), dtype=torch.int32, device=dev)
    launch = _launcher(
        "leaf_refine", dev, _c16(queries, torch.float32),
        _c16(leaf_entries, torch.float32), L, M, _c(leaf_idx, torch.int32),
        _c(valid, torch.bool), B, K, inside, counts)
    return launch, (inside, counts)


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


def _prep_forest_infer(features, feat_idx, thresh, tables):
    B, F = features.shape
    T, D = feat_idx.shape
    C = tables.shape[-1]
    if not 1 <= D <= 24:
        raise ValueError(f"forest_infer: depth {D} not in [1, 24]")
    if tuple(thresh.shape) != (T, D) or \
            tuple(tables.shape[:2]) != (T, 2 ** D):
        raise ValueError(f"forest_infer: thresh {tuple(thresh.shape)} / "
                         f"tables {tuple(tables.shape)} do not match "
                         f"feat_idx {(T, D)}")
    smem = (2 * T * D + ROUTER_QUERY_TILE * (F + T * C)) * 4
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"forest_infer: {T} trees of {C} classes need "
                         f"{smem} bytes of shared memory (> "
                         f"{MAX_DYNAMIC_SMEM})")
    out = torch.empty((B, C), dtype=torch.float32, device=features.device)
    launch = _launcher(
        "forest_infer", features.device, _c(features, torch.float32), B, F,
        _c(feat_idx, torch.int32), _c(thresh, torch.float32),
        _c(tables, torch.float32), T, D, C, out)
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


def _prep_knn_browse_topk(centers, leaf_entries, entry_ids, leaf_idx, valid,
                         k):
    B, K = leaf_idx.shape
    L, M = leaf_entries.shape[:2]
    if L <= 0 or M <= 0 or M % 2 or K <= 0 or K * M >= 2 ** 31:
        raise ValueError(f"knn_browse_topk: the kernel takes leaves of a "
                         f"positive even number of entries and K·M < 2^31, "
                         f"got [{L}, {M}] leaves and K {K}")
    if not 1 <= k <= min(KNN_MAX_K, K * M):
        raise ValueError(f"knn_browse_topk: k must lie in [1, "
                         f"{min(KNN_MAX_K, K * M)}] (the kernel keeps at "
                         f"most {KNN_MAX_K}), got {k}")
    # the slot table and its valid list beside the warps' lists (4 KB at
    # k 64)
    if K * 8 > MAX_DYNAMIC_SMEM - 4096:
        raise ValueError(f"knn_browse_topk: a slot table of {K} slots "
                         f"needs {K * 8} bytes of shared memory (> "
                         f"{MAX_DYNAMIC_SMEM - 4096})")
    dev = centers.device
    d2k = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    n_within = torch.empty((B,), dtype=torch.int32, device=dev)
    launch = _launcher(
        "knn_browse", dev, _c(centers, torch.float32),
        _c16(leaf_entries, torch.float32), L, M, _c(entry_ids, torch.int32),
        _c(leaf_idx, torch.int32), _c(valid, torch.bool), B, K, k, d2k, ids,
        n_within, symbol="knn_browse_topk_launch")
    return launch, (d2k, ids, n_within)


def _prep_spatial_key(queries, bbox, curve, order=15):
    if curve not in CURVES:
        raise ValueError(f"curve must be one of {sorted(CURVES)}, got "
                         f"{curve!r}")
    if not 1 <= order <= 15:
        raise ValueError(f"order must be in [1, 15], got {order}")
    if queries.ndim != 2 or queries.shape[1] != 4:
        raise ValueError(f"spatial_key takes [B, 4] rects, got "
                         f"{tuple(queries.shape)}")
    frame = key_frame(queries, bbox)
    if tuple(frame.shape) != (4,):
        raise ValueError(f"spatial_key: the frame must be [4] (xmin, ymin, "
                         f"xmax, ymax), got {tuple(frame.shape)}")
    B = queries.shape[0]
    out = torch.empty((B,), dtype=torch.int32, device=queries.device)
    launch = _launcher("spatial_key", queries.device,
                       _c16(queries, torch.float32),
                       _c16(frame, torch.float32), B, CURVES[curve], order,
                       out)
    return launch, out


def _prep_delta_probe(queries, pts, k):
    B, cap = queries.shape[0], pts.shape[0]
    if k <= 0:
        raise ValueError(f"delta_probe needs k > 0, got {k}")
    idx = torch.empty((B, k), dtype=torch.int32, device=queries.device)
    cnt = torch.empty((B,), dtype=torch.int32, device=queries.device)
    launch = _launcher("delta_probe", queries.device,
                       _c16(queries, torch.float32), B,
                       _c16(pts, torch.float32), cap, k, idx, cnt)
    return launch, (idx, cnt)


def _prep_wkv6(r, k, v, w, u, chunk):
    BH, T, dk = r.shape
    dv = v.shape[-1]
    if tuple(k.shape) != (BH, T, dk) or tuple(w.shape) != (BH, T, dk) or \
            tuple(v.shape[:2]) != (BH, T) or tuple(u.shape) != (BH, dk):
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, "
                         f"u {tuple(u.shape)} do not match")
    if chunk <= 0 or chunk % 16 or chunk > 64 or T % chunk:
        raise ValueError(f"wkv6: chunk {chunk} must be a multiple of 16, at "
                         f"most 64, that divides T={T}")
    if dk > WKV6_HEAD or dv > WKV6_HEAD:
        raise ValueError(f"wkv6: dk {dk}, dv {dv}: the kernel takes heads "
                         f"of at most {WKV6_HEAD}")
    # smaller heads are padded with channels that add nothing: r = k = u
    # = v = 0, w = 1; y's padded columns are sliced off
    D = WKV6_HEAD

    def pad(a, n, value=0.0):
        a = _c(a, torch.float32)
        return torch.nn.functional.pad(a, (0, D - n), value=value) \
            if n < D else a
    nc = T // chunk
    dev = r.device
    states = torch.empty((BH, nc, D, D), dtype=torch.float32, device=dev)
    decay = torch.empty((BH, nc, D), dtype=torch.float32, device=dev)
    y = torch.empty((BH, T, D), dtype=torch.float32, device=dev)
    launch = _launcher("wkv6", dev, pad(r, dk), pad(k, dk), pad(v, dv),
                       pad(w, dk, 1.0), pad(u, dk), BH, T, chunk, states,
                       decay, y)
    return launch, y[..., :dv]


_PREP = {"traverse_fused": _prep_traverse_fused,
         "traverse_compact": _prep_traverse_compact,
         "leaf_refine": _prep_leaf_refine,
         "knn_browse": _prep_knn_browse,
         "knn_browse_topk": _prep_knn_browse_topk,
         "mlp_predict_compact": _prep_mlp_predict_compact,
         "forest_infer": _prep_forest_infer,
         "forest_infer_cells": _prep_forest_infer_cells,
         "spatial_key": _prep_spatial_key,
         "delta_probe": _prep_delta_probe,
         "mbr_intersect": _prep_mbr_intersect,
         "traverse_fused_sliced": _prep_traverse_fused_sliced,
         "traverse_compact_sliced": _prep_traverse_compact_sliced,
         "wkv6": _prep_wkv6}


def prepare(name: str, *args):
    """``(launch, outputs)`` for kernel ``name`` on already-shaped CUDA
    inputs (the arguments of its ``_prep_*`` function)."""
    return _PREP[name](*args)


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------

def mbr_intersect(queries: torch.Tensor, mbrs: torch.Tensor,
                  parent_mask: torch.Tensor | None = None,
                  parents: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 4] × [N, 4] → [B, N] bool, closed-rectangle intersection; with
    the level above's ``parent_mask`` [B, N_prev] and the MBRs' ``parents``
    [N] (any order, each in [0, N_prev)), ``parent_mask[:, parents] & hit``
    in the same launch."""
    if (parent_mask is None) != (parents is None):
        raise ValueError("mbr_intersect: give parent_mask and parents "
                         "together, or neither")
    fold = () if parents is None else (parent_mask, parents)
    if not _on_cuda(queries, mbrs, *fold):
        return ref.mbr_intersect(queries, mbrs, *fold)
    launch, out = _prep_mbr_intersect(queries, mbrs, *fold)
    if out.numel():
        launch()
    return out


def _per_level_walk(queries, level_mbrs, level_parents) -> torch.Tensor:
    """The ladder's last rung: one ``mbr_intersect`` per level, each
    folding the level above's mask through its parents; the frontier
    masks go through device memory."""
    mask = mbr_intersect(queries, level_mbrs[0])
    for mbrs, parent in zip(level_mbrs[1:], level_parents[1:]):
        mask = mbr_intersect(queries, mbrs, mask, parent)
    return mask


def traverse_fused(queries: torch.Tensor,
                   level_mbrs: Sequence[torch.Tensor],
                   level_parents: Sequence[torch.Tensor],
                   slices=None, pack: WalkPack | None = None
                   ) -> torch.Tensor:
    """Root→leaf traversal: [B, 4] → visited-leaf mask [B, L] bool.

    ``level_mbrs``: one [N_l, 4] tensor per level, root first, leaf level
    last; ``level_parents``: matching [N_l] i32 index into the level above
    (entry 0 unused). ``slices`` is the tree's ``AncestorTable``
    (``DeviceTree.aslices``) and ``pack`` its ``WalkPack``
    (``DeviceTree.wpack``), if the caller has them. On CUDA tensors the
    rung is ``walk_route("fused", ...)``'s; every rung gives the same mask,
    and CPU tensors run the plain walk. The kernel rungs need each
    level's parents non-decreasing (``ValueError`` otherwise).
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
                                           level_parents, pack)
    else:
        launch, out = _prep_traverse_fused_sliced(queries, level_mbrs,
                                                  level_parents, sl, pack)
    if out.numel():
        launch()
    return out


def traverse_compact(queries: torch.Tensor,
                     level_mbrs: Sequence[torch.Tensor],
                     level_parents: Sequence[torch.Tensor], k: int,
                     slices=None, pack: WalkPack | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Traversal + compaction: [B, 4] → ``(leaf_idx [B, k] i32, valid
    [B, k] bool, count [B] i32)`` — the first ``k`` visited leaves in id
    order (0 past the count) and each row's visited count.

    Semantically ``compact_mask_counted(traverse_fused(...), k)``; on the
    full and sliced rungs on the card the ``[B, L]`` visited mask never
    exists. ``slices``, ``pack`` and the rungs as in ``traverse_fused``
    (``walk_route("compact", ...)``); the full rung walks the pack's child
    ranges.
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
                                                    level_parents, k, pack)
    else:
        launch, (idx, cnt) = _prep_traverse_compact_sliced(
            queries, level_mbrs, level_parents, sl, k, pack)
    if cnt.numel():
        launch()
    valid = torch.arange(k, dtype=torch.int32, device=cnt.device)[None, :] \
        < cnt[:, None]
    return idx, valid, cnt


def leaf_refine_counted(queries: torch.Tensor, leaf_entries: torch.Tensor,
                        leaf_idx: torch.Tensor, valid: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [B,4], leaf_entries [L,M,2], leaf_idx [B,K], valid [B,K]
    → ``(inside [B, K, M] bool, counts [B, K] i32)``, ``counts`` the
    integer sum of ``inside`` over M. Slot ids are clamped into [0, L)
    (padded slots are masked by ``valid``). On the card this is one
    launch, which clamps and counts in the same pass; M must then be a
    multiple of 4 (``flatten`` pads it to one of 8)."""
    if not _on_cuda(queries, leaf_entries, leaf_idx, valid):
        return ref.leaf_refine_counted(queries, leaf_entries[..., 0],
                                       leaf_entries[..., 1], leaf_idx, valid)
    launch, (inside, counts) = _prep_leaf_refine(queries, leaf_entries,
                                                 leaf_idx, valid)
    if counts.numel():
        launch()
    return inside, counts


def leaf_refine(queries: torch.Tensor, leaf_entries: torch.Tensor,
                leaf_idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The mask of ``leaf_refine_counted``: inside [B, K, M] bool."""
    return leaf_refine_counted(queries, leaf_entries, leaf_idx, valid)[0]


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


def knn_browse_topk(centers: torch.Tensor, leaf_entries: torch.Tensor,
                    leaf_entry_ids: torch.Tensor, leaf_idx: torch.Tensor,
                    valid: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``knn_browse`` and the k smallest of each row in one step:
    centers [B,3] (cx, cy, r²), leaf_entries [L,M,2], leaf_entry_ids
    [L,M], leaf_idx/valid [B,K] → ``(d2k [B, kk] f32, ids [B, kk] i32,
    n_within [B] i32)``, kk = min(k, K·M): the kk smallest in-radius
    squared distances ascending, ties to the lower flat position
    slot·M + m (``lax.top_k`` of ``-d2``), the winners' entry ids, +inf
    and -1 where fewer lie within the radius, and each row's count of
    in-radius candidates. Slot ids are clamped into [0, L).

    On the card this is one ``knn_browse`` launch that picks the winners
    on chip: the [B, K, M] distances never exist. It takes k up to
    ``KNN_MAX_K`` and leaves of an even number of entries, and raises
    past them."""
    if not _on_cuda(centers, leaf_entries, leaf_entry_ids, leaf_idx, valid):
        safe_idx = torch.clamp(leaf_idx, 0, leaf_entries.shape[0] - 1)
        return ref.knn_browse_topk(centers, leaf_entries[..., 0],
                                   leaf_entries[..., 1], leaf_entry_ids,
                                   safe_idx, valid, k)
    kk = min(k, leaf_idx.shape[1] * leaf_entries.shape[1])
    launch, out = _prep_knn_browse_topk(centers, leaf_entries,
                                        leaf_entry_ids, leaf_idx, valid, kk)
    if leaf_idx.shape[0]:
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


def _centres(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rect centres ``((q0+q2)*0.5, (q1+q3)*0.5)``, f32."""
    q = queries.to(torch.float32)
    return (q[:, 0] + q[:, 2]) * 0.5, (q[:, 1] + q[:, 3]) * 0.5


def key_frame(queries: torch.Tensor,
              bbox: torch.Tensor | None = None) -> torch.Tensor:
    """The keys' frame on the queries' device, [4] f32 xmin/ymin/xmax/ymax:
    ``bbox``, or the batch's own centre extent when None."""
    if bbox is None:
        cx, cy = _centres(queries)
        return torch.stack([cx.min(), cy.min(), cx.max(), cy.max()])
    return torch.as_tensor(bbox, dtype=torch.float32, device=queries.device)


def spatial_key_inputs(queries: torch.Tensor,
                       bbox: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version's first half: rect centres ``(q0+q2)*0.5``
    normalized by ``key_frame(queries, bbox)`` as ``(c - lo) / max(hi -
    lo, 1e-12)`` → [B, 2] f32 (what ``ref.spatial_key`` takes)."""
    cx, cy = _centres(queries)
    frame = key_frame(queries, bbox)
    span = torch.clamp(frame[2:] - frame[:2], min=1e-12)
    return (torch.stack([cx, cy], dim=1) - frame[None, :2]) / span[None, :]


def spatial_key(queries: torch.Tensor, bbox: torch.Tensor | None = None,
                curve: str = "hilbert", order: int = 15) -> torch.Tensor:
    """Space-filling-curve keys of query rects: [B, 4] → [B] i32.

    Centres are normalized by ``bbox`` ([4] xmin/ymin/xmax/ymax; pass the
    workload's, so keys are comparable across batches) and quantized to
    ``order`` bits; ``curve`` is ``"hilbert"`` or ``"morton"``. On the
    card a call with a frame on the device is one launch that reads the
    rects and the frame and normalizes in registers. ``bbox=None`` (the
    batch's own extent) first computes the frame in PyTorch; no serving
    path takes that branch (``schedule.spatial_keys`` and the runtime
    always pass the workload's frame). CPU tensors run the plain version,
    ``ref.spatial_key(spatial_key_inputs(queries, bbox))``.
    """
    if not _on_cuda(queries):
        return ref.spatial_key(spatial_key_inputs(queries, bbox),
                               curve=curve, order=order)
    launch, out = _prep_spatial_key(queries, bbox, curve, order)
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
    """features [B,F], feat_idx [T,D] i32 (a negative id wrapped once,
    then clamped into [0, F), as the reference's gather does), thresh
    [T,D], tables [T,2^D,C] → scores [B,C] (votes
    summed over trees in ascending order). On the card the kernel gathers
    the features itself: one launch, and the [B, T, D] gather never
    exists."""
    if not _on_cuda(features, feat_idx, thresh, tables):
        return ref.forest_infer(ref.forest_select(features, feat_idx),
                                thresh, tables)
    launch, out = _prep_forest_infer(features, feat_idx, thresh, tables)
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


def pad_time(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, chunk: int):
    """Pad T of r, k, v, w ``[BH, T, ·]`` to a multiple of ``chunk`` with
    identity steps (``w = 1``, ``k = r = v = 0``): the state passes them
    unchanged and their outputs are sliced off."""
    pad = (-r.shape[1]) % chunk
    if not pad:
        return r, k, v, w

    def ext(a, value):
        return torch.nn.functional.pad(a, (0, 0, 0, pad), value=value)
    return ext(r, 0.0), ext(k, 0.0), ext(v, 0.0), ext(w, 1.0)


class _WKV6(torch.autograd.Function):
    """The card's scan under autograd, as the reference's ``custom_vjp``
    (``src/repro/kernels/ops.py:674-690``): the forward launches the
    kernel and saves only its inputs; the backward recomputes the plain
    scan (``ref.wkv6``) on them under autograd and differentiates that.
    There is no backward kernel, as in the reference."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        T = r.shape[1]
        r, k, v, w, u = (a.to(torch.float32) for a in (r, k, v, w, u))
        launch, y = _prep_wkv6(*pad_time(r, k, v, w, chunk), u, chunk)
        if y.numel():
            launch()
        return y[:, :T]

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        want = [i for i, need in enumerate(ctx.needs_input_grad[:5]) if need]
        with torch.enable_grad():
            xs = [a.detach().requires_grad_(i in want)
                  for i, a in enumerate(saved)]
            y = ref.wkv6(*xs)
            got = torch.autograd.grad(y, [xs[i] for i in want], gy)
        grads = [None] * 6
        for i, g in zip(want, got):
            grads[i] = g.to(saved[i].dtype)
        return tuple(grads)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, chunk: int = WKV6_CHUNK) -> torch.Tensor:
    """RWKV-6 scan: r/k/w [BH,T,dk], v [BH,T,dv], u [BH,dk] → y [BH,T,dv]
    float32. On the card the chunk-parallel kernels (one launch: chunk
    state deltas, the pass over chunk states, the outputs) over T padded
    to a multiple of ``chunk``, with chunk-state scratch of BH·T/chunk·
    64·64 floats; on the CPU the sequential plain version. The card takes
    dk, dv <= 64 (padded to 64) and a chunk that is a multiple of 16, at
    most 64; anything else raises ``ValueError``.

    Differentiable on both devices: on the CPU through the plain scan
    itself, on the card through ``_WKV6`` (the kernel forward, the plain
    scan recomputed for the backward); gradients come back in the
    inputs' own dtypes."""
    if not _on_cuda(r, k, v, w, u):
        return ref.wkv6(r, k, v, w, u)
    return _WKV6.apply(r, k, v, w, u, chunk)
