"""The walk kernels' per-tree inputs, their rungs, and the forest's ids.

On the CPU, where the walks run their plain versions, this file holds
what the card's full walks rely on and can be checked without a card:

* the ``WalkPack``'s child ranges (``device_tree.build_walk_pack``), as
  ``flatten``, ``bridge.tree_from_reference`` and the wrappers' on-the-fly
  build (``ops.walk_pack``) make them, agree with one another and with
  the parents, empty ranges included; parents that are not
  non-decreasing are refused;
* the rung ``ops.walk_route`` gives the trees ``chip_smoke.py`` walks,
  pinned by their level sizes (and table windows), and the shared memory
  ``ops.walk_smem`` reports for the redesigned full walks;
* the card's two full walks rehearsed step for step in numpy
  (``_compact_mirror``: a warp's walk over the live nodes' child ranges,
  ``csrc/traverse_compact.cu``; ``_fused_mirror``: the dense walk's mask
  tile and its 16-byte copy-out, ``csrc/traverse_fused.cu``), bit-equal
  to the plain walks: rehearse a change to either kernel there first;
* a negative or too large forest feature id is taken as the reference's
  gather takes it (wrapped once, then clamped): both forest wrappers,
  bit-equal to ``repro.kernels.ops.forest_infer`` /
  ``forest_infer_cells`` (Pallas in interpret mode here), and the
  bank's gathered form ``cell_probs_for`` to the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import device_tree as jdt  # noqa: E402
from repro.core.classifiers import forest as jforest  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import device_tree as dt  # noqa: E402
from repro_torch.core.classifiers import forest  # noqa: E402
from repro_torch.core.rtree import RTree  # noqa: E402
from repro_torch.data.synth import strip_queries  # noqa: E402
from repro_torch.data.synth_tree import synth_levels  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py)
from helpers.torch_inputs import edge_queries, levels  # noqa: E402
from test_torch_cuda import odd_ids, router_inputs  # noqa: E402

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_ranges_follow_parents(pack, parents):
    """Each internal node's ``[first, end)`` holds exactly the nodes of
    the level below that name it, the ranges tile that level in order,
    and the packs hold the levels root first."""
    rng = pack.child_ranges.cpu().numpy()
    assert rng.dtype == np.int32 and rng.shape == (pack.offsets[-1], 2)
    for l in range(len(pack.level_sizes) - 1):
        r = rng[pack.offsets[l]:pack.offsets[l + 1]]
        below = np.asarray(parents[l + 1])
        assert r[0, 0] == 0 and r[-1, 1] == len(below)
        assert np.array_equal(r[1:, 0], r[:-1, 1])
        for n, (first, end) in enumerate(r):
            assert np.all(below[first:end] == n)
    pars = pack.int_parents.cpu().numpy()
    assert np.array_equal(pars, np.concatenate(
        [np.asarray(p, np.int32) for p in parents[:-1]]))


@pytest.mark.parametrize("seed", [0, 1])
def test_child_ranges_of_flatten_bridge_and_wrapper_agree(seed):
    """``flatten`` of the port's tree, the reference's flatten of the
    same points carried across by ``bridge``, and the wrappers' build
    from the levels give one pack; a pack of another tree is not used."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(3000, 2))
    tt = dt.flatten(RTree.str_bulk(pts, max_entries=8), device=CPU)
    jt = bridge.tree_from_reference(
        jdt.flatten(JRTree.str_bulk(pts, max_entries=8)), CPU)
    mbrs = [lv.mbrs for lv in tt.levels]
    parents = [lv.parent for lv in tt.levels]
    fly = ops.walk_pack(mbrs, parents)
    assert fly is not tt.wpack and ops.walk_pack(mbrs, parents,
                                                 tt.wpack) is tt.wpack
    for pack in (tt.wpack, jt.wpack, fly):
        assert pack.level_sizes == tuple(len(p) for p in parents)
        assert torch.equal(pack.child_ranges, tt.wpack.child_ranges)
        assert torch.equal(pack.int_mbrs, tt.wpack.int_mbrs)
        assert torch.equal(pack.int_parents, tt.wpack.int_parents)
        assert pack.offsets == tt.wpack.offsets
        _assert_ranges_follow_parents(pack, [p.numpy() for p in parents])
    other = ops.walk_pack(mbrs[:-1], parents[:-1])
    assert ops.walk_pack(mbrs, parents, other) is not other


@pytest.mark.parametrize("n1", [90, 400])
def test_child_ranges_with_empty_parents(n1):
    """``levels`` gives internal nodes with no children: their ranges
    are empty, between their neighbours'."""
    mbrs, parents = levels(np.random.default_rng(n1), L=300, n1=n1)
    pack = ops.walk_pack([_t(m) for m in mbrs], [_t(p) for p in parents])
    _assert_ranges_follow_parents(pack, parents)
    r = pack.child_ranges.numpy()[1:]                     # level 1
    empty = r[:, 0] == r[:, 1]
    assert np.array_equal(empty, ~np.isin(np.arange(n1), parents[2]))
    assert empty.any()


def test_single_level_pack():
    """A single-level tree packs no internal level."""
    pack = dt.build_walk_pack([torch.zeros((5, 4))],
                              [torch.zeros(5, dtype=torch.int32)])
    assert pack.offsets == (0,) and pack.level_sizes == (5,)
    assert tuple(pack.child_ranges.shape) == (0, 2)


@pytest.mark.parametrize("bad", ["decreasing", "negative", "past_level"])
def test_builder_refuses_parents_out_of_order(bad):
    """Parents that are not non-decreasing, or name no node of the level
    above, raise ``ValueError`` (the card's walks then serve nothing)."""
    mbrs, parents = synth_levels(200, 6, np.random.default_rng(4))
    p = parents[-1].copy()
    if bad == "decreasing":
        p[[10, 50]] = p[[50, 10]]
    elif bad == "negative":
        p[0] = -1
    else:
        p[-1] = len(parents[-2])
    parents[-1] = p
    with pytest.raises(ValueError, match="non-decreasing"):
        ops.walk_pack([_t(m) for m in mbrs], [_t(q) for q in parents])


# ---------------------------------------------------------------------------
# the card's full walks, step for step
# ---------------------------------------------------------------------------

def _hit(q, m):
    return (q[0] <= m[..., 2]) & (m[..., 0] <= q[2]) & \
        (q[1] <= m[..., 3]) & (m[..., 1] <= q[3])


def _compact_mirror(q, pack, leaf_mbrs, k, rounds=4):
    """One warp of ``traverse_compact_kernel`` for one query: the live
    list of child ranges, 32 ranges laid end to end a chunk, each lane's
    position found by the kernel's five-step search, ``rounds`` rounds of
    32 children a load batch; visits ranked in lane order. Returns the
    row's k slots and its count."""
    offs, L = pack.offsets, len(leaf_mbrs)
    n_int = len(offs) - 1
    int_mbrs = pack.int_mbrs.numpy()
    ranges = pack.child_ranges.numpy()
    cur = [(0, offs[1] if n_int else L)]
    row, count = np.zeros(k, np.int32), 0
    for lvl in range(n_int + 1):
        leaf = lvl == n_int
        mbrs = leaf_mbrs if leaf else int_mbrs[offs[lvl]:offs[lvl + 1]]
        nxt = []
        for c0 in range(0, len(cur), 32):
            r = cur[c0:c0 + 32]
            r = np.array(r + [(0, 0)] * (32 - len(r)), np.int64)
            lens = r[:, 1] - r[:, 0]
            total = int(lens.sum())
            excl = np.cumsum(lens) - lens
            for p0 in range(0, total, 32 * rounds):
                for s in range(rounds):
                    if p0 + s * 32 >= total:
                        break
                    pos = p0 + s * 32 + np.arange(32)
                    j = np.zeros(32, np.int64)
                    for step in (16, 8, 4, 2, 1):
                        j = np.where(excl[j + step] <= pos, j + step, j)
                    child = np.where(pos < total, r[j, 0] + pos - excl[j], -1)
                    h = (child >= 0) & _hit(q, mbrs[np.maximum(child, 0)])
                    for c in child[h]:
                        if leaf:
                            if count < k:
                                row[count] = c
                            count += 1
                        else:
                            nxt.append(tuple(ranges[offs[lvl] + c]))
        if not leaf:
            cur = nxt
            if not cur:
                break
    return row, count


def _fused_mirror(q, mbrs, parents, qt=16, chunk=1024, row_words=260):
    """``traverse_fused_kernel``'s CTAs: the tile's kQT-bit row masks a
    node, each row's leaf chunk packed four bytes a word into the tile,
    and the copy-out, an aligned 16-byte block at a time from five
    funnel-shifted words, the head and tail block a byte at a time, into
    a flat buffer (aligned at 0). Returns the [B, L] mask."""
    B, L = len(q), len(mbrs[-1])
    out = np.full(B * L, 7, np.uint8)            # every byte is written
    for b0 in range(0, B, qt):
        nq = min(qt, B - b0)
        qs = np.full((qt, 4), np.nan, np.float32)
        qs[:nq] = q[b0:b0 + nq]
        live = np.ones((qt, 1), bool)
        for m, p in zip(mbrs[:-1], parents[:-1]):
            par = live[:, p] if live.shape[1] > 1 else live
            live = par & np.stack([_hit(x, m) for x in qs])
        for c0 in range(0, L, chunk):
            n = min(chunk, L - c0)
            m = mbrs[-1][c0:c0 + n]
            alive = live[:, parents[-1][c0:c0 + n]] if len(mbrs) > 1 \
                else np.ones((qt, n), bool)
            tile = np.zeros((qt, row_words * 4), np.uint8)
            tile[:, :n] = alive & np.stack([_hit(x, m) for x in qs])
            words = tile.view("<u4")
            for j in range(nq):
                g = (b0 + j) * L + c0
                for kb in range(chunk // 16 + 1):
                    lo = kb * 16 - g % 16
                    if lo >= n:
                        continue
                    if lo >= 0 and lo + 16 <= n:
                        w = words[j, lo // 4:lo // 4 + 5].astype(np.uint64)
                        sh = 8 * (lo % 4)
                        v = ((w[1:] << np.uint64(32)) | w[:4]) >> \
                            np.uint64(sh)
                        out[g + lo:g + lo + 16] = \
                            (v & np.uint64(0xffffffff)).astype("<u4").view(
                                np.uint8)
                    else:
                        for x in range(max(lo, 0), min(lo + 16, n)):
                            out[g + x] = tile[j, x]
    return out.reshape(B, L).astype(bool)


def _walk_world(tree, seed):
    rng = np.random.default_rng(seed)
    if tree == "deep":
        mbrs, parents = synth_levels(1500, 6, rng)       # 5 levels
    elif tree == "childless":
        mbrs, parents = levels(rng, L=1300, n1=2000)
    else:
        mbrs, parents = levels(rng, L=1300, n1=1)[0][-1:], \
            [np.zeros(1300, np.int32)]
    q = np.concatenate([edge_queries(rng, mbrs[-1])[:21],
                        strip_queries(mbrs[-1], [0, 33, 64, len(mbrs[-1])]),
                        [[0.7, -9, 0.2, 9]]]).astype(np.float32)
    return q, mbrs, parents


@pytest.mark.parametrize("tree", ["deep", "childless", "single"])
def test_compact_mirror_equals_plain_walk(tree):
    """The compact walk's warp, rehearsed: bit-equal slots and counts at
    k 33 with 4 rounds a load batch and at k 64 with 1, on rows visiting
    0, 33, 64 and all leaves."""
    q, mbrs, parents = _walk_world(tree, 5)
    pack = dt.build_walk_pack([_t(m) for m in mbrs], [_t(p) for p in parents])
    for k, rounds in ((33, 4), (64, 1)):
        idx, _, cnt = ref.traverse_compact(_t(q), [_t(m) for m in mbrs],
                                           [_t(p) for p in parents], k)
        for b in range(len(q)):
            row, count = _compact_mirror(q[b], pack, mbrs[-1], k, rounds)
            assert count == int(cnt[b])
            np.testing.assert_array_equal(row, idx[b].numpy())
    assert int(cnt[-5]) == 0 and int(cnt[-2]) == len(mbrs[-1])


@pytest.mark.parametrize("tree", ["deep", "childless", "single"])
def test_fused_mirror_equals_plain_walk(tree):
    """The dense walk's tiles and 16-byte copy-out, rehearsed on 26 rows
    (not a multiple of 16) and 1,300 or 1,500 leaves (rows not 16-byte
    aligned, a chunk and a part): bit-equal to the plain walk."""
    q, mbrs, parents = _walk_world(tree, 6)
    want = ref.traverse_fused(_t(q), [_t(m) for m in mbrs],
                              [_t(p) for p in parents]).numpy()
    np.testing.assert_array_equal(_fused_mirror(q, mbrs, parents), want)


# ---------------------------------------------------------------------------
# the rung each tree of the smoke takes
# ---------------------------------------------------------------------------

DEPLOYMENT = [1, 3, 196, 12_730]            # 872K points, capacity 128
LARGE = [1, 57, 5_052, 449_567]             # 40M STR points
LARGE_WINDOWS = (128, 128, 512)
ROUTING = [1, 3, 190, 16_854, 1_500_000]    # synth_levels(1.5M, 89)
ROUTING_WINDOWS = (128, 128, 256, 512)


@pytest.mark.parametrize("kind", ["fused", "compact"])
def test_rungs_of_the_smoke_trees(kind):
    """Each tree keeps the rung it took before the full walks were
    redesigned: the deployment's full; the 40M index's compact walk not
    full (sliced with its windows), its dense walk full; the routing tree
    sliced with its own table and, with a degenerate one, per level for
    the dense walk; one level is mbr_intersect."""
    r = ops.walk_route
    assert r(kind, DEPLOYMENT) == "full"
    if kind == "compact":
        assert r(kind, LARGE) == "per_level"
        assert r(kind, LARGE, LARGE_WINDOWS, 512) == "sliced"
    else:
        assert r(kind, LARGE) == "full"
    assert r(kind, ROUTING) == "per_level"
    assert r(kind, ROUTING, ROUTING_WINDOWS, 512) == "sliced"
    degen = tuple(-(-n // 128) * 128 for n in ROUTING[:-1])
    assert r(kind, ROUTING, degen, 512) == \
        ("per_level" if kind == "fused" else "sliced")
    assert r(kind, [64]) == "mbr_intersect"


DEPLOYMENT_WINDOWS = (128, 128, 256)
ROUTING_DEGENERATE = (128, 128, 256, 16_896)


@pytest.mark.parametrize("kind", ["fused", "compact"])
def test_sliced_reach_keeps_every_rung(kind):
    """With the tables' windows given (the smoke's trees, as its routing
    and large-index phases print them), every tree takes the rung it took
    before the windowed dense walk's redesign: the deployment and the
    40M index's dense walk full, the routing tree sliced with its built
    table, and with the degenerate one per level for the dense walk
    (sliced for the compact walk), the 40M index's compact walk sliced.
    The dense walk's sliced reach is the first kernel's need, a byte a
    (query, node) of the widest window for 8 queries, twice; its kernel
    now asks for the mask tile and a 32-bit row mask a window node, less
    than that on the wide degenerate windows."""
    r = ops.walk_route
    assert r(kind, DEPLOYMENT, DEPLOYMENT_WINDOWS, 512) == "full"
    assert r(kind, ROUTING, ROUTING_WINDOWS, 512) == "sliced"
    assert r(kind, ROUTING, ROUTING_DEGENERATE, 512) == \
        ("per_level" if kind == "fused" else "sliced")
    assert r(kind, LARGE, LARGE_WINDOWS, 512) == \
        ("full" if kind == "fused" else "sliced")
    if kind == "compact":
        return
    reach = ops.sliced_rung_bytes
    ws = ops.walk_smem
    for widths in (DEPLOYMENT_WINDOWS, ROUTING_WINDOWS, ROUTING_DEGENERATE,
                   LARGE_WINDOWS):
        assert reach(kind, ROUTING, widths, 512) == 2 * 8 * max(widths)
        # the mask tile, 32 rows of 132 words, and a 32-bit row mask a
        # node of every level's window
        assert ws(kind, "sliced", ROUTING, widths, 512) == \
            32 * 132 * 4 + 4 * sum(widths)
    assert ws(kind, "sliced", ROUTING, ROUTING_DEGENERATE, 512) == 86_528 \
        < ops.MAX_DYNAMIC_SMEM < reach(kind, ROUTING, ROUTING_DEGENERATE,
                                       512) == 270_336
    assert ws(kind, "sliced", ROUTING, ROUTING_WINDOWS, 512) == 20_992


def test_full_rung_reach_and_smem():
    """The full rung's reach keeps the old kernels' numbers; ``walk_smem``
    reports the redesigned kernels': the dense walk's 16-row tile and
    row masks, the compact walk's child-range lists, two a warp, with
    fewer warps a CTA where four would not fit (the 40M index)."""
    fr = ops.full_rung_bytes
    assert fr("fused", DEPLOYMENT) == 3_136
    assert fr("compact", DEPLOYMENT) == 7_936
    assert fr("compact", LARGE) == 265_200 > ops.MAX_DYNAMIC_SMEM
    assert fr("fused", ROUTING) == 269_664
    assert fr("compact", ROUTING) == 884_832
    ws = ops.walk_smem
    assert ws("fused", "full", DEPLOYMENT) == 16 * 260 * 4 + 2 * 196 * 2
    assert ws("compact", "full", DEPLOYMENT) == 4 * 2 * 196 * 8
    assert ops.compact_warps(196) == 4 and ops.compact_warps(5_052) == 2
    assert ws("compact", "full", LARGE) == 2 * 2 * 5_052 * 8
    assert ws("compact", "full", LARGE) <= ops.MAX_DYNAMIC_SMEM
    assert ops.compact_warps(20_000) == 1


# ---------------------------------------------------------------------------
# the forest's feature ids: wrapped once, then clamped, as jnp indexing
# ---------------------------------------------------------------------------

def test_forest_select_wraps_then_clamps():
    """The plain gather picks feature F - 1 for -1, 0 for -F - 1 and
    F - 1 for F + 1, as ``features[:, feat_idx]`` does in JAX."""
    x = np.arange(12, dtype=np.float32).reshape(2, 6)
    fi = np.array([[-1, -7, 7], [-6, 6, -13]], np.int32)
    want = np.asarray(jnp.asarray(x)[:, jnp.asarray(fi)])
    got = ref.forest_select(_t(x), _t(fi)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [[5, 0, 5], [0, 5, 0]])


@pytest.mark.parametrize("T,D,C", [(16, 6, 1), (4, 5, 3)])
def test_forest_infer_odd_ids_match_jax(T, D, C):
    rng = np.random.default_rng(T + D + C)
    x, fi, th, tb = router_inputs(rng, 37, T, D, C)
    fi = odd_ids(fi, x.shape[1])
    want = np.asarray(jops.forest_infer(*map(jnp.asarray, (x, fi, th, tb))))
    got = ops.forest_infer(_t(x), _t(fi), _t(th), _t(tb)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T,D,Cl", [(4, 8, 37), (2, 3, 1)])
def test_forest_infer_cells_odd_ids_match_jax(T, D, Cl):
    rng = np.random.default_rng(T + D + Cl)
    B, C, F = 21, 3, 6
    x = rng.normal(size=(B, F)).astype(np.float32)
    fi = odd_ids(rng.integers(0, F, (C * T, D)).astype(np.int32), F)
    th = rng.normal(size=(C * T, D)).astype(np.float32)
    tb = rng.uniform(0, 1, (C * T, 2 ** D, Cl)).astype(np.float32)
    want = np.asarray(jops.forest_infer_cells(
        *map(jnp.asarray, (x, fi, th, tb)), n_cells=C))
    got = ops.forest_infer_cells(_t(x), _t(fi), _t(th), _t(tb),
                                 n_cells=C).numpy()
    np.testing.assert_array_equal(got, want)


def test_cell_probs_for_odd_ids_match_reference():
    """The forest bank's gathered form (the served one, one tree a cell)
    with odd feature ids: bit-equal to the reference's."""
    rng = np.random.default_rng(11)
    B, C, T, D, Cl, F, S = 13, 4, 1, 6, 5, 4, 3
    fi = odd_ids(rng.integers(0, F, (C, T, D)).astype(np.int32), F)
    arrays = dict(
        feat_idx=fi, thresh=rng.normal(size=(C, T, D)).astype(np.float32),
        tables=rng.uniform(size=(C, T, 2 ** D, Cl)).astype(np.float32),
        label_map=rng.integers(0, 50, (C, Cl)).astype(np.int32),
        lmask=np.ones((C, Cl), bool))
    x = rng.normal(size=(B, F)).astype(np.float32)
    ids = rng.integers(0, C, (B, S)).astype(np.int32)
    want = np.asarray(jforest.cell_probs_for(
        jforest.Forest(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(x), jnp.asarray(ids)))
    got = forest.cell_probs_for(
        forest.Forest(**{k: _t(v) for k, v in arrays.items()}), _t(x),
        _t(ids))
    np.testing.assert_array_equal(got.numpy(), want)
