"""The port's walk ladder past one CTA's shared memory against the JAX
reference: the ancestor table, the plain versions of the ancestor-sliced
walks and of ``mbr_intersect``, the rung ``walk_route`` picks, and the
kNN / join / compact range slice through the sliced rung.

Inputs are made with numpy from a seed. The reference runs as its own
tests run it (``tests/test_traverse_sliced.py``): its Pallas kernels in
interpret mode, its jnp references, and its ladder forced onto the sliced
rung by lowering ``traverse_fused.VMEM_BUDGET`` (restored after each
test). On the CPU the port's walks take no rung: they run the one plain
walk, which is held here against the reference's sliced rung, and the
port's sliced plain versions against the reference's oracle and kernels
(``tests/test_torch_cuda.py`` holds the port's rungs on the card). Every
output here is an integer or a bool, so every
comparison is bit for bit (kNN distances: see
``tests/test_torch_query_types.py``, whose 1-ulp rule for ``neighbor_d2``
and near-radius rows this file reuses).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import device_tree as jdt, joins as jjoins  # noqa: E402
from repro.core import knn as jknn, traversal as jtrav  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.core.traversal import compact_mask_counted as jcompact  # noqa
from repro.data import synth as jsynth  # noqa: E402
from repro.data.synth_tree import synth_levels as jsynth_levels  # noqa
from repro.kernels import mbr_intersect as jmbr  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels import traverse_fused as jtf  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import device_tree as dt, joins, knn  # noqa: E402
from repro_torch.core import traversal  # noqa: E402
from repro_torch.core.rtree import RTree  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.data.synth_tree import synth_levels  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py)
from helpers.torch_inputs import near_radius_rows  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def budget_guard():
    """Restore the reference's VMEM budget after a test that forces its
    ladder onto the sliced rung."""
    orig = jtf.VMEM_BUDGET
    yield
    jtf.VMEM_BUDGET = orig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _queries(B, rng):
    """Small random rects over [-1, 1]², with row 1 missing every node and
    row 3 hitting every node."""
    lo = rng.uniform(-1, 1, (B, 2))
    w = rng.uniform(0, 0.08, (B, 2))
    q = np.concatenate([lo, lo + w], 1).astype(np.float32)
    q[1] = [50.0, 50.0, 51.0, 51.0]
    q[3] = [-2.0, -2.0, 2.0, 2.0]
    return q


def _tables(parents, tl):
    """The reference's and the port's table of one hierarchy."""
    return (jdt.build_ancestor_table(parents, tl=tl),
            dt.build_ancestor_table(parents, tl=tl, device=CPU))


def _assert_tables_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got.widths == tuple(want.widths) and got.tl == want.tl
    assert got.starts.dtype == torch.int32
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(want.starts))


def _degenerate(parents, tl):
    """A table whose every window is the whole lane-padded level, as real
    trees give where one tile's ancestors straddle every aligned window."""
    widths = tuple(-(-max(len(p), 1) // dt.LANE) * dt.LANE
                   for p in parents[:-1])
    n_tiles = -(-len(parents[-1]) // tl)
    starts = np.zeros((len(widths), n_tiles), np.int32)
    return (jdt.AncestorTable(starts=jnp.asarray(starts), widths=widths,
                              tl=tl),
            dt.AncestorTable(starts=_t(starts), widths=widths, tl=tl))


# ---------------------------------------------------------------------------
# the datasets and the ancestor table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gen,n,seed", [("tweets_like", 50_000, 0),
                                        ("crimes_like", 30_000, 1),
                                        ("tweets_like", 7, 3)])
def test_synth_datasets_match_reference(gen, n, seed):
    """The port's generators (no row shuffle before the sorting dedup, a
    lexsort dedup) give the reference's points exactly, duplicates
    dropped."""
    got = getattr(synth, gen)(n, seed=seed)
    want = getattr(jsynth, gen)(n, seed=seed)
    np.testing.assert_array_equal(got, want)
    dup = np.concatenate([got, got[::3], got[:1]])
    np.testing.assert_array_equal(synth._dedup(dup),
                                  np.unique(dup, axis=0))


@pytest.mark.parametrize("L,fanout,tl,str_pack", [
    (700, 4, 128, True), (1000, 3, 512, True), (4097, 8, 128, True),
    (2048, 8, 512, False), (33, 4, 128, True), (5000, 89, 512, True)])
def test_ancestor_table_matches_reference(L, fanout, tl, str_pack):
    """Same parents → same starts, widths and tile, with L off the tile's
    multiples, several fanouts, both tiles, packed and unpacked leaves."""
    mbrs, parents = synth_levels(L, fanout, np.random.default_rng(L),
                                 str_pack=str_pack)
    jm, jp = jsynth_levels(L, fanout, np.random.default_rng(L),
                           str_pack=str_pack)
    for a, b in zip(mbrs + parents, jm + jp):
        np.testing.assert_array_equal(a, b)
    want, got = _tables(parents, tl)
    _assert_tables_equal(got, want)
    assert got.n_tiles == -(-L // tl)
    assert dt.build_ancestor_table([_t(p) for p in parents],
                                   tl=tl).starts.device.type == "cpu"


@pytest.mark.parametrize("gen,n,sel,dtype", [
    ("tweets_like", 30_000, 1e-3, np.float64),
    ("crimes_like", 20_000, 5e-4, np.float64),
    ("tweets_like", 2000, 0.01, np.float32)])
def test_synth_queries_match_reference(gen, n, sel, dtype):
    """The join's and the range workload's rects: the port's run search
    gives the reference's rects exactly, on the host and through torch
    (the path ``launch.serve`` takes on its device), for float64 and
    float32 points."""
    pts = getattr(synth, gen)(n).astype(dtype)
    want = jsynth.synth_queries(pts, sel, 200)
    np.testing.assert_array_equal(synth.synth_queries(pts, sel, 200), want)
    np.testing.assert_array_equal(
        synth.synth_queries(pts, sel, 200, device=CPU), want)


def test_ancestor_table_single_level_is_none():
    assert dt.build_ancestor_table([np.zeros(5, np.int32)]) is None
    assert jdt.build_ancestor_table([np.zeros(5, np.int32)]) is None


@pytest.mark.parametrize("tl", [None, 128])
def test_flatten_attaches_equal_tables(tl):
    """``flatten`` of one Guttman tree attaches the same table in both
    packages (the default tile and 128), and the bridge carries it
    across; a single-level tree carries None."""
    pts = synth.crimes_like(3000, seed=3)
    jt = jdt.flatten(JRTree(max_entries=16).insert_all(pts), slice_tl=tl)
    tt = dt.flatten(RTree(max_entries=16).insert_all(pts), device=CPU,
                    slice_tl=tl)
    assert tt.aslices.tl == (tl or dt.SLICE_TL) == jt.aslices.tl
    _assert_tables_equal(tt.aslices, jt.aslices)
    _assert_tables_equal(bridge.tree_from_reference(jt, CPU).aslices,
                         jt.aslices)
    one = dt.flatten(RTree(max_entries=16).insert_all(pts[:9]), device=CPU)
    assert one.height == 1 and one.aslices is None


# ---------------------------------------------------------------------------
# plain versions against the reference's kernels and oracles
# ---------------------------------------------------------------------------

def _sliced_cases():
    """(levels, parents, reference table, port table, label) for a built
    table, a degenerate one and a shifted (wrong) one."""
    out = []
    for L, fanout, tl in ((1000, 4, 128), (2500, 8, 512)):
        mbrs, parents = synth_levels(L, fanout, np.random.default_rng(7 + L),
                                     str_pack=True)
        jt, pt = _tables(parents, tl)
        out.append((mbrs, parents, jt, pt, f"built-{L}"))
        out.append((mbrs, parents, *_degenerate(parents, tl),
                    f"degenerate-{L}"))
    # one window shifted off its tile's ancestors: the walk is wrong, but
    # both packages must be wrong the same way (out-of-window parents
    # dead, windows past the level's end read misses)
    mbrs, parents, jt, pt, _ = out[0]
    st = np.asarray(jt.starts).copy()
    w = jt.widths[-1]
    room = -(-len(parents[-2]) // w) - 1       # last block of the level
    st[-1, 1::2] = np.minimum(st[-1, 1::2] + 1, room)
    assert (st != np.asarray(jt.starts)).any()
    out.append((mbrs, parents,
                jdt.AncestorTable(starts=jnp.asarray(st), widths=jt.widths,
                                  tl=jt.tl),
                dt.AncestorTable(starts=_t(st), widths=pt.widths, tl=pt.tl),
                "shifted"))
    return out


@pytest.mark.parametrize("case", range(5),
                         ids=["built-1000", "degenerate-1000", "built-2500",
                              "degenerate-2500", "shifted"])
def test_sliced_plain_matches_reference(case):
    """The port's plain ``traverse_fused_sliced`` equals the reference's
    windowed oracle and its ``traverse_fused_sliced_t`` in interpret mode;
    ``traverse_compact_sliced`` equals ``traverse_compact_sliced_t`` and
    ``compact_mask_counted`` of the oracle, at k below and past the
    miss-all / hit-all rows' counts."""
    mbrs, parents, jt, pt, label = _sliced_cases()[case]
    rng = np.random.default_rng(case)
    B = 24
    q = _queries(B, rng)
    L = len(parents[-1])
    lm, lp = [jnp.asarray(m) for m in mbrs], [jnp.asarray(p) for p in parents]
    want = np.asarray(jref.traverse_fused_sliced(
        jnp.asarray(q), lm, lp, jt.starts, jt.widths, jt.tl))[:, :L]
    got = ref.traverse_fused_sliced(_t(q), [_t(m) for m in mbrs],
                                    [_t(p) for p in parents], pt.starts,
                                    pt.widths, pt.tl).numpy()
    np.testing.assert_array_equal(got, want)
    full = np.asarray(jref.traverse_fused(jnp.asarray(q), lm, lp))
    if label != "shifted":
        np.testing.assert_array_equal(got, full)
        assert not got[1].any() and got[3].all()
    else:
        assert (got != full).any() and not (got & ~full).any()

    qp, imt, ipar, lmt, lpt = jops._sliced_operands(jnp.asarray(q), lm, lp,
                                                    jt, 8)
    for tpu_form in (False, True):    # gather walk, one-hot MXU walk
        kern = np.asarray(jtf.traverse_fused_sliced_t(
            jt.starts, qp.T, imt, ipar, lmt, lpt, widths=jt.widths, tb=8,
            tl=jt.tl, interpret=True, tpu_form=tpu_form))[:B, :L]
        np.testing.assert_array_equal(got, kern)
    for k in (16, L + 3):
        idx, valid, cnt = ref.traverse_compact_sliced(
            _t(q), [_t(m) for m in mbrs], [_t(p) for p in parents],
            pt.starts, pt.widths, pt.tl, k)
        kidx, kcnt = jtf.traverse_compact_sliced_t(
            jt.starts, qp.T, imt, ipar, lmt, lpt, k=k, widths=jt.widths,
            tb=8, tl=jt.tl, interpret=True, tpu_form=False)
        ridx, rval, rcnt = jcompact(jnp.asarray(want), k)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(kcnt)[:B, 0])
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(rval))
        np.testing.assert_array_equal(
            idx.numpy(), np.where(np.asarray(rval), np.asarray(kidx)[:B, :k],
                                  0))
        np.testing.assert_array_equal(idx.numpy(),
                                      np.asarray(jnp.where(rval, ridx, 0)))


# ---------------------------------------------------------------------------
# the card's windowed dense walk, step for step
# ---------------------------------------------------------------------------

def _hit(q, m):
    """[Q, 4] × [N, 4] → [Q, N] closed-rectangle hits (NaN rows miss)."""
    q, m = q[:, None], m[None, :]
    return (q[..., 0] <= m[..., 2]) & (m[..., 0] <= q[..., 2]) & \
        (q[..., 1] <= m[..., 3]) & (m[..., 1] <= q[..., 3])


def _fused_sliced_mirror(q, mbrs, parents, starts, widths, tl, per=1,
                         qt=32, chunk=512, row_words=132, dense=8):
    """``traverse_fused_sliced_kernel``'s CTAs (``csrc/traverse_fused_sliced
    .cu``): one per (``qt``-query tile, segment of ``per`` consecutive leaf
    tiles). A ``qt``-bit row mask a node of every level's window; for
    each tile the walk restarts at the first level whose window moved
    (or not at all), a node tested only under a live rebased parent
    (every row past ``dense`` live rows, else the live rows), and a level
    with no live bit ends the walk and keeps the tiles after it dead
    until a window at or above it moves. Then rounds of ``chunk`` leaves,
    2 a thread, into a byte tile of ``row_words`` words a row, and the
    copy-out: a row's aligned 16-byte blocks from five funnel-shifted
    words, its head and tail a byte at a time, into a flat buffer aligned
    at 0. Returns the [B, L] mask and, per tile served, the levels
    walked and whether it was dead."""
    B, L = len(q), len(mbrs[-1])
    n_int = len(mbrs) - 1
    st = np.asarray(starts)
    n_tiles = -(-L // tl)
    out = np.full(B * L, 7, np.uint8)            # every byte is written
    rows = np.arange(qt, dtype=np.uint32)
    trace = []
    for b0 in range(0, B, qt):
        nq = min(qt, B - b0)
        qs = np.full((qt, 4), np.nan, np.float32)
        qs[:nq] = q[b0:b0 + nq]
        for t0 in range(0, n_tiles, per):
            masks = [None] * n_int
            win = [-1] * n_int
            valid, dead = 0, False
            for tile in range(t0, min(t0 + per, n_tiles)):
                c0, c1 = tile * tl, min(tile * tl + tl, L)
                new = [int(st[l, tile]) * widths[l] for l in range(n_int)]
                moved = [l for l in range(n_int) if new[l] != win[l]]
                first = moved[0] if moved else n_int
                win = new
                if first < valid:
                    valid, dead = first, False
                walked = []
                while not dead and valid < n_int:
                    l = valid
                    n = len(mbrs[l])
                    g = win[l] + np.arange(widths[l])
                    inn = (g >= 0) & (g < n)
                    gm = np.clip(g, 0, n - 1)
                    if l == 0:
                        p = np.where(inn, 0, -1)
                    else:
                        rel = parents[l][gm].astype(np.int64) - win[l - 1]
                        p = np.where(inn & (rel >= 0) & (rel < widths[l - 1]),
                                     rel, -1)
                    live = np.where(p < 0, np.uint32(0),
                                    np.uint32(0xffffffff) if l == 0 else
                                    masks[l - 1][np.maximum(p, 0)])
                    bit = ((live.astype(np.uint32)[None, :] >> rows[:, None])
                           & 1).astype(bool)
                    mk = bit & _hit(qs, mbrs[l][gm])
                    masks[l] = (mk.astype(np.uint32) << rows[:, None]).sum(
                        0, dtype=np.uint64).astype(np.uint32)
                    walked.append(l)
                    valid = l + 1
                    dead = not masks[l].any()
                trace.append((walked, dead))
                pw, ps = widths[-1], win[-1]
                for r0 in range(c0, c1, chunk):
                    i = r0 + np.arange(chunk)
                    p = np.where(i < c1, parents[-1][np.minimum(i, L - 1)],
                                 -1)
                    rel = p.astype(np.int64) - ps
                    ok = (rel >= 0) & (rel < pw)
                    live = np.zeros(chunk, np.uint32) if dead else \
                        np.where(ok, masks[-1][np.clip(rel, 0, pw - 1)], 0)
                    bit = ((live.astype(np.uint32)[None, :] >> rows[:, None])
                           & 1).astype(bool)
                    tb = np.zeros((qt, row_words * 4), np.uint8)
                    tb[:, :chunk] = bit & _hit(
                        qs, mbrs[-1][np.minimum(i, L - 1)])
                    words = tb.view("<u4").astype(np.uint64)
                    n = min(chunk, c1 - r0)
                    for j in range(nq):
                        s = (b0 + j) * L + r0
                        head = min((16 - s % 16) % 16, n)
                        nb = (n - head) // 16
                        tail = head + 16 * nb
                        for k in range(nb):
                            x = head + 16 * k
                            w = words[j, x // 4:x // 4 + 5]
                            v = ((w[1:] << np.uint64(32)) | w[:4]) >> \
                                np.uint64(8 * (x % 4))
                            out[s + x:s + x + 16] = (v & np.uint64(
                                0xffffffff)).astype("<u4").view(np.uint8)
                        for x in list(range(head)) + list(range(tail, n)):
                            out[s + x] = tb[j, x]
    assert out.max() <= 1
    return out.reshape(B, L).astype(bool), trace


def _mirror_world(L, tl, table):
    """A STR hierarchy of ``L`` leaves (fanout 6) and its table at tile
    ``tl``: ``built``, ``degenerate`` or ``shifted`` (every other tile's
    leaf-level window one block on, the last tile's past the level's
    end)."""
    mbrs, parents = synth_levels(L, 6, np.random.default_rng(L),
                                 str_pack=True)
    _, sl = _tables(parents, tl)
    if table == "degenerate":
        sl = _degenerate(parents, tl)[1]
    elif table == "shifted":
        st = sl.starts.clone()
        st[1:, 1::2] += 1
        st[-1, -1] = -(-len(parents[-2]) // sl.widths[-1])
        sl = dt.AncestorTable(starts=st, widths=sl.widths, tl=tl)
    return mbrs, parents, sl


@pytest.mark.parametrize("per", [1, 3, 100])
@pytest.mark.parametrize("L,tl", [(1537, 512), (2000, 1024), (1001, 64)])
@pytest.mark.parametrize("table", ["built", "degenerate", "shifted"])
def test_fused_sliced_mirror_equals_plain(table, L, tl, per):
    """The windowed dense walk's CTAs, rehearsed, bit-equal to the plain
    windowed walk (and to the full walk on a built or degenerate table),
    with a CTA serving 1, 3 or all of the tiles: batches of 1, 15, 17 and
    70 rows (partial query tiles), odd L (no row but row 0 starts
    16-aligned) and a last tile shorter than tl, rounds of 512 leaves in
    a tile of 1,024, a batch that misses the root (walks that end at the
    first level, and tiles after it that stay dead) and small rects in a
    corner (walks that end in lower windows), the shifted table's windows
    past the level's end; tiles whose windows did not move are not
    walked again."""
    mbrs, parents, sl = _mirror_world(L, tl, table)
    lm, lp = [_t(m) for m in mbrs], [_t(p) for p in parents]
    rng = np.random.default_rng(L + tl)
    base = _queries(70, rng)
    far = np.tile(np.float32([[5, 5, 6, 6]]), (20, 1))
    corner = np.float32([[-1, -1, -0.95, -0.95]]) + \
        rng.uniform(0, 0.02, (20, 4)).astype(np.float32)
    n_tiles = -(-L // tl)
    for q in (base, base[:1], base[3:18], base[-17:], far, corner):
        want = ref.traverse_fused_sliced(_t(q), lm, lp, sl.starts, sl.widths,
                                         sl.tl).numpy()
        got, trace = _fused_sliced_mirror(q, mbrs, parents, sl.starts,
                                          sl.widths, sl.tl, per)
        np.testing.assert_array_equal(got, want)
        if q is far:        # every walk ends at the root's window
            assert not got.any() and all(d for _, d in trace)
            assert all(w == [0] for w, _ in trace[::per])
        if q is corner and table == "built" and tl <= 512:
            # and, in a tile far from the corner, in lower windows
            assert got.any() and any(d and w and w[-1] > 0
                                     for w, d in trace)
    got, trace = _fused_sliced_mirror(base, mbrs, parents, sl.starts,
                                      sl.widths, sl.tl, per)
    full = ref.traverse_fused(_t(base), lm, lp).numpy()
    if table != "shifted":
        np.testing.assert_array_equal(got, full)
        assert got[3].all()
    else:       # the shifted windows only drop leaves
        assert (got != full).any() and not (got & ~full).any()
    walks = sum(len(w) for w, _ in trace)
    if per > 1 and table == "degenerate":   # no window ever moves
        assert walks == len(mbrs[:-1]) * -(-len(base) // 32) * \
            -(-n_tiles // per)


# ---------------------------------------------------------------------------
# the card kernel's split, rehearsed: count, scan, write
# ---------------------------------------------------------------------------

def _three_passes(mask, k, S, tl):
    """``csrc/traverse_compact_sliced.cu``'s three passes in plain
    PyTorch, over the windowed visited mask [B, L]: each (row, segment)'s
    visit count (segments of ``ceil(n_tiles / S)`` tiles, the last ones
    possibly empty), each row's exclusive scan over its segments (first
    ranks, the total, zeros past it), then each segment's visits written
    from its first rank, those below ``k``."""
    B, L = mask.shape
    per = -(-(-(-L // tl)) // S)
    bounds = [min(s * per * tl, L) for s in range(S + 1)]
    counts = torch.stack([mask[:, bounds[s]:bounds[s + 1]].sum(
        1, dtype=torch.int32) for s in range(S)], 1)              # count
    first = torch.cumsum(counts, 1, dtype=torch.int32) - counts    # scan
    cnt = counts.sum(1, dtype=torch.int32)
    idx = torch.zeros((B, k), dtype=torch.int32)
    for b in range(B):                                             # write
        for s in range(S):
            c, f = int(counts[b, s]), int(first[b, s])
            if c == 0 or f >= k:
                continue
            ids = torch.nonzero(mask[b, bounds[s]:bounds[s + 1]])[:, 0]
            n = min(c, k - f)
            idx[b, f:f + n] = (ids[:n] + bounds[s]).to(torch.int32)
    return idx, cnt


_LINE_L, _LINE_TL = 1000, 128


def _line_levels(L=_LINE_L, fanout=4):
    """A hierarchy whose leaf i is the box [i, 0, i + 0.5, 1] and whose
    parents group ``fanout`` consecutive children: the rect [a, 0.2,
    b + 0.25, 0.8] visits exactly leaves a..b."""
    sizes = [L]
    while sizes[0] > 1:
        sizes.insert(0, -(-sizes[0] // fanout))
    x = np.arange(L, dtype=np.float32)
    mbrs = [None] * len(sizes)
    mbrs[-1] = np.stack([x, 0 * x, x + 0.5, 0 * x + 1], 1)
    parents = [np.zeros(n, np.int32) for n in sizes]
    for lvl in range(len(sizes) - 1, 0, -1):
        par = np.minimum(np.arange(sizes[lvl]) // fanout,
                         sizes[lvl - 1] - 1).astype(np.int32)
        parents[lvl] = par
        at = np.flatnonzero(np.r_[True, par[1:] != par[:-1]])
        ch = mbrs[lvl]
        mbrs[lvl - 1] = np.stack(
            [np.minimum.reduceat(ch[:, 0], at),
             np.minimum.reduceat(ch[:, 1], at),
             np.maximum.reduceat(ch[:, 2], at),
             np.maximum.reduceat(ch[:, 3], at)], 1).astype(np.float32)
    return mbrs, parents


def _line_table(parents, table):
    """The reference's and the port's table of the line hierarchy:
    ``built``, ``degenerate`` or ``shifted`` (every other tile's last
    window one block on, clipped to the level)."""
    if table == "degenerate":
        return _degenerate(parents, _LINE_TL)
    jt, pt = _tables(parents, _LINE_TL)
    if table == "built":
        return jt, pt
    st = np.asarray(jt.starts).copy()
    room = -(-len(parents[-2]) // jt.widths[-1]) - 1
    st[-1, 1::2] = np.minimum(st[-1, 1::2] + 1, room)
    assert (st != np.asarray(jt.starts)).any()
    return (jdt.AncestorTable(starts=jnp.asarray(st), widths=jt.widths,
                              tl=jt.tl),
            dt.AncestorTable(starts=_t(st), widths=pt.widths, tl=pt.tl))


def _line_rows(k, S):
    """Rows visiting 0, k, k + 1 and all leaves (k and k + 1 capped at
    L), one whose k-th visit is the first leaf of a segment when the
    split has one past leaf k - 1, and random intervals."""
    L = _LINE_L
    per = -(-(-(-L // _LINE_TL)) // S)

    def span(a, b):
        return [a, 0.2, b + 0.25, 0.8]
    rows = [[-10, 0.2, -5, 0.8], span(0, min(k, L) - 1),
            span(0, min(k + 1, L) - 1), [-1, 0, L + 1, 1]]
    seg0 = [s * per * _LINE_TL for s in range(1, S)
            if k - 1 <= s * per * _LINE_TL < L]
    if seg0:
        rows.append(span(seg0[0] - k + 1, min(seg0[0] + 3, L - 1)))
    rng = np.random.default_rng(k + S)
    for _ in range(8):
        a, n = int(rng.integers(0, L)), int(rng.integers(0, 3 * k))
        rows.append(span(a, min(a + n, L - 1)))
    return np.asarray(rows, np.float32), bool(seg0)


@functools.lru_cache(maxsize=None)
def _line_reference(table, k, S):
    """The reference's interpret-mode ``traverse_compact_sliced_t`` on the
    line hierarchy and ``_line_rows(k, S)``: (idx, cnt) as numpy."""
    mbrs, parents = _line_levels()
    jt, _ = _line_table(parents, table)
    q, _ = _line_rows(k, S)
    qp, imt, ipar, lmt, lpt = jops._sliced_operands(
        jnp.asarray(q), [jnp.asarray(m) for m in mbrs],
        [jnp.asarray(p) for p in parents], jt, 8)
    kidx, kcnt = jtf.traverse_compact_sliced_t(
        jt.starts, qp.T, imt, ipar, lmt, lpt, k=k, widths=jt.widths, tb=8,
        tl=jt.tl, interpret=True, tpu_form=False)
    B = q.shape[0]
    return np.asarray(kidx)[:B, :k], np.asarray(kcnt)[:B, 0]


@pytest.mark.parametrize("S", ["1", "2", "3", "n_tiles", "n_tiles+5"])
@pytest.mark.parametrize("k", ["16", "64", "512", "L+3"])
@pytest.mark.parametrize("table", ["built", "degenerate", "shifted"])
def test_three_passes_match_reference(table, k, S):
    """The kernel's split (count, scan, write) in plain PyTorch is
    bit-equal to ``ref.traverse_compact_sliced`` and to the reference's
    ``traverse_compact_sliced_t`` in interpret mode, for S from one
    segment to more segments than tiles, on rows visiting 0, k, k + 1 and
    all leaves and one whose k-th visit opens a segment."""
    mbrs, parents = _line_levels()
    L = _LINE_L
    n_tiles = -(-L // _LINE_TL)
    k = L + 3 if k == "L+3" else int(k)
    S = {"n_tiles": n_tiles, "n_tiles+5": n_tiles + 5}.get(S) or int(S)
    _, pt = _line_table(parents, table)
    q, boundary = _line_rows(k, S)
    tq, lm, lp = _t(q), [_t(m) for m in mbrs], [_t(p) for p in parents]
    mask = ref.traverse_fused_sliced(tq, lm, lp, pt.starts, pt.widths,
                                     pt.tl)
    idx, cnt = _three_passes(mask, k, S, _LINE_TL)
    widx, _, wcnt = ref.traverse_compact_sliced(tq, lm, lp, pt.starts,
                                                pt.widths, pt.tl, k)
    assert torch.equal(idx, widx) and torch.equal(cnt, wcnt)
    kidx, kcnt = _line_reference(table, k, S)
    np.testing.assert_array_equal(cnt.numpy(), kcnt)
    valid = np.arange(k)[None, :] < kcnt[:, None]
    np.testing.assert_array_equal(idx.numpy(), np.where(valid, kidx, 0))
    if table != "shifted":
        assert cnt[:4].tolist() == [0, min(k, L), min(k + 1, L), L]
        if boundary:       # its k-th visit is its segment's first leaf
            per = -(-n_tiles // S)
            assert int(idx[4, k - 1]) % (per * _LINE_TL) == 0
    assert boundary == (S > 1 and k < L and
                        (S < n_tiles or k - 1 <= (n_tiles - 1) * _LINE_TL))


@pytest.mark.parametrize("B", [512, 513, 100, 16, 1])
def test_compact_sliced_segments(B):
    """The segment count is a pure function of the shapes: 1 <= S <=
    n_tiles, no CTA walks more than ceil(n_tiles / S) tiles, and the
    grid of each pass fills the card (COMPACT_SLICED_CTAS_PER_SM CTAs an
    SM) on the 40M-point index, whose narrow (k 64) and wide (k 512)
    batches both have 512 rows."""
    tile = ops.COMPACT_SLICED_QUERY_TILE
    want = ops.SM_COUNT * ops.COMPACT_SLICED_CTAS_PER_SM
    for n_tiles in (-(-449_567 // 512), -(-1_500_000 // 512), 8, 1):
        S = ops.compact_sliced_segments(B, n_tiles)
        assert 1 <= S <= n_tiles
        groups = -(-B // tile)
        # the target, but for the tiles' granularity: over half of it
        assert 2 * groups * S > min(want, groups * n_tiles)
        assert groups * (S - 1) < want or S == 1
        per = -(-n_tiles // S)
        assert (S - 1) * per < n_tiles       # no segment is empty
    if B == 512:
        assert ops.compact_sliced_segments(B, 879) == 33
        assert -(-B // tile) == 64 and -(-879 // 33) == 27


@pytest.mark.parametrize("B,N", [(40, 700), (3, 513), (300, 1)])
def test_mbr_intersect_matches_reference(B, N):
    """Plain ``mbr_intersect`` (and ``ops.mbr_intersect`` on CPU tensors)
    equals ``mbr_intersect_t`` in interpret mode, with rects touching
    only at an edge and degenerate (point) rects."""
    rng = np.random.default_rng(B + N)
    m = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    mbrs = np.concatenate([m, m + rng.uniform(0, 0.1, (N, 2))
                           .astype(np.float32)], 1)
    q = _queries(B, rng) * 0.5 + 0.5 if B >= 4 else \
        rng.uniform(0, 1, (B, 4)).astype(np.float32)
    q = q.astype(np.float32)
    q[0] = [mbrs[0, 2], mbrs[0, 1], mbrs[0, 2] + 0.01, mbrs[0, 3]]  # edge
    if B > 2:
        q[2] = [mbrs[-1, 0], mbrs[-1, 1], mbrs[-1, 0], mbrs[-1, 1]]  # corner
    tb, tn = 8, 128
    qp = np.full((-(-B // tb) * tb, 4), np.inf, np.float32)
    qp[:B] = q
    mp = np.tile(np.array([np.inf, np.inf, -np.inf, -np.inf], np.float32),
                 (-(-N // tn) * tn, 1))
    mp[:N] = mbrs
    want = np.asarray(jmbr.mbr_intersect_t(
        jnp.asarray(qp.T), jnp.asarray(mp.T), tb=tb, tn=tn,
        interpret=True))[:B, :N]
    np.testing.assert_array_equal(ref.mbr_intersect(_t(q), _t(mbrs)).numpy(),
                                  want)
    np.testing.assert_array_equal(ops.mbr_intersect(_t(q), _t(mbrs)).numpy(),
                                  want)
    assert want[0, 0] and (B <= 2 or want[2, N - 1])


# ---------------------------------------------------------------------------
# the rung each walk takes
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _synth_1500k():
    """``chip_smoke.py``'s routing tree: 1.5M STR-packed leaves, fanout
    89, and its table."""
    _, parents = synth_levels(1_500_000, 89, np.random.default_rng(0),
                              str_pack=True)
    return parents, dt.build_ancestor_table(parents, device=CPU)


def test_walk_route_at_the_port_shapes():
    """``walk_route`` at the shapes the port serves: the 872K-point
    deployment (12,730 leaves; its full walks fit for any internal level
    below ~14,000 nodes), 40M STR points (449,439 leaves: the compact
    walk passes the full rung's reach, the dense one fits), the 1.5M-leaf
    synthetic tree with its own and with a degenerate table, and one
    level."""
    r = ops.walk_route
    dep = [1, 3, 190, 12_730]
    assert r("fused", dep) == r("compact", dep) == "full"
    big = [1, 57, 5_050, 449_439]
    assert ops.full_rung_bytes("compact", big) == 265_120
    assert r("fused", big) == "full"
    assert r("compact", big) == "per_level"            # no table given
    assert r("compact", big, (128, 128, 5_120), 512) == "sliced"
    parents, sl = _synth_1500k()
    sizes = [len(p) for p in parents]
    assert sizes == [1, 3, 190, 16_854, 1_500_000]
    assert ops.full_rung_bytes("fused", sizes) == 269_664
    assert ops.full_rung_bytes("compact", sizes) == 884_832
    for kind in ("fused", "compact"):
        assert r(kind, sizes) == "per_level"
        assert r(kind, sizes, sl.widths, sl.tl) == "sliced"
    degen = tuple(-(-n // 128) * 128 for n in sizes[:-1])
    assert degen[-1] == 16_896
    assert ops.sliced_rung_bytes("fused", sizes, degen, 512) == 270_336
    assert ops.walk_smem("fused", "sliced", sizes, degen, 512) == \
        32 * 132 * 4 + 4 * sum(degen)
    assert r("fused", sizes, degen, 512) == "per_level"
    assert ops.walk_smem("compact", "sliced", sizes, degen, 512) == 17_920
    assert r("compact", sizes, degen, 512) == "sliced"
    for kind in ("fused", "compact"):
        assert r(kind, [64]) == "mbr_intersect"
    with pytest.raises(ValueError):
        r("dense", dep)


def test_wrappers_follow_the_route(monkeypatch):
    """Whatever rung ``walk_route`` picks for the card, CPU tensors run
    the one plain walk (never the sliced plain versions) and give the
    same mask and slot table, with the tree's table or none; a table of
    another tree is rejected. (The sliced dense kernel's tile and row
    masks pass the full walk's shared memory below ~1,000 nodes a level,
    so the tree is wide enough for a limit to pick the sliced rung.)"""
    mbrs, parents = synth_levels(6000, 6, np.random.default_rng(2),
                                 str_pack=True)
    q, lm, lp = _t(_queries(32, np.random.default_rng(3))), \
        [_t(m) for m in mbrs], [_t(p) for p in parents]
    sl = dt.build_ancestor_table(parents, tl=256)
    want = ref.traverse_fused(q, lm, lp)
    wc = ref.traverse_compact(q, lm, lp, 40)
    sizes = [len(p) for p in parents]

    def never(*a, **kw):
        raise AssertionError("CPU walk took a sliced plain version")
    monkeypatch.setattr(ref, "traverse_fused_sliced", never)
    monkeypatch.setattr(ref, "traverse_compact_sliced", never)
    sliced = max(ops.walk_smem("fused", "sliced", sizes, sl.widths, sl.tl),
                 ops.sliced_rung_bytes("fused", sizes, sl.widths, sl.tl))
    for limit, route in ((ops.MAX_DYNAMIC_SMEM, "full"), (sliced, "sliced"),
                         (1, "per_level")):
        monkeypatch.setattr(ops, "MAX_DYNAMIC_SMEM", limit)
        assert ops.walk_route("fused", sizes, sl.widths, sl.tl) == route
        for slices in (sl, None):
            assert torch.equal(ops.traverse_fused(q, lm, lp, slices=slices),
                               want)
            for a, b in zip(ops.traverse_compact(q, lm, lp, 40,
                                                 slices=slices), wc):
                assert torch.equal(a, b)
    other = dt.build_ancestor_table(parents[:-1], tl=256)
    assert not ops._slices_usable(other, len(sizes), sizes[-1],
                                  torch.device(CPU))
    assert ops._slices_usable(sl, len(sizes), sizes[-1], torch.device(CPU))


# ---------------------------------------------------------------------------
# the slice as a whole, through the sliced rung in both packages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _world():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(40_000, 2))
    # 8,000 leaves under a widest internal level of 1,600 nodes: the full
    # compact walk's bitmaps and frontier outgrow the sliced walk's tile
    jtree = jdt.flatten(JRTree.str_bulk(pts, max_entries=8), slice_tl=128)
    return pts, jtree, bridge.tree_from_reference(jtree, CPU)


def _force_sliced(monkeypatch, ttree, jtree, Bs, ks):
    """Lower the reference's ``VMEM_BUDGET`` between its sliced and full
    estimates at every batch size and k used, so that each full compact
    walk is out and each sliced walk in. The port's sliced walk needs
    less shared memory than its full one here too (on the card a limit
    between them routes it sliced); on the CPU it runs the plain walk."""
    sizes = [lv.mbrs.shape[0] for lv in ttree.levels]
    sl = ttree.aslices
    assert ops.walk_smem("compact", "sliced", sizes, sl.widths, sl.tl) < \
        ops.walk_smem("compact", "full", sizes)
    full, sliced = [], []
    for B in Bs:
        for k in ks:
            tb, tl, interp, _ = jops._fused_tiles(B, sizes[-1], None, None,
                                                  len(sizes))
            padded = [n + (-n) % jtf.LANE for n in sizes[:-1]]
            full.append(jtf.vmem_estimate_compact(padded, tb, tl, k,
                                                  tpu_form=not interp))
            sliced.append(jtf.vmem_estimate_sliced_compact(
                jtree.aslices.widths, tb, jtree.aslices.tl, k,
                tpu_form=not interp))
    assert max(sliced) < min(full)
    jtf.VMEM_BUDGET = (max(sliced) + min(full)) // 2
    # the reference's steps are jitted: a spy counts traces, not batches
    calls = {"sliced": 0, "full": 0, "per_level": 0}
    for mod, name, key in ((jtf, "traverse_compact_sliced_t", "sliced"),
                           (jtf, "traverse_compact_t", "full"),
                           (jops, "_per_level_kernel_mask", "per_level")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    return calls


def _fields_equal(got, want, fields=None, skip=()):
    for f in fields or want._fields:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        keep = np.setdiff1d(np.arange(w.shape[0]), np.asarray(skip, int))
        np.testing.assert_array_equal(g[keep], w[keep], err_msg=f)


def test_range_query_compact_through_sliced_rung(monkeypatch, budget_guard):
    """Every ``CompactQueryResult`` field bit-equal, with bounds that
    truncate some rows."""
    pts, jtree, ttree = _world()
    rng = np.random.default_rng(10)
    lo = pts[rng.integers(0, len(pts), 48)].astype(np.float32)
    w = rng.uniform(0, 0.15, (48, 2)).astype(np.float32)
    q = np.concatenate([lo - w, lo + w], 1)
    q[1] = [50, 50, 51, 51]
    calls = _force_sliced(monkeypatch, ttree, jtree, [48], [8])
    want = jtrav.range_query_compact(jtree, jnp.asarray(q), max_visited=8,
                                     max_results=32, use_kernel=True)
    got = traversal.range_query_compact(ttree, _t(q), max_visited=8,
                                        max_results=32)
    assert calls == {"sliced": 1, "full": 0, "per_level": 0}
    _fields_equal(got, want)
    assert _np(got.truncated).any() and not _np(got.truncated).all()
    assert _np(got.n_visited)[1] == 0


def test_knn_query_through_sliced_rung(monkeypatch, budget_guard):
    """ids and counts bit-equal, distances within 1 ulp (rows with a
    candidate within 1 ulp of r² reported, not compared)."""
    pts, jtree, ttree = _world()
    rng = np.random.default_rng(11)
    c = pts[rng.integers(0, len(pts), 40)].astype(np.float32)
    q = np.concatenate([c, c], 1)
    r = knn.default_radius(ttree, 8)
    assert r == jknn.default_radius(jtree, 8)
    calls = _force_sliced(monkeypatch, ttree, jtree, [40], [16])
    want = jknn.knn_query(jtree, jnp.asarray(q), k=8, radius=r,
                          max_visited=16, use_kernel=True)
    got = knn.knn_query(ttree, _t(q), k=8, radius=r, max_visited=16)
    assert calls == {"sliced": 1, "full": 0, "per_level": 0}
    skip = near_radius_rows(pts, q, [r])
    _fields_equal(got, want, ("neighbor_ids", "n_within", "n_visited",
                              "leaf_accesses", "truncated"), skip)
    keep = np.setdiff1d(np.arange(40), skip)
    gd, wd = _np(got.neighbor_d2)[keep], _np(want.neighbor_d2)[keep]
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    np.testing.assert_array_max_ulp(gd[np.isfinite(wd)],
                                    wd[np.isfinite(wd)], maxulp=1)


def test_spatial_join_through_sliced_rung(monkeypatch, budget_guard):
    """Pairs, merged stats and counters equal the reference's and
    ``join_brute``, with rows that re-serve on the wide tier."""
    pts, jtree, ttree = _world()
    rng = np.random.default_rng(5)
    lo = pts[rng.integers(0, len(pts), 40)].astype(np.float32)
    w = rng.uniform(0, 0.03, (40, 2)).astype(np.float32)
    outer = np.concatenate([lo - w, lo + w], 1)
    kw = dict(batch=20, max_pairs=4, max_visited=16, wide_factor=8,
              sort="hilbert")
    calls = _force_sliced(monkeypatch, ttree, jtree, [20], [16, 128])
    want = jjoins.spatial_join(jtree, outer, use_kernel=True, **kw)
    got = joins.spatial_join(ttree, outer, device=CPU, **kw)
    assert calls == {"sliced": 2, "full": 0, "per_level": 0}  # two tiers
    assert got.n_reserved > 0 and got.residual_truncated == 0
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.pairs, joins.join_brute(pts, outer))
    for f in ("n_outer", "n_pairs", "n_batches", "n_reserved",
              "residual_truncated", "sort"):
        assert getattr(got, f) == getattr(want, f), f
    _fields_equal(got.stats, want.stats)
