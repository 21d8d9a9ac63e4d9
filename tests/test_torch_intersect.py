"""``mbr_intersect`` (plain and folded) and ``forest_infer_cells``, as the
card runs them, against the JAX package on the CPU.

* ``_intersect_mirror``: ``csrc/mbr_intersect.cu`` step for step in
  numpy — the (query tile, MBR tile) CTAs, a warp's ballot a query over
  32 MBRs into the shared bit tile for the queries that meet the 32's
  bounding box (a parent byte loaded only on a hit; the queries split
  over the warps that share a word when the tile is narrow), and the
  copy-out:
  16 bits at each 16-byte aligned address by a funnel shift, spread to
  bytes by one multiply a nibble, the up to 15 bytes before and after
  the aligned body a byte at a time. Held bit-equal to
  ``repro.kernels.ops.mbr_intersect`` (Pallas in interpret mode) at
  widths around the 16-byte block, rows of every alignment, rectangles
  touching at their edges, and with an output buffer that starts off 16
  bytes; in the folded form to the plain ``parent_mask[:, parents] &
  hit`` with non-decreasing and shuffled parents.
* ``_cells_mirror``: ``csrc/forest_infer_cells.cu`` step for step — the
  cell-major grid, the codes, a warp a whole output row: its 16-byte
  aligned float4s, the floats before and after them one at a time,
  tree-order sums. Held bit-equal to
  ``repro.kernels.ops.forest_infer_cells`` at T 1 and 4, 37 and 670
  labels, an empty cell (``thresh = +inf``), repeated queries and the
  feature ids the reference's gather wraps or clamps.
* The folded step: ``ref.mbr_intersect(q, m, parent_mask, parents)``
  chained over a tree equals the reference's
  ``visited_leaf_mask_per_level``, with parents in order and shuffled.

Rehearse a change to either kernel here first (``-k mirror``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import device_tree as jdt  # noqa: E402
from repro.core import traversal as jtraversal  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py)
from helpers.torch_inputs import (  # noqa: E402
    forest_cells_inputs, levels, rects)
from test_torch_cuda import odd_ids  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# mbr_intersect
# ---------------------------------------------------------------------------

QT, TN, WARPS, DENSE = 32, 512, 8, 8  # kQT, kTN, kWarps, kDense


NEVER = (np.inf, np.inf, -np.inf, -np.inf)


def _meets(a, b):
    """Closed-rectangle intersection of ``a`` and ``b`` (broadcast)."""
    return (a[..., 0] <= b[..., 2]) & (b[..., 0] <= a[..., 2]) & \
        (a[..., 1] <= b[..., 3]) & (b[..., 1] <= a[..., 3])


def _spread4(n):
    """Four bits to four 0/1 bytes, bit j to byte j, by one multiply."""
    return (np.uint32(n) * np.uint32(0x00204081)) & np.uint32(0x01010101)


def _intersect_mirror(q, m, parent_mask=None, parents=None, align=0):
    """``mbr_intersect_kernel``'s CTAs over a flat buffer whose byte
    ``align`` is the output's first (the 16-byte blocks are aligned to
    the buffer's start). Every byte the kernel owns must be written
    once; the rest stay 7. Returns the [B, N] mask."""
    B, N = len(q), len(m)
    buf = np.full(align + B * N, 7, np.uint8)
    lanes = np.arange(32)
    n_qt = -(-B // QT)
    for blk in range(n_qt * -(-N // TN)):
        b0, c0 = blk % n_qt * QT, blk // n_qt * TN
        nq, n = min(QT, B - b0), min(TN, N - c0)
        bits = np.zeros((QT, TN // 32 + 1), np.uint64)
        qs = np.full((QT, 4), NEVER, np.float32)
        qs[:nq] = q[b0:b0 + nq]
        nw = -(-n // 32)
        parts = max(1, WARPS // nw)            # warps sharing a word
        owned = np.zeros((QT, nw), int)
        for warp, w in ((warp, w) for warp in range(WARPS)
                        for w in range(warp // parts, nw, WARPS // parts)):
            own = lanes % parts == warp % parts
            owned[own, w] += 1
            live = w * 32 + lanes < n
            i = np.minimum(c0 + w * 32 + lanes, N - 1)
            mm = np.where(live[:, None], m[i], NEVER).astype(np.float32)
            if parents is not None:
                p = np.where(live, np.clip(parents[i], 0,
                                           parent_mask.shape[1] - 1), 0)
            box = np.array([np.nanmin(mm[:, 0]), np.nanmin(mm[:, 1]),
                            np.nanmax(mm[:, 2]), np.nanmax(mm[:, 3])])
            cand = _meets(qs, box) & own
            # past DENSE candidates the warp votes on all 32 queries
            for j in range(QT) if cand.sum() > DENSE else \
                    np.flatnonzero(cand):
                hit = _meets(qs[j], mm)
                if not own[j]:
                    continue                   # another warp's query
                if parents is not None and hit.any():
                    hit[hit] = parent_mask[b0 + j, p[hit]]
                bits[j, w] = int((hit.astype(np.uint64) << lanes.astype(
                    np.uint64)).sum())         # the ballot
        assert (owned == 1).all(), "each (query, word) has one warp"
        for j in range(nq):                    # copy-out, a warp a row
            s = align + (b0 + j) * N + c0
            head = min((16 - s % 16) % 16, n)
            nb = (n - head) // 16
            tail = head + 16 * nb
            row = bits[j]
            for k in range(nb):
                x = head + 16 * k
                v = ((int(row[(x >> 5) + 1]) << 32 | int(row[x >> 5]))
                     >> (x & 31)) & 0xFFFF
                word = np.array([_spread4((v >> (4 * z)) & 15)
                                 for z in range(4)], "<u4")
                assert (buf[s + x:s + x + 16] == 7).all()
                buf[s + x:s + x + 16] = word.view(np.uint8)
            for lane in range(32):
                t = lane if lane < 16 else tail + lane - 16
                if (t < head) if lane < 16 else (t < n):
                    assert buf[s + t] == 7
                    buf[s + t] = (int(row[t >> 5]) >> (t & 31)) & 1
    out = buf[align:]
    assert set(np.unique(out)) <= {0, 1}, "a byte was never written"
    assert (buf[:align] == 7).all()
    return out.reshape(B, N).astype(bool)


def _touching(rng, B, m):
    """Random rects plus rows touching MBR 0 at its right edge, at its top
    right corner, and one that is a point on MBR 1's lower left corner."""
    q = rects(rng, B, -0.1, 1.0, 0.2)
    if B >= 4:
        q[1] = [m[0, 2], m[0, 1], m[0, 2] + 0.05, m[0, 3]]
        q[2] = [m[0, 2], m[0, 3], m[0, 2] + 0.1, m[0, 3] + 0.1]
        q[3] = [m[-1, 0], m[-1, 1], m[-1, 0], m[-1, 1]]
    return q


@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 1000, 1537, 12731])
def test_intersect_mirror_equals_jax(N, B):
    """The kernel's tiles, ballots and aligned copy-out, rehearsed:
    bit-equal to the reference kernel (interpret mode) at widths around
    the 16-byte block and the 512-MBR tile, odd widths whose rows start
    at every alignment, and rectangles that only touch."""
    rng = np.random.default_rng(N + B)
    m = rects(rng, N, size=0.05)
    q = _touching(rng, B, m)
    want = np.asarray(jops.mbr_intersect(jnp.asarray(q), jnp.asarray(m)))
    np.testing.assert_array_equal(_intersect_mirror(q, m), want)
    np.testing.assert_array_equal(ref.mbr_intersect(_t(q), _t(m)).numpy(),
                                  want)
    if B > 1:
        assert want[1, 0] and want[2, 0] and want[3, -1]


@pytest.mark.parametrize("align", [1, 8, 15])
def test_intersect_mirror_off_a_16_byte_start(align):
    """The head and tail split takes the output's own address: a buffer
    that starts off 16 bytes gives the same mask."""
    rng = np.random.default_rng(align)
    m = rects(rng, 700, size=0.05)
    q = _touching(rng, 40, m)
    np.testing.assert_array_equal(
        _intersect_mirror(q, m, align=align),
        ref.mbr_intersect(_t(q), _t(m)).numpy())


@pytest.mark.parametrize("order", ["non_decreasing", "shuffled"])
@pytest.mark.parametrize("N", [17, 1537])
def test_intersect_mirror_folded_equals_plain(order, N):
    """The folded form, rehearsed: ``parent_mask[:, parents] & hit`` for
    parents in order and shuffled, a parent mask with dead and live rows,
    and the wrappers' plain path the same."""
    rng = np.random.default_rng(N)
    n_prev = 23
    m = rects(rng, N, size=0.05)
    q = _touching(rng, 35, m)
    parents = np.sort(rng.integers(0, n_prev, N)).astype(np.int32)
    if order == "shuffled":
        parents = rng.permutation(parents)
    pm = rng.uniform(size=(35, n_prev)) < 0.6
    pm[0] = False
    pm[1] = True
    want = pm[:, parents] & np.asarray(
        jops.mbr_intersect(jnp.asarray(q), jnp.asarray(m)))
    got = ref.mbr_intersect(_t(q), _t(m), _t(pm), _t(parents)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.mbr_intersect(_t(q), _t(m), _t(pm), _t(parents)).numpy(), want)
    np.testing.assert_array_equal(_intersect_mirror(q, m, pm, parents), want)
    assert not want[0].any()


def test_intersect_needs_both_parent_arguments():
    q, m = _t(rects(np.random.default_rng(0), 3)), \
        _t(rects(np.random.default_rng(1), 5))
    for fn in (ops.mbr_intersect, ref.mbr_intersect):
        with pytest.raises(ValueError):
            fn(q, m, parent_mask=torch.ones(3, 2, dtype=torch.bool))
        with pytest.raises(ValueError):
            fn(q, m, parents=torch.zeros(5, dtype=torch.int32))


@pytest.mark.parametrize("order", ["non_decreasing", "shuffled"])
def test_folded_walk_equals_reference_per_level(order):
    """``ref.mbr_intersect`` folded level by level (what the card's
    per-level rung launches, one kernel a level) equals the reference's
    ``visited_leaf_mask_per_level`` on a three-level tree, with each
    level's parents in order or shuffled (the per-level rung takes any
    parents)."""
    rng = np.random.default_rng(4)
    mbrs, parents = levels(rng, L=900, n1=40)
    if order == "shuffled":
        parents = [p if i < 2 else rng.permutation(p)
                   for i, p in enumerate(parents)]
    q = _touching(rng, 50, mbrs[-1])
    q[4] = [-3, -3, 3, 3]        # meets the childless nodes' [2, 2, -2, -2]
    jtree = jdt.DeviceTree(
        levels=tuple(jdt.Level(mbrs=jnp.asarray(mb), parent=jnp.asarray(pa))
                     for mb, pa in zip(mbrs, parents)),
        leaf_entries=jnp.zeros((900, 1, 2), jnp.float32),
        leaf_entry_ids=jnp.zeros((900, 1), jnp.int32),
        leaf_counts=jnp.zeros((900,), jnp.int32), n_points=0,
        max_entries=1)
    want = np.asarray(jtraversal.visited_leaf_mask_per_level(
        jtree, jnp.asarray(q)))
    mask = ref.mbr_intersect(_t(q), _t(mbrs[0]))
    mirror = _intersect_mirror(q, mbrs[0])
    for mb, pa in zip(mbrs[1:], parents[1:]):
        mask = ref.mbr_intersect(_t(q), _t(mb), mask, _t(pa))
        mirror = _intersect_mirror(q, mb, mirror, pa)
    np.testing.assert_array_equal(mask.numpy(), want)
    np.testing.assert_array_equal(mirror, want)
    np.testing.assert_array_equal(
        ref.traverse_fused(_t(q), [_t(m) for m in mbrs],
                           [_t(p) for p in parents]).numpy(), want)
    assert want.any() and not want.all()


# ---------------------------------------------------------------------------
# forest_infer_cells
# ---------------------------------------------------------------------------

CELL_QT, CELL_WARPS = 32, 4            # kQT, kWarps in the kernel


def _cells_mirror(x, fi, th, tb, C, align=0):
    """``forest_infer_cells_kernel``'s CTAs (cell-major) over a flat
    output whose float ``align`` is the first (16-byte blocks aligned to
    the buffer's start): codes wrapped then clamped, a warp a whole row,
    the row's aligned float4s by the lanes, the floats before and after
    them one at a time, the T trees summed in ascending t in float32.
    Every float is written once. Returns [B, C, Cl]."""
    B, F = x.shape
    CT, D = fi.shape
    T, Cl = CT // C, tb.shape[-1]
    buf = np.full(align + B * C * Cl, np.nan, np.float32)
    n_tiles = -(-B // CELL_QT)
    for blk in range(n_tiles * C):
        c, b0 = blk // n_tiles, blk % n_tiles * CELL_QT
        nq = min(CELL_QT, B - b0)
        codes = np.zeros((nq, T), np.int64)
        for qi in range(nq):
            for t in range(T):
                r, code = c * T + t, 0
                for d in range(D):
                    f = int(fi[r, d])
                    f = f + F if f < 0 else f
                    f = 0 if f < 0 else min(f, F - 1)
                    code = (code << 1) | int(x[b0 + qi, f] > th[r, d])
                codes[qi, t] = code
        for qi in range(nq):                  # warp qi % 4, in turn
            o = align + ((b0 + qi) * C + c) * Cl
            head = min((4 - o % 4) % 4, Cl)
            nb = (Cl - head) // 4
            rows = [tb[c * T + t, codes[qi, t]] for t in range(T)]
            for k0 in range(0, nb, 32):       # a step of the lanes' loop
                xs = head + 4 * np.arange(k0, min(k0 + 32, nb))
                cols = xs[:, None] + np.arange(4)
                acc = rows[0][cols]
                for t in range(1, T):
                    acc = acc + rows[t][cols]
                assert np.isnan(buf[o + cols]).all()
                buf[o + cols] = acc
            tail = head + 4 * nb
            for lane in range(8):
                e = lane if lane < 4 else tail + lane - 4
                if (e < head) if lane < 4 else (e < Cl):
                    acc = rows[0][e]
                    for t in range(1, T):
                        acc = np.float32(acc + rows[t][e])
                    assert np.isnan(buf[o + e])
                    buf[o + e] = acc
    assert not np.isnan(buf[align:]).any(), "a float was never written"
    return buf[align:].reshape(B, C, Cl)


@pytest.mark.parametrize("Cl", [37, 670])
@pytest.mark.parametrize("T", [1, 4])
def test_cells_mirror_equals_jax(T, Cl):
    """The kernel's cell-major tiles and whole-row float4 writes,
    rehearsed, with the output starting on 16 bytes and 4 bytes past:
    bit-equal to the reference kernel (interpret mode) with 77 queries
    (off the 32-query tile), cell 1 empty (``thresh = +inf``), queries
    10-13 repeated, a feature exactly on its threshold and the ids -1,
    -F - 1, F + 1, -F, F, -2; the port's wrapper the same."""
    rng = np.random.default_rng(T * 1000 + Cl)
    B, C, D = 77, 5, 8
    x, fi, th, tb = forest_cells_inputs(rng, B, C, T, D, Cl)
    x[11:14] = x[10]
    fi = odd_ids(fi, x.shape[1])
    want = np.asarray(jops.forest_infer_cells(
        *map(jnp.asarray, (x, fi, th, tb)), n_cells=C))
    np.testing.assert_array_equal(_cells_mirror(x, fi, th, tb, C), want)
    np.testing.assert_array_equal(_cells_mirror(x, fi, th, tb, C, align=1),
                                  want)
    np.testing.assert_array_equal(
        ops.forest_infer_cells(_t(x), _t(fi), _t(th), _t(tb),
                               n_cells=C).numpy(), want)
    assert (want[:, 1] == want[0, 1]).all()
