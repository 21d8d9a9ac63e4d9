"""The kNN selection and the delta probe: the port against the JAX
package, and numpy mirrors of their CUDA kernels.

``ops.knn_browse_topk`` (browse the named leaves and keep each row's k
smallest in-radius distances) is held bit for bit against the JAX
package's own chain: ``knn_browse`` (its plain reference, and its Pallas
kernel in interpret mode), then ``lax.top_k`` of ``-d2``,
``take_along_axis`` of the ids and the ``isfinite`` sum, as
``repro.core.knn.knn_query`` runs them. The inputs are tie-heavy
(``helpers.torch_inputs.knn_tie_inputs``): lattice points make every
distance exact, so the Pallas kernel (where XLA may contract into an
FMA) agrees to the bit as well.

``_select_mirror`` is ``csrc/knn_browse.cu``'s selecting kernel step for
step (each thread's stride over (slot, 64-entry chunk) units, packed
keys, per-thread lists, a sparse warp's gather and sort or a full
warp's xor-shuffle merge, the block merge) and
``_sweep_mirror`` is ``csrc/delta_probe.cu``'s warp sweep (two ballots
a step, ranks from popcounts, direct writes below k); both are held
equal to the plain versions. Rehearse a change to either kernel here
first (``-k mirror``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from helpers.torch_inputs import (  # noqa: E402
    delta_inputs, knn_inputs, knn_tie_inputs)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_chain(d2, ids, idx, k):
    """``repro.core.knn.knn_query`` after its browse: top-k of ``-d2``,
    ids by ``take_along_axis``, the finite count, misses as +inf / -1."""
    B = d2.shape[0]
    flat = d2.reshape(B, -1)
    safe = jnp.clip(jnp.asarray(idx), 0, ids.shape[0] - 1)
    flat_ids = jnp.asarray(ids)[safe].reshape(B, -1)
    n_within = jnp.sum(jnp.isfinite(flat).astype(jnp.int32), axis=-1)
    neg, pos = jax.lax.top_k(-flat, min(k, flat.shape[-1]))
    d2k = -neg
    hit = jnp.isfinite(d2k)
    idk = jnp.take_along_axis(flat_ids, pos, axis=-1)
    return (np.asarray(jnp.where(hit, d2k, jnp.inf)),
            np.asarray(jnp.where(hit, idk, -1)), np.asarray(n_within))


def _equal(got, want):
    d2k, ids, nw = (np.asarray(g) for g in got)
    wd, wi, wn = want
    np.testing.assert_array_equal(d2k.view(np.uint32), wd.view(np.uint32))
    np.testing.assert_array_equal(ids, wi)
    np.testing.assert_array_equal(nw, wn)


def _topk(c3, ent, ids, idx, valid, k):
    return tops.knn_browse_topk(_t(c3), _t(ent), _t(ids), _t(idx),
                                _t(valid), k)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_knn_browse_topk_matches_jax_on_ties(k):
    """Lattice inputs (every distance exact, ties everywhere): bit-equal
    to both JAX chains, the reference's and its interpret-mode kernel's;
    the tie order is the lower flat position's."""
    c3, ent, ids, idx, valid = knn_tie_inputs(np.random.default_rng(k),
                                              L=40, M=16, B=24, K=8)
    got = _topk(c3, ent, ids, idx, valid, k)
    safe = np.clip(idx, 0, len(ent) - 1)
    d2_r = jref.knn_browse(jnp.asarray(c3), jnp.asarray(ent[..., 0]),
                           jnp.asarray(ent[..., 1]), jnp.asarray(safe),
                           jnp.asarray(valid))
    _equal(got, _jax_chain(d2_r, ids, idx, k))
    d2_k = jops.knn_browse(jnp.asarray(c3), jnp.asarray(ent),
                           jnp.asarray(idx), jnp.asarray(valid))
    _equal(got, _jax_chain(d2_k, ids, idx, k))
    d2k, idk, nw = (g.numpy() for g in got)
    assert nw[0] == 0 and nw[3] == 0 and (idk[[0, 3]] == -1).all()
    assert np.isinf(d2k[[0, 3]]).all()
    assert nw[7] == int(np.isfinite(ent[np.clip(idx[7], 0, 39)][valid[7]])
                        .all(-1).sum())
    # row 5 names leaves 0 and 1 (the same points) alternately: its
    # winners hold ties, which the chains above order by flat position
    if k > 1:
        assert (d2k[5, 1:] == d2k[5, :-1]).any()


@pytest.mark.parametrize("k", [1, 8, 64])
def test_knn_browse_topk_matches_jax_reference(k):
    """Random (non-lattice) inputs: bit-equal to the JAX reference's chain
    evaluated op by op (``knn_inputs``: +inf padding, invalid and clamped
    slots, an empty row, an entry at d2 == r²)."""
    c3, ent, idx, valid = knn_inputs(np.random.default_rng(7 + k), L=50,
                                     M=16, B=24, K=8, fill=12)
    ids = np.random.default_rng(1).permutation(50 * 16).astype(
        np.int32).reshape(50, 16)
    got = _topk(c3, ent, ids, idx, valid, k)
    safe = np.clip(idx, 0, len(ent) - 1)
    d2_r = jref.knn_browse(jnp.asarray(c3), jnp.asarray(ent[..., 0]),
                           jnp.asarray(ent[..., 1]), jnp.asarray(safe),
                           jnp.asarray(valid))
    _equal(got, _jax_chain(d2_r, ids, idx, k))
    if k >= int(got[2][1]):                         # row 1 whole: the
        assert np.float32(c3[1, 2]) in got[0][1].numpy()   # d2 == r2 entry


def test_knn_browse_topk_short_rows():
    """k past K·M: the plain version returns K·M columns (``knn_query``
    pads), as the JAX chain's ``top_k`` of ``min(k, K·M)``."""
    c3, ent, ids, idx, valid = knn_tie_inputs(np.random.default_rng(3),
                                              L=20, M=16, B=8, K=2)
    got = _topk(c3, ent, ids, idx, valid, 64)
    assert got[0].shape == (8, 32)
    safe = np.clip(idx, 0, len(ent) - 1)
    d2_r = jref.knn_browse(jnp.asarray(c3), jnp.asarray(ent[..., 0]),
                           jnp.asarray(ent[..., 1]), jnp.asarray(safe),
                           jnp.asarray(valid))
    _equal(got, _jax_chain(d2_r, ids, idx, 64))


def test_knn_browse_topk_refuses_outside_the_kernel():
    """The card's wrapper refuses k past ``KNN_MAX_K`` (the kernel's
    kMaxK), leaves of an odd number of entries and an empty k, before it
    allocates or launches anything."""
    src = (tops._cuda.CSRC / "knn_browse.cu").read_text()
    assert f"constexpr int kMaxK = {tops.KNN_MAX_K};" in src
    assert "knn_browse_topk_launch" in tops._cuda.KERNELS["knn_browse"].symbols
    c3, ent, ids, idx, valid = (_t(a) for a in knn_tie_inputs(
        np.random.default_rng(0), L=20, M=16, B=8, K=8))
    for bad_ent, k in ((ent, tops.KNN_MAX_K + 1), (ent, 0),
                       (ent[:, :15], 8)):
        with pytest.raises(ValueError, match="knn_browse_topk"):
            tops.prepare("knn_browse_topk", c3, bad_ent,
                         ids[:, :bad_ent.shape[1]], idx, valid, k)


# ---------------------------------------------------------------------------
# csrc/knn_browse.cu's selecting kernel, step for step
# ---------------------------------------------------------------------------

TOP_WARPS, UNROLL = 8, 4          # kTopWarps, kUnroll
EMPTY = np.uint64(2 ** 64 - 1)    # kEmpty


def _insert(lst, key):
    """``insert``: the key runs down the ascending list, the largest
    falls off."""
    for i in range(len(lst)):
        lo, key = min(key, lst[i]), max(key, lst[i])
        lst[i] = lo


def _merge_lane(lists, o):
    """``merge_lane`` on a warp's [32, KT] lists: the min of each list and
    lane ^ o's list reversed, then the bitonic merge."""
    kt = lists.shape[1]
    out = np.minimum(lists, lists[np.arange(32) ^ o][:, ::-1])
    j = kt // 2
    while j:
        for i in range(kt):
            if not i & j:
                a, c = out[:, i].copy(), out[:, i | j].copy()
                out[:, i], out[:, i | j] = np.minimum(a, c), np.maximum(a, c)
        j //= 2
    return out


def _merge_warp(lists, first=16):
    """``merge_warp``: xor steps from ``first`` down; each group of
    2·first lanes then holds its KT smallest (first 16: every lane)."""
    o = first
    while o:
        lists = _merge_lane(lists, o)
        o //= 2
    g = 2 * first
    assert all((lists[i:i + g] == lists[i]).all() for i in range(0, 32, g))
    return lists


def _sort_warp(x):
    """``sort_warp``: the bitonic network over one key a lane."""
    lane = np.arange(32)
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            y = x[lane ^ stride]
            keep_min = ((lane & stride) == 0) == ((lane & size) == 0)
            x = np.where(keep_min == (y < x), y, x)
            stride //= 2
        size *= 2
    return x


def _warp_best(lists, lens, kt):
    """A warp's KT smallest: a warp of at most 32 keys gathers them a
    lane (in lane order, each lane's ``lens`` keys) and sorts them; a
    fuller one merges its lanes' lists."""
    total = int(lens.sum())
    if total > 32:
        return _merge_warp(lists)[0]
    x = np.full(32, EMPTY, np.uint64)
    x[:total] = np.concatenate([lists[i, :lens[i]] for i in range(32)])
    x = _sort_warp(x) if total > 1 else x
    return np.concatenate([x, np.full(max(0, kt - 32), EMPTY,
                                      np.uint64)])[:kt]


def _select_mirror(c3, ent, ids, idx, valid, k):
    """``knn_browse_kernel_topk``: a CTA a row, returns ``(d2k, ids,
    n_within)``. The kernel lists a row's valid slots in the order its
    warps' shared atomics land; any order gives the same answer (a key
    carries its slot), so here they come ascending."""
    B, K = idx.shape
    L, M = ent.shape[:2]
    kt = max(8, 1 << (k - 1).bit_length())
    m2 = M // 2
    per_slot = (m2 + 31) // 32

    d2k = np.full((B, k), np.inf, np.float32)
    out_ids = np.full((B, k), -1, np.int32)
    n_within = np.zeros(B, np.int32)
    lanes = np.arange(32)
    for b in range(B):
        tab = np.where(valid[b], np.clip(idx[b], 0, L - 1), -1)
        slots = np.flatnonzero(tab >= 0)
        n_units = len(slots) * per_slot
        cx, cy, r2 = c3[b].astype(np.float32)
        lists = [[EMPTY] * kt for _ in range(TOP_WARPS * 32)]
        n_in = np.zeros(TOP_WARPS * 32, np.int64)
        for warp in range(TOP_WARPS):
            for u0 in range(warp, n_units, TOP_WARPS * UNROLL):
                loads = []
                for t in range(UNROLL):
                    u = u0 + t * TOP_WARPS
                    if u >= n_units:
                        continue
                    s = slots[u // per_slot]
                    j = (u - u // per_slot * per_slot) * 32 + lanes
                    ok = j < m2
                    loads.append((ok, s * M + 2 * j, ent[tab[s]].reshape(
                        -1)[np.minimum(4 * j, 2 * M - 4)[:, None]
                            + np.arange(4)]))
                for ok, pos, v in loads:
                    for h in (0, 1):
                        dx = v[:, 2 * h] - cx
                        dy = v[:, 2 * h + 1] - cy
                        d2 = dx * dx + dy * dy           # f32, each rounded
                        cand = ok & (d2 <= r2) & (d2 < np.inf)
                        for lane in np.flatnonzero(cand):
                            th = warp * 32 + lane
                            n_in[th] += 1
                            key = np.uint64(int(d2[lane].view(np.uint32))
                                            << 32 | int(pos[lane] + h))
                            if key < lists[th][-1]:
                                _insert(lists[th], key)
        arr = np.array(lists, np.uint64).reshape(TOP_WARPS, 32, kt)
        lens = np.minimum(n_in, kt).reshape(TOP_WARPS, 32)
        heads = np.stack([_warp_best(arr[w], lens[w], kt)
                          for w in range(TOP_WARPS)])
        last = np.full((32, kt), EMPTY, np.uint64)
        last[:TOP_WARPS] = heads
        final = last[0] if (last[:, 0] == EMPTY).all() else \
            _merge_warp(last, TOP_WARPS // 2)[0]
        n_within[b] = n_in.sum()
        for i in range(k):
            key = int(final[i])
            if key == int(EMPTY):
                continue
            pos = key & 0xFFFFFFFF
            s = pos // M
            d2k[b, i] = np.uint32(key >> 32).view(np.float32)
            out_ids[b, i] = ids[tab[s], pos - s * M]
    return d2k, out_ids, n_within


@pytest.mark.parametrize("inputs,k", [
    ("ties", 8), ("ties", 1), ("ties_wide_leaf", 16), ("random", 8),
    ("ties_k64", 64), ("short", 32)])
def test_select_mirror_equals_plain(inputs, k):
    """The kernel's steps give the plain version's answer: lattice ties,
    one winner, leaves of 66 entries (two units a slot, the second
    partly idle), random distances, k 64 (lists of 64), and k = K·M."""
    rng = np.random.default_rng(len(inputs) + k)
    if inputs == "random":
        c3, ent, idx, valid = knn_inputs(rng, L=50, M=16, B=24, K=8,
                                         fill=12)
        ids = rng.permutation(50 * 16).astype(np.int32).reshape(50, 16)
    else:
        shape = {"ties": (40, 16, 16, 8, 12), "ties_wide_leaf":
                 (30, 66, 10, 5, 60), "ties_k64": (30, 128, 8, 12, 100),
                 "short": (20, 16, 8, 2, 16)}[inputs]
        L, M, B, K, fill = shape
        c3, ent, ids, idx, valid = knn_tie_inputs(rng, L=L, M=M, B=B, K=K,
                                                  fill=fill)
    want = tuple(w.numpy() for w in tref.knn_browse_topk(
        _t(c3), _t(ent[..., 0]), _t(ent[..., 1]), _t(ids),
        _t(np.clip(idx, 0, len(ent) - 1)), _t(valid), k))
    assert want[0].shape[1] == k
    _equal(_select_mirror(c3, ent, ids, idx, valid, k), want)


# ---------------------------------------------------------------------------
# csrc/delta_probe.cu's warp sweep, step for step
# ---------------------------------------------------------------------------

def _sweep_mirror(q, pts, k, groups=4):
    """``delta_probe_kernel`` for all rows at once: the buffer padded with
    +inf to a step of ``groups`` 64-point groups, a lane's two points a
    group, two ballots, a step without a hit skipped, ranks from the
    popcounts below the lane, writes below k, then zeros past the count.
    Returns ``(idx [B, k], count [B])``."""
    B, cap = len(q), len(pts)
    n4 = -(-cap // (64 * groups)) * 32 * groups
    buf = np.full((2 * n4, 2), np.inf, np.float32)
    buf[:cap] = pts
    idx = np.full((B, k), -7, np.int64)            # every slot is written
    n = np.zeros(B, np.int64)
    rows = np.arange(B)[:, None]

    def hits(p):                                              # [B, 32]
        return (p[None, :, 0] >= q[:, None, 0]) & \
            (p[None, :, 0] <= q[:, None, 2]) & \
            (p[None, :, 1] >= q[:, None, 1]) & (p[None, :, 1] <= q[:, None, 3])
    for j0 in range(0, n4, 32 * groups):
        h = [[hits(buf[2 * j]), hits(buf[2 * j + 1])] for j in
             j0 + 32 * np.arange(groups)[:, None] + np.arange(32)]
        step = np.any([g[0] | g[1] for g in h], axis=(0, 2))   # any hit
        for g in range(groups):
            j = j0 + 32 * g + np.arange(32)
            h0, h1 = (x & step[:, None] for x in h[g])
            below = np.cumsum(h0, 1) - h0 + np.cumsum(h1, 1) - h1
            r = n[:, None] + below
            live = (n < k)[:, None]
            for hh, rr, p in ((h0, r, 2 * j), (h1, r + h0, 2 * j + 1)):
                w = live & hh & (rr < k)
                idx[np.broadcast_to(rows, w.shape)[w], rr[w]] = \
                    np.broadcast_to(p, w.shape)[w]
            n += h0.sum(1) + h1.sum(1)
    for s in range(k):
        idx[n <= s, s] = 0
    assert (idx != -7).all()
    return idx.astype(np.int32), n.astype(np.int32)


@pytest.mark.parametrize("B,cap,fill,k", [
    (64, 8192, 6144, 64), (64, 8192, 8192, 512), (64, 8192, 1170, 512),
    (64, 8192, 0, 64), (37, 777, 600, 8), (5, 1, 1, 4)])
def test_sweep_mirror_equals_plain(B, cap, fill, k):
    """The sweep's ranks give the plain version's slot table and counts on
    the smoke's edge rows (k, k + 1 and k - 1 hits, the empty row) at the
    serving cap, at a cap that is not a multiple of 64 and on a one-point
    store (its last row is that point's own degenerate rect)."""
    q, pts = delta_inputs(np.random.default_rng(fill + k), B, cap, fill, k)
    if cap == 1:
        q[-1] = np.r_[pts[0], pts[0]]
    idx, cnt = _sweep_mirror(q, pts, k)
    pidx, pvalid, pcnt = tref.delta_probe(_t(q), _t(pts), k)
    np.testing.assert_array_equal(idx, pidx.numpy())
    np.testing.assert_array_equal(cnt, pcnt.numpy())
    np.testing.assert_array_equal(np.arange(k)[None, :] < cnt[:, None],
                                  pvalid.numpy())
    assert cnt[0] == 0
    if fill > k:
        assert cnt[1:4].tolist() == [k, k + 1, k - 1]
    if cap == 1:
        assert cnt[-1] == 1
