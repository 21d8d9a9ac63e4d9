"""The port's curve keys, compacting traversal, kNN and spatial join
against the JAX reference.

The world is the reference's kNN/join test world (2500 normal points,
``RTree.str_bulk`` with capacity 16), flattened by the reference and
carried across with ``bridge.tree_from_reference``; both packages then
answer the same inputs on the CPU. The reference runs as its own tests
run it: its kernel wrappers in interpret mode and its jnp references.
Integer and bool fields must be bit-equal. kNN distances agree within
1 ulp: the reference evaluates ``dx*dx + dy*dy`` under jit, where XLA:CPU
may contract it into an FMA, while the port rounds the three ops
separately (as its CUDA kernel does); rows with a candidate within 1 ulp
of the probe radius² are reported instead of compared on their ids and
counts. The port's kNN is held bit for bit against its own brute-force
oracle, and its join against the reference and ``join_brute``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import device_tree as jdt, joins as jjoins  # noqa: E402
from repro.core import knn as jknn, schedule as jschedule  # noqa: E402
from repro.core import traversal as jtrav  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import joins, knn, schedule, traversal  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py)
from helpers.torch_inputs import near_radius_rows  # noqa: E402

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _world(n=2500, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 2))
    jtree = jdt.flatten(JRTree.str_bulk(pts, max_entries=16))
    return pts, jtree, bridge.tree_from_reference(jtree, CPU)


def _single_level(seed=3):
    pts = np.random.default_rng(seed).normal(size=(9, 2))
    jtree = jdt.flatten(JRTree.str_bulk(pts, max_entries=16))
    assert len(jtree.levels) == 1
    return pts, jtree, bridge.tree_from_reference(jtree, CPU)


def _rects(pts, rng, n, w=0.08):
    lo = pts[rng.integers(0, pts.shape[0], n)].astype(np.float32)
    wd = rng.uniform(0, w, (n, 2)).astype(np.float32)
    return np.concatenate([lo - wd, lo + wd], axis=1)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_fields_equal(got, want, skip_rows=(), fields=None):
    assert got._fields == want._fields
    n = _np(want[0]).shape[0]
    keep = np.setdiff1d(np.arange(n), np.asarray(skip_rows, int))
    for f in fields or want._fields:
        np.testing.assert_array_equal(_np(getattr(got, f))[keep],
                                      _np(getattr(want, f))[keep],
                                      err_msg=f)


# ---------------------------------------------------------------------------
# curve keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_spatial_keys_match_reference(curve):
    """Keys bit-equal on random rects, with the workload's bbox, a caller
    bbox the rects spill out of, a zero-extent caller bbox, a single
    query and coincident centres (the cases of test_schedule.py)."""
    pts, _, _ = _world()
    rng = np.random.default_rng(7)
    q = _rects(pts, rng, 300)
    q1 = q[:1]
    qc = np.repeat(q1, 7, axis=0)
    cases = [(q, None), (q, np.array([-1, -1, 1, 1], np.float32)),
             (q, np.array([0.5, 0.5, 0.5, 0.5], np.float32)),
             (q, np.array([-2, 0.25, 2, 0.25], np.float32)),
             (q1, None), (qc, None),
             (qc, np.array([0.5, 0.5, 0.5, 0.5], np.float32))]
    for qq, bbox in cases:
        want = jschedule.spatial_keys(qq, curve, bbox=bbox)
        got = schedule.spatial_keys(qq, curve, bbox=bbox, device=CPU)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        sched = schedule.make_schedule(qq, 16, curve, bbox, device=CPU)
        np.testing.assert_array_equal(
            sched.order, jschedule.make_schedule(qq, 16, curve, bbox).order)
    assert np.unique(schedule.spatial_keys(qc, curve, device=CPU)).size == 1


def test_point_query_mask_matches_reference():
    q = _rects(_world()[0], np.random.default_rng(8), 50)
    q[::3, 2:] = q[::3, :2]
    q[1, 2] = q[1, 0]                       # zero width, positive height
    np.testing.assert_array_equal(schedule.point_query_mask(q),
                                  jschedule.point_query_mask(q))


# ---------------------------------------------------------------------------
# compacting traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("single", [False, True], ids=["tree", "root_leaf"])
def test_visited_leaves_compact_matches_reference(use_kernel, single):
    """``CompactVisit`` bit-equal against the reference's kernel and
    dense forms, with k small enough to overflow and k at least L, on the
    world and on a single-level tree (root == leaves)."""
    pts, jtree, ttree = _single_level() if single else _world()
    q = _rects(pts, np.random.default_rng(9), 40, w=0.3)
    q[0] = [50, 50, 51, 51]                              # visits nothing
    L = ttree.n_leaves
    for k in sorted({1, 3, L, L + 5} if single else {4, 64}):
        want = jtrav.visited_leaves_compact(jtree, jnp.asarray(q), k,
                                            use_kernel=use_kernel)
        got = traversal.visited_leaves_compact(ttree, torch.from_numpy(q), k)
        _assert_fields_equal(got, want)
        assert not _np(got.valid)[0].any()
        if not single:
            assert _np(got.overflow).any() == (k == 4)


@pytest.mark.parametrize("mv,mr", [(64, 512), (4, 8)])
def test_range_query_compact_matches_reference(mv, mr):
    """Every ``CompactQueryResult`` field bit-equal, with bounds that
    truncate some rows in the second case."""
    pts, jtree, ttree = _world()
    q = _rects(pts, np.random.default_rng(10), 64, w=0.2)
    want = jtrav.range_query_compact(jtree, jnp.asarray(q), max_visited=mv,
                                     max_results=mr)
    got = traversal.range_query_compact(ttree, torch.from_numpy(q),
                                        max_visited=mv, max_results=mr)
    _assert_fields_equal(got, want)
    assert _np(got.truncated).any() == (mv == 4)
    dense = traversal.range_query(ttree, torch.from_numpy(q),
                                  max_visited=mv, max_results=mr)
    for f in ("n_visited", "n_true", "n_results", "result_ids", "truncated"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(dense, f)), err_msg=f)


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------

def _knn_queries(pts, n, seed):
    rng = np.random.default_rng(seed)
    c = pts[rng.integers(0, pts.shape[0], n)].astype(np.float32)
    c = c + rng.normal(scale=1e-3, size=c.shape).astype(np.float32)
    return np.concatenate([c, c], axis=1).astype(np.float32)


def _assert_knn_close(got, want, skip):
    _assert_fields_equal(got, want, skip_rows=skip,
                         fields=("neighbor_ids", "n_within", "n_visited",
                                 "leaf_accesses", "truncated"))
    gd, wd = _np(got.neighbor_d2), _np(want.neighbor_d2)
    keep = np.setdiff1d(np.arange(gd.shape[0]), skip)
    gd, wd = gd[keep], wd[keep]
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    fin = np.isfinite(wd)
    np.testing.assert_array_max_ulp(gd[fin], wd[fin], maxulp=1)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_knn_query_matches_reference(use_kernel):
    """The narrow kNN step on the reference's serving forms: ids and
    counts bit-equal, distances within 1 ulp, some rows truncated."""
    pts, jtree, ttree = _world()
    q = _knn_queries(pts, 96, 11)
    r = knn.default_radius(ttree, 8)
    assert r == jknn.default_radius(jtree, 8)
    skip = near_radius_rows(pts, q, [r])
    want = jknn.knn_query(jtree, jnp.asarray(q), k=8, radius=r,
                          max_visited=8, use_kernel=use_kernel)
    got = knn.knn_query(ttree, torch.from_numpy(q), k=8, radius=r,
                        max_visited=8)
    _assert_knn_close(got, want, skip)
    assert _np(got.truncated).any() and not _np(got.truncated).all()


def test_knn_two_tier_serving_matches_reference():
    """The radius-doubling wide tier through ``serve_workload`` on the
    Hilbert curve: counters equal, stats as in the narrow test."""
    pts, jtree, ttree = _world()
    q = _knn_queries(pts, 150, 12)
    r = knn.default_radius(ttree, 8, margin=1.0)
    jn, jw = jknn.make_knn_steps(jtree, k=8, radius=r, max_visited=8)
    tn, tw = knn.make_knn_steps(ttree, k=8, radius=r, max_visited=8)
    want = jschedule.serve_workload(jn, q, batch=64, sort="hilbert",
                                    wide_fn=jw, trunc_field="truncated")
    got = schedule.serve_workload(tn, q, batch=64, sort="hilbert",
                                  wide_fn=tw, trunc_field="truncated",
                                  device=CPU)
    assert got.n_reserved > 0
    for f in ("n_queries", "n_batches", "n_reserved", "wide_batches",
              "sort"):
        assert getattr(got, f) == getattr(want, f), f
    _assert_knn_close(got.stats, want.stats,
                      near_radius_rows(pts, q, [r, 2 * r]))


def test_knn_query_matches_own_brute_force():
    """Bit-exact against the port's brute-force oracle: every distance
    of an exact row, the in-radius prefix of a row truncated for having
    fewer than k candidates in radius (no row overflows its slots)."""
    pts, _, ttree = _world()
    q = _knn_queries(pts, 128, 13)
    r = knn.default_radius(ttree, 8, margin=1.0)
    got = knn.knn_query(ttree, torch.from_numpy(q), k=8, radius=r,
                        max_visited=64)
    bd2, bids = knn.knn_brute(pts, q[:, :2], 8, device=CPU)
    d2, trunc = _np(got.neighbor_d2), _np(got.truncated)
    nw = _np(got.n_within)
    assert trunc.any() and not trunc.all()
    assert (_np(got.n_visited) <= 64).all()
    for j in range(q.shape[0]):
        kk = 8 if not trunc[j] else min(int(nw[j]), 8)
        np.testing.assert_array_equal(d2[j, :kk], bd2[j, :kk])
        distinct = np.diff(bd2[j, :kk]) > 0
        if not trunc[j] and distinct.all():
            np.testing.assert_array_equal(
                _np(got.neighbor_ids)[j], bids[j])


# ---------------------------------------------------------------------------
# spatial join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sort", ["hilbert", "none"])
def test_spatial_join_matches_reference_and_brute(sort):
    """Fat outer rects overflow the narrow pair table (the fixture of
    test_joins.py): pairs, merged stats and counters equal the
    reference's, and the pairs equal ``join_brute``."""
    pts, jtree, ttree = _world()
    outer = _rects(pts, np.random.default_rng(5), 80, w=0.25)
    kw = dict(batch=16, max_pairs=4, max_visited=64, wide_factor=64,
              sort=sort)
    want = jjoins.spatial_join(jtree, outer, **kw)
    got = joins.spatial_join(ttree, outer, device=CPU, **kw)
    assert got.n_reserved > 0 and got.residual_truncated == 0
    np.testing.assert_array_equal(got.pairs, want.pairs)
    np.testing.assert_array_equal(got.pairs, joins.join_brute(pts, outer))
    np.testing.assert_array_equal(joins.join_brute(pts, outer),
                                  jjoins.join_brute(pts, outer))
    for f in ("n_outer", "n_pairs", "n_batches", "n_reserved",
              "residual_truncated", "sort"):
        assert getattr(got, f) == getattr(want, f), f
    _assert_fields_equal(got.stats, want.stats)


def test_join_step_matches_reference():
    pts, jtree, ttree = _world()
    outer = _rects(pts, np.random.default_rng(6), 48)
    want = jax.jit(lambda o: jjoins.join_step(jtree, o, max_pairs=8,
                                              max_visited=16))(
        jnp.asarray(outer))
    got = joins.join_step(ttree, torch.from_numpy(outer), max_pairs=8,
                          max_visited=16)
    _assert_fields_equal(got, want)
