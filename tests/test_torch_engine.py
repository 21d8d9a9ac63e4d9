"""The port's serving engine (``repro_torch.core.engine``) against the JAX
package's, on the CPU.

One tree and workload (2500 ``tweets_like`` points, Guttman insertion at
node capacity 32, 150 queries at selectivity 2e-4) carry three banks
fitted by the reference (kNN on a 6×6 grid, MLP and forest on 4×4,
``max_pred`` 16), bridged with ``repro_torch.bridge``. The reference's
serve step runs on a 1×1×1 ``(pod, data, model)`` mesh with
``use_kernel=False`` (its plain oracle, bit-identical to its kernels),
jitted with the hybrid tree as an argument, as the reference's
``EngineFreshServer`` jits it (the eager ``shard_map`` takes ~30 s a call
here; a ``jit`` of a closure over the tree fails under ``set_mesh``).
Integer and bool fields must be bit-equal, dtypes included; with the MLP
bank a row with a cell-slot score within 1e-5 of the threshold is
reported instead of compared. The two-tier stream is held against the
workload's brute-force labels, the engine against the port's
``hybrid_query``, and ``EngineFreshServer`` against the reference's
server and the port's ``FreshServer`` on a mixed stream.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build as jbuild, device_tree as jdt  # noqa: E402
from repro.core import engine as jeng, grid as jgrid  # noqa: E402
from repro.core import labels as jlabels, monitor as jmonitor  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core import traversal as jtrav  # noqa: E402
from repro.core.aitree import cell_slot_probs as j_probs  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import engine, monitor, schedule  # noqa: E402
from repro_torch.core import traversal  # noqa: E402
from repro_torch.core.hybrid import hybrid_query  # noqa: E402

CPU = "cpu"
NEAR = 1e-5
KINDS = ("knn", "mlp", "forest")
FITS = {"knn": dict(grid_sizes=(6,)),
        "mlp": dict(grid_sizes=(4,), mlp_hidden=16, mlp_epochs=800),
        "forest": dict(grid_sizes=(4,))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _assert_fields_equal(got, want, skip_rows=(), msg=""):
    """Every field of two stats tuples bit-equal, dtype included, outside
    ``skip_rows``."""
    assert got._fields == want._fields
    keep = np.setdiff1d(np.arange(_np(want[0]).shape[0]),
                        np.asarray(skip_rows, int))
    for f in want._fields:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        assert g.dtype == w.dtype, f"{msg}{f}: {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g[keep], w[keep], err_msg=msg + f)


@pytest.fixture(scope="module")
def world():
    """The reference's tree, workload and three fitted banks, bridged; a
    query batch with edge rows; a staged insert buffer."""
    pts = jsynth.tweets_like(2500, seed=0)
    jtree = jdt.flatten(JRTree(max_entries=32).insert_all(pts))
    qs = jsynth.synth_queries(pts, 2e-4, 150, seed=1)
    wl = jlabels.make_workload(jtree, qs)
    jh, th = {}, {}
    for kind in KINDS:
        jh[kind], _ = jbuild.fit_airtree(jtree, wl, kind=kind, max_pred=16,
                                         **FITS[kind])
        th[kind] = bridge.hybrid_from_reference(jh[kind], device=CPU)
    lo, hi = pts.min(0), pts.max(0)
    # 62 workload rows, one rect over the whole set (cell-window and walk
    # overflow) and one outside it
    q = np.concatenate([wl.queries[:62], [np.concatenate([lo, hi])],
                        [[500, 500, 501, 501]]]).astype(np.float32)
    # a 512-slot buffer with 300 new points, four of them on row 0's
    # corners (closed-rect containment)
    xy = np.full((512, 2), np.inf, np.float32)
    xy[:300] = jsynth.tweets_like(300, seed=5)
    xy[:4] = q[0, [[0, 1], [2, 3], [0, 3], [2, 1]]]
    return dict(pts=pts, wl=wl, jh=jh, th=th, q=q, xy=xy)


def _near_rows(jh, q, max_cells):
    """MLP rows with a cell-slot score within NEAR of the threshold."""
    if jh.ait.kind != "mlp":
        return np.zeros((0,), int)
    ids, _, _ = jgrid.cells_of_queries(jh.ait.grid, jnp.asarray(q),
                                       max_cells)
    p = np.asarray(j_probs(jh.ait, jnp.asarray(q), ids))
    rows = np.flatnonzero(
        (np.abs(p - jh.ait.threshold) < NEAR).any(axis=(1, 2)))
    if rows.size:
        print(f"near-threshold rows (reported, not compared): {rows}")
    return rows


def _mesh():
    return jax.make_mesh((1, 1, 1), ("pod", "data", "model"))


def _ref_serve(step, jh, q, xy=None):
    """The reference's one-rank step, jitted with the tree an argument."""
    args = (jh, jnp.asarray(q)) + (() if xy is None else (jnp.asarray(xy),))
    return jax.jit(step)(*args)


def _cfgs(**kw):
    """The same configuration in both packages."""
    return jeng.EngineConfig(**kw), engine.EngineConfig(**kw)


# ---------------------------------------------------------------------------
# traversal: compact_candidates and the top_k oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,N,k,L,seed", [
    (16, 40, 8, 12, 0),      # duplicate-heavy: 40 candidates over 12 ids
    (12, 64, 80, 400, 1),    # k past every row's distinct count
    (9, 24, 4, 1000, 2),     # sparse ids, overflowing rows
    (7, 1, 3, 5, 3),         # one candidate a row
    (33, 336, 16, 300, 4),   # 4 cells × 84 label slots
])
def test_compact_candidates_matches_reference(B, N, k, L, seed):
    """Slots, validity and distinct count bit-equal to the reference's
    pairwise form and to ``compact_mask_counted`` of the ids scattered
    into a [B, L] mask; row 0 all masked, row 1 one id repeated."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, L, (B, N)).astype(np.int32)
    ok = rng.uniform(size=(B, N)) < 0.6
    ok[0] = False
    ok[1], ids[1] = True, ids[1, 0]
    want = jax.jit(jtrav.compact_candidates, static_argnums=2)(
        jnp.asarray(ids), jnp.asarray(ok), k)
    got = traversal.compact_candidates(torch.from_numpy(ids),
                                       torch.from_numpy(ok), k)
    mask = np.zeros((B, L), bool)
    for r in range(B):
        mask[r, ids[r, ok[r]]] = True
    dense = traversal.compact_mask_counted(torch.from_numpy(mask), k)
    for g, d, w, name in zip(got, dense, want, ("slots", "valid", "count")):
        assert _np(g).dtype == _np(w).dtype, name
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
        np.testing.assert_array_equal(_np(g), _np(d), err_msg=name)
    count = _np(got[2])
    assert count[0] == 0 and count[1] == 1


@pytest.mark.parametrize("k", [5, 40, 47])
def test_compact_mask_topk_and_overflowed_match_reference(k):
    """The ``top_k`` compaction oracle (ties to the lower index, padded
    past the row width) and ``overflowed`` bit-equal to the reference's;
    on valid slots the oracle equals the sort-free ``compact_mask``."""
    rng = np.random.default_rng(k)
    mask = rng.uniform(size=(20, 40)) < 0.2
    mask[0], mask[1] = False, True
    want = jtrav.compact_mask_topk(jnp.asarray(mask), k)
    got = traversal.compact_mask_topk(torch.from_numpy(mask), k)
    for g, w in zip(got, want):
        assert _np(g).dtype == _np(w).dtype
        np.testing.assert_array_equal(_np(g), _np(w))
    np.testing.assert_array_equal(
        _np(traversal.overflowed(torch.from_numpy(mask), k)),
        _np(jtrav.overflowed(jnp.asarray(mask), k)))
    idx, valid = traversal.compact_mask(torch.from_numpy(mask), k)
    v = _np(valid)
    np.testing.assert_array_equal(_np(got[1]), v)
    np.testing.assert_array_equal(_np(got[0])[v], _np(idx)[v])


@pytest.mark.parametrize("max_results", [8, 64])
def test_gather_result_ids_topk_matches_reference(world, max_results):
    """The ``top_k`` result-id oracle bit-equal to the reference's on the
    world's refined slots, and to the sort-free ``gather_result_ids``."""
    jh, th, q = world["jh"]["knn"], world["th"]["knn"], world["q"]
    cv = traversal.visited_leaves_compact(th.tree, torch.from_numpy(q), 16)
    tref = traversal.refine_leaves(th.tree, torch.from_numpy(q),
                                   cv.leaf_idx, cv.valid)
    jref = jtrav.refine_leaves(jh.tree, jnp.asarray(q),
                               jnp.asarray(_np(cv.leaf_idx)),
                               jnp.asarray(_np(cv.valid)))
    want = jtrav.gather_result_ids_topk(jh.tree, jref, max_results)
    got = traversal.gather_result_ids_topk(th.tree, tref, max_results)
    plain = traversal.gather_result_ids(th.tree, tref, max_results)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(_np(g), _np(w))
        np.testing.assert_array_equal(_np(g), _np(p))
    assert _np(got[1]).any() and (~_np(got[1])).any()


# ---------------------------------------------------------------------------
# the serve steps against the reference's one-rank step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delta", ["none", "staged"])
@pytest.mark.parametrize("union", ["topk", "pmax"])
@pytest.mark.parametrize("kind", KINDS)
def test_serve_step_matches_reference(world, kind, union, delta):
    """Every ``ServeStats`` field of ``make_serve_step`` equals the
    reference's, per bank, score union and insert buffer; the narrow
    bound truncates some rows and the buffer hits some."""
    jh, th, q = world["jh"][kind], world["th"][kind], world["q"]
    xy = world["xy"] if delta == "staged" else None
    jcfg, tcfg = _cfgs(max_visited=16, score_union=union)
    want = _ref_serve(jeng.make_serve_step(_mesh(), jcfg, kind=kind), jh,
                      q, xy)
    step = engine.make_serve_step(tcfg, kind=kind)
    got = step(th, torch.from_numpy(q),
               None if xy is None else torch.from_numpy(xy))
    _assert_fields_equal(got, want, _near_rows(jh, q, tcfg.max_cells))
    assert _np(got.r_truncated).any() and _np(got.routed_high).any()
    assert _np(got.used_ai).any(), "the AI path must answer some rows"
    assert _np(got.delta_hits).any() == (delta == "staged")


@pytest.mark.parametrize("kind", KINDS)
def test_point_serve_step_matches_reference(world, kind):
    """``make_point_serve_step`` on degenerate rects at dataset points:
    every field equal to the reference's, and nothing truncated."""
    pts, jh, th = world["pts"], world["jh"][kind], world["th"][kind]
    p = pts[np.random.default_rng(5).integers(0, len(pts), 64)]
    q = np.concatenate([p, p], axis=1).astype(np.float32)
    jcfg, tcfg = _cfgs()
    want = _ref_serve(jeng.make_point_serve_step(_mesh(), jcfg, kind=kind),
                      jh, q)
    got = engine.make_point_serve_step(tcfg, kind=kind)(th,
                                                        torch.from_numpy(q))
    _assert_fields_equal(got, want, _near_rows(jh, q, 1))
    assert not _np(got.r_truncated).any()
    assert (_np(got.n_results) >= 1).all()


@pytest.mark.parametrize("kind", KINDS)
def test_two_tier_stream_clears_r_truncated(world, kind):
    """``make_two_tier_steps`` through the port's ``serve_workload``: the
    narrow tier's ``r_truncated`` rows are re-served wide, the merged
    counts equal the workload's brute-force labels with no residual
    truncation, and the untruncated rows equal the narrow pass."""
    th, wl = world["th"][kind], world["wl"]
    narrow, wide = engine.make_two_tier_steps(
        engine.EngineConfig(max_visited=1), kind=kind, wide_factor=64)

    def nf(q):
        return narrow(th, q)

    def wf(q):
        return wide(th, q)
    kw = dict(batch=32, sort="hilbert", device=CPU)
    rep_n = schedule.serve_workload(nf, wl.queries, **kw)
    trunc = rep_n.stats.r_truncated
    assert trunc.any(), "fixture too weak: nothing overflowed"
    rep = schedule.serve_workload(nf, wl.queries, wide_fn=wf,
                                  trunc_field="r_truncated", **kw)
    assert rep.n_reserved == int(trunc.sum())
    assert not rep.stats.r_truncated.any()
    np.testing.assert_array_equal(rep.stats.n_results, wl.n_results)
    for f in rep.stats._fields:
        np.testing.assert_array_equal(getattr(rep.stats, f)[~trunc],
                                      getattr(rep_n.stats, f)[~trunc],
                                      err_msg=f)


@pytest.mark.parametrize("union", ["topk", "pmax"])
@pytest.mark.parametrize("kind", KINDS)
def test_engine_matches_hybrid_query(world, kind, union):
    """The engine and the port's ``hybrid_query`` agree on ``n_results``,
    ``used_ai`` and ``leaf_accesses`` over the workload, as the
    reference's engine and ``hybrid_query`` agree
    (``tests/helpers/engine_equiv.py``)."""
    th, wl = world["th"][kind], world["wl"]
    q = torch.from_numpy(wl.queries)
    want = hybrid_query(th, q, max_visited=64, max_results=512)
    got = engine.make_serve_step(
        engine.EngineConfig(max_visited=64, max_pred=th.ait.max_pred,
                            max_cells=th.ait.max_cells, score_union=union),
        kind=kind)(th, q)
    for f in ("n_results", "used_ai", "leaf_accesses", "routed_high",
              "guarded", "mispredict", "cell_id"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)
    np.testing.assert_array_equal(_np(got.n_results), wl.n_results)


# ---------------------------------------------------------------------------
# pad_tree_for_sharding
# ---------------------------------------------------------------------------

def _tensor_fields(obj):
    return [f.name for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))]


@pytest.mark.parametrize("n_shards", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_pad_tree_for_sharding_matches_reference(world, kind, n_shards):
    """Levels, leaf arrays, the ancestor table (rebuilt or dropped as the
    reference decides), every bank array and ``cell_ok`` equal the
    reference's padded tree; the walk pack is the padded levels'; and the
    padded tree serves the unpadded tree's answers."""
    jh, th, q = world["jh"][kind], world["th"][kind], world["q"]
    jp = jeng.pad_tree_for_sharding(jh, n_shards)
    tp = engine.pad_tree_for_sharding(th, n_shards)
    assert tp.tree.n_leaves % n_shards == 0
    assert tp.ait.cell_ok.shape[0] % n_shards == 0
    for a, b in zip(tp.tree.levels, jp.tree.levels, strict=True):
        np.testing.assert_array_equal(_np(a.mbrs), _np(b.mbrs))
        np.testing.assert_array_equal(_np(a.parent), _np(b.parent))
    for f in ("leaf_entries", "leaf_entry_ids", "leaf_counts"):
        np.testing.assert_array_equal(_np(getattr(tp.tree, f)),
                                      _np(getattr(jp.tree, f)), err_msg=f)
    ja = jp.tree.aslices
    assert (tp.tree.aslices is None) == (ja is None)
    if ja is not None:
        np.testing.assert_array_equal(_np(tp.tree.aslices.starts),
                                      _np(ja.starts))
        assert tp.tree.aslices.widths == tuple(ja.widths)
    assert tp.tree.wpack.level_sizes == tuple(
        lv.mbrs.shape[0] for lv in tp.tree.levels)
    for f in _tensor_fields(tp.ait.bank):
        np.testing.assert_array_equal(_np(getattr(tp.ait.bank, f)),
                                      _np(getattr(jp.ait.bank, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(_np(tp.ait.cell_ok), _np(jp.ait.cell_ok))
    step = engine.make_serve_step(engine.EngineConfig(max_visited=16),
                                  kind=kind)
    xy = torch.from_numpy(world["xy"])
    _assert_fields_equal(step(tp, torch.from_numpy(q), xy),
                         step(th, torch.from_numpy(q), xy))


# ---------------------------------------------------------------------------
# EngineFreshServer on a mixed stream
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fresh_world():
    """A kNN world for the mixed stream: 2250 of the 2500 points bulk
    loaded, the other 250 staged as inserts; port copies of the
    ``FitState`` taken before any reference server runs."""
    pts = jsynth.tweets_like(2500, seed=0)
    base, extra = pts[:2250], pts[2250:]
    jtree = jdt.flatten(JRTree.str_bulk(base, max_entries=32))
    qs = jsynth.synth_queries(pts, 2e-3, 160, seed=1)
    wl = jlabels.make_workload(jtree, qs)
    jh, rep = jbuild.fit_airtree(jtree, wl, kind="knn", grid_sizes=(6,),
                                 max_pred=16)
    return dict(base=base, extra=extra, qs=qs, jh=jh, rep=rep,
                th=bridge.hybrid_from_reference(jh, device=CPU),
                fits=[bridge.fit_state_from_reference(rep.fit_state)
                      for _ in range(2)])


def test_engine_fresh_server_matches_reference(fresh_world):
    """Inserts, policy repacks, refit chunks and ``on_segment`` under
    ``DefaultPolicy``: every served ``ServeStats`` field, the report's
    counters, the decisions, the refit reports and ``stats()`` equal the
    reference's one-rank ``EngineFreshServer``; ``n_results`` equals the
    port's ``FreshServer`` on the same stream."""
    w = fresh_world
    pol = dict(refit_chunk=4, repack_at=0.25)
    kw = dict(delta_cap=512, wide_factor=8)
    jcfg, tcfg = _cfgs(max_visited=1)
    tsrv = monitor.EngineFreshServer(
        w["base"], w["th"], tcfg, kind="knn", fit_state=w["fits"][0],
        policy=monitor.DefaultPolicy(**pol), **kw)
    jsrv = jmonitor.EngineFreshServer(
        w["base"], w["jh"], _mesh(), jcfg, kind="knn", n_model=1,
        fit_state=w["rep"].fit_state, policy=jmonitor.DefaultPolicy(**pol),
        **kw)
    fsrv = monitor.FreshServer(
        w["base"], w["th"], max_visited=1, fit_state=w["fits"][1],
        policy=monitor.DefaultPolicy(**pol), **kw)
    run = dict(batch=32, sort="hilbert", insert_every=1)
    tm = schedule.serve_mixed_workload(tsrv, w["qs"], w["extra"], **run)
    jm = jschedule.serve_mixed_workload(jsrv, w["qs"], w["extra"], **run)
    fm = schedule.serve_mixed_workload(fsrv, w["qs"], w["extra"], **run)
    _assert_fields_equal(tm.stats, jm.stats, msg="stats.")
    for f in ("n_queries", "n_batches", "n_reserved", "n_inserts",
              "n_repacks", "n_segments", "seg_bounds"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert len(tm.maintenance) == len(jm.maintenance)
    for (ts, td), (js, jd) in zip(tm.maintenance, jm.maintenance):
        assert ts == js
        for f in jd._fields:
            np.testing.assert_array_equal(getattr(td, f), getattr(jd, f),
                                          err_msg=f"decision {ts}: {f}")
    assert [dataclasses.replace(r, train_seconds=0).__dict__
            for r in tsrv.refits] == \
        [dataclasses.replace(r, train_seconds=0).__dict__
         for r in jsrv.refits]
    assert tsrv.stats() == jsrv.stats()
    assert sum(d.repack for _, d in tm.maintenance) >= 1
    assert sum(r.cells_refit for r in tsrv.refits) > 0
    assert int(tm.stats.delta_hits.sum()) > 0
    assert tm.n_reserved > 0 and not tm.stats.r_truncated.any()
    np.testing.assert_array_equal(tm.stats.n_results, fm.stats.n_results)
    # the served copy is the padded current hybrid
    np.testing.assert_array_equal(_np(tsrv._h_p.ait.cell_ok),
                                  _np(jsrv._h_p.ait.cell_ok))
    assert tsrv._h_p.tree.n_leaves == tsrv.hybrid.tree.n_leaves


def test_model_axis_one_rank_only():
    """The model axis's collectives are identities at one rank, and a
    larger world with no initialised process group raises a
    ``RuntimeError`` rather than serve one rank (the axis over a group
    is held in ``tests/test_torch_engine_mesh.py``)."""
    ax = engine.model_axis(1)
    x = torch.arange(6).reshape(2, 3)
    assert (ax.index, ax.size) == (0, 1)
    for out in (ax.psum(x), ax.pmax(x), ax.all_gather(x, 1)):
        assert torch.equal(out, x)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        engine.model_axis(2)
