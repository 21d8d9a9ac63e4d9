"""The port's forest bank against the JAX package, on the CPU.

A small forest world is fitted by the reference (2500 ``tweets_like``
points, node capacity 32, 150 queries, a 4×4 grid, one tree of depth 8 a
cell — the driver's default) and carried across with
``repro_torch.bridge.hybrid_from_reference``; both packages then answer
the same queries. The fit is host numpy on one seed, so the fitted
arrays are bit-equal. Votes are bit-equal at T = 1 (the mean of one
vote is the vote); at T > 1 the reference's ``jnp.mean`` may sum in
another order than ``torch.mean``, so ``cell_probs_for`` is held to
1 ulp there. The dense form sums the trees in tree order in both the
reference's interpret-mode kernel and the port's plain version, so it is
bit-equal for every T. Served fields are bit-equal and every result
count matches brute-force containment.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import build as jbuild, celldata as jcelldata  # noqa: E402
from repro.core import device_tree as jdt, grid as jgrid  # noqa: E402
from repro.core import labels as jlabels  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core.aitree import ai_query_compact as j_ai_compact  # noqa: E402
from repro.core.classifiers import forest as jforest  # noqa: E402
from repro.core.hybrid import hybrid_query as j_hybrid  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.kernels import forest_infer as jfi, ref as jref  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import aitree, build, labels  # noqa: E402
from repro_torch.core import device_tree as dt, schedule  # noqa: E402
from repro_torch.core.aitree import ai_query_compact  # noqa: E402
from repro_torch.core.classifiers import forest  # noqa: E402
from repro_torch.core.geometry import np_contains_point  # noqa: E402
from repro_torch.core.hybrid import hybrid_query  # noqa: E402
from repro_torch.core.monitor import DefaultPolicy  # noqa: E402
from repro_torch.core.rtree import RTree  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py)
from helpers.torch_inputs import forest_cells_inputs  # noqa: E402

CPU = "cpu"
MV, MR, WF = 2, 256, 8       # narrow bounds small enough to re-serve wide


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The reference-fitted forest world, its bridged port, the cell
    datasets of its grid, and a query batch with an empty edge row."""
    pts = jsynth.tweets_like(2500, seed=0)
    jtree = jdt.flatten(JRTree(max_entries=32).insert_all(pts))
    qs = jsynth.synth_queries(pts, 2e-4, 150, seed=1)
    wl = jlabels.make_workload(jtree, qs)
    jh, jrep = jbuild.fit_airtree(jtree, wl, kind="forest", grid_sizes=(4,))
    th = bridge.hybrid_from_reference(jh, device=CPU)
    ds = jcelldata.build_cell_datasets(jh.ait.grid, wl,
                                       max_cells_per_query=4)
    q = np.concatenate([wl.queries, [[500, 500, 501, 501]]]).astype(
        np.float32)
    return dict(pts=pts, wl=wl, jh=jh, jrep=jrep, th=th, ds=ds, q=q)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _assert_fields_equal(got, want, msg=""):
    assert tuple(got._fields) == tuple(want._fields)
    for f in want._fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)),
                                      err_msg=f"{msg}{f}")


def _forest_pair(ds, n_trees, depth, bootstrap, seed=0, empty=(0,)):
    """The reference's and the port's ``fit_forest`` on the same cell
    datasets, with the cells in ``empty`` stripped of their queries."""
    qmask = ds.qmask.copy()
    qmask[list(empty)] = False
    kw = dict(n_trees=n_trees, depth=depth, bootstrap=bootstrap, seed=seed)
    jf = jforest.fit_forest(ds.feats, ds.labels, qmask, ds.label_map,
                            ds.lmask, **kw)
    tf = forest.fit_forest(ds.feats, ds.labels, qmask, ds.label_map,
                           ds.lmask, device=CPU, **kw)
    return jf, tf


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_trees,depth,bootstrap", [
    (1, 8, False),      # the driver's default bank
    (3, 4, True),       # bagged trees share the cell's rng stream
])
def test_fit_forest_matches_reference(world, n_trees, depth, bootstrap):
    """Same cell datasets and seed → bit-equal ``feat_idx``, ``thresh``
    and ``tables`` (host numpy on one rng), an emptied cell kept at
    ``thresh = +inf`` with an all-zero table."""
    jf, tf = _forest_pair(world["ds"], n_trees, depth, bootstrap)
    for f in ("feat_idx", "thresh", "tables", "label_map", "lmask"):
        want = np.asarray(getattr(jf, f))
        got = getattr(tf, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tf.n_cells, tf.n_trees, tf.depth) == (
        jf.n_cells, jf.n_trees, jf.depth)
    assert tf.byte_size() == jf.byte_size()
    assert np.isinf(tf.thresh[0].numpy()).all()
    assert not tf.tables[0].numpy().any()


@pytest.mark.parametrize("seed", range(6))
def test_fit_oblivious_tree_matches_reference(seed):
    """The port's split search (``np.bincount`` over Y's nonzeros) against
    the reference's ``np.add.at`` trainer on random data: multi-hot,
    fractional and all-zero label matrices, depths 1 to 8 —
    bit-equal features, thresholds and leaf tables."""
    rng = np.random.default_rng(seed)
    n, F, Cl = int(rng.integers(1, 300)), int(rng.integers(1, 7)), \
        int(rng.integers(1, 200))
    X = rng.normal(size=(n, F)).astype(np.float32)
    Y = [(rng.uniform(size=(n, Cl)) < 0.05),
         rng.uniform(size=(n, Cl)) * (rng.uniform(size=(n, Cl)) < 0.2),
         np.zeros((n, Cl))][seed % 3].astype(np.float32)
    depth = (1, 2, 4, 8, 6, 3)[seed]
    want = jforest._fit_oblivious_tree(X, Y, depth, 16,
                                       np.random.default_rng(1))
    got = forest._fit_oblivious_tree(X, Y, depth, 16,
                                     np.random.default_rng(1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_fit_airtree_forest_matches_reference(world):
    """The port's own build on the same points and queries fits the same
    bank, guard and exact fit as the reference's."""
    pts, wl, jh, jrep = world["pts"], world["wl"], world["jh"], world["jrep"]
    tree = dt.flatten(RTree(max_entries=32).insert_all(pts), device=CPU)
    twl = labels.make_workload(tree, wl.queries)
    th, rep = build.fit_airtree(tree, twl, kind="forest", grid_sizes=(4,))
    assert th.ait.kind == "forest" and rep.classifier_kind == "forest"
    for f in ("feat_idx", "thresh", "tables", "label_map", "lmask"):
        np.testing.assert_array_equal(getattr(th.ait.bank, f).numpy(),
                                      np.asarray(getattr(jh.ait.bank, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(th.ait.cell_ok.numpy(),
                                  np.asarray(jh.ait.cell_ok))
    assert rep.exact_fit == jrep.exact_fit
    assert rep.model_bytes == jrep.model_bytes
    assert rep.fit_state.kind == "forest"


def test_forest_banks_refit_whole(world):
    """No per-cell splice for a forest bank, as in the reference: both
    ``update_bank_cells`` and ``refit_cells`` refuse it."""
    th = world["th"]
    with pytest.raises(NotImplementedError, match="forest banks refit whole"):
        aitree.update_bank_cells(th.ait.bank, [0],
                                 label_map=th.ait.bank.label_map[:1])
    state = bridge.fit_state_from_reference(world["jrep"].fit_state)
    with pytest.raises(NotImplementedError, match="retrain whole"):
        build.refit_cells(th, state)


# ---------------------------------------------------------------------------
# inference: the gathered and the dense forms
# ---------------------------------------------------------------------------

def test_cell_probs_for_matches_reference_t1(world):
    """The served form at the default T = 1: bit-equal on every cell slot
    of every query (the empty edge row included)."""
    jh, th, q = world["jh"], world["th"], world["q"]
    ids, _, _ = jgrid.cells_of_queries(jh.ait.grid, jnp.asarray(q),
                                       jh.ait.max_cells)
    want = np.asarray(jforest.cell_probs_for(jh.ait.bank, jnp.asarray(q),
                                             ids))
    got = forest.cell_probs_for(th.ait.bank, torch.from_numpy(q),
                                torch.from_numpy(np.array(ids)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cell_probs_for_matches_reference_t4(world):
    """Four bagged trees a cell: within 1 ulp of the reference (its
    ``jnp.mean`` may sum the four votes in another order)."""
    jf, tf = _forest_pair(world["ds"], 4, 8, True)
    q = world["q"]
    jh = world["jh"]
    ids, _, _ = jgrid.cells_of_queries(jh.ait.grid, jnp.asarray(q),
                                       jh.ait.max_cells)
    want = np.asarray(jforest.cell_probs_for(jf, jnp.asarray(q), ids))
    got = forest.cell_probs_for(tf, torch.from_numpy(q),
                                torch.from_numpy(np.array(ids))).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("n_trees", [1, 4])
def test_cell_probs_dense_matches_reference(world, n_trees):
    """The dense form: the port's plain votes bit-equal to the reference's
    ``forest_infer_cells`` kernel run in interpret mode (called directly,
    tree order in both) and the port's ``cell_probs_dense`` bit-equal to
    the reference's; against the reference's plain per-tree votes summed
    by ``jnp.sum`` each element is within T·2^-23 (every partial sum is
    at most T, so one rounding costs at most half an ulp of T). An emptied
    cell (``thresh = +inf``) votes its leaf-0 row, 37 queries are not a
    multiple of the kernel's tile."""
    jf, tf = _forest_pair(world["ds"], n_trees, 8, n_trees > 1,
                          empty=(0, 5))
    q = world["q"][:37]
    C, T, D = tf.feat_idx.shape
    Cl = tf.tables.shape[-1]
    fi = np.asarray(jf.feat_idx).reshape(C * T, D)
    th = np.asarray(jf.thresh).reshape(C * T, D)
    tb = np.asarray(jf.tables).reshape(C * T, 2 ** D, Cl)
    sel = jnp.asarray(q)[:, fi]
    want_votes = np.asarray(jfi.forest_infer_cells(
        sel, jnp.asarray(th), jnp.asarray(tb), n_cells=C, tb=37,
        interpret=True))
    got_votes = tops.forest_infer_cells(
        torch.from_numpy(q), torch.from_numpy(fi), torch.from_numpy(th),
        torch.from_numpy(tb), n_cells=C).numpy()
    np.testing.assert_array_equal(got_votes, want_votes)

    got = forest.cell_probs_dense(tf, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jforest.cell_probs_dense(jf, jnp.asarray(q))))
    per = np.asarray(jref.forest_infer_percell(sel, jnp.asarray(th),
                                               jnp.asarray(tb)))
    plain = per.reshape(len(q), C, T, Cl).sum(axis=2) / T
    np.testing.assert_allclose(got, plain, rtol=0, atol=T * 2.0 ** -23)


def test_cell_probs_dense_equals_gathered_form_t1(world):
    """At T = 1 the dense form of every cell equals the gathered form
    with every cell in the slot table, bit for bit."""
    tf = world["th"].ait.bank
    q = torch.from_numpy(world["q"])
    C = tf.n_cells
    ids = torch.arange(C, dtype=torch.int32).expand(q.shape[0], C)
    dense = forest.cell_probs_dense(tf, q)
    assert torch.equal(dense, forest.cell_probs_for(tf, q, ids))


@pytest.mark.parametrize("B,C,T,D,Cl", [
    (37, 5, 4, 8, 37),      # tile remainder, Cl not a multiple of 32
    (3, 2, 1, 1, 1),        # depth 1, one label
    (0, 3, 2, 4, 6),        # no query
])
def test_forest_infer_cells_plain_matches_reference(B, C, T, D, Cl):
    """The plain version against the reference's interpret kernel on
    synthetic banks (``forest_cells_inputs``: features exactly on a
    threshold, an empty cell, feature ids at both ends of [0, F)); the
    empty cell votes the sum of its trees' leaf-0 rows."""
    rng = np.random.default_rng(B + 10 * C + 100 * T + D)
    feats, fi, th, tb = forest_cells_inputs(rng, B, C, T, D, Cl)
    got = tops.forest_infer_cells(torch.from_numpy(feats),
                                  torch.from_numpy(fi), torch.from_numpy(th),
                                  torch.from_numpy(tb), n_cells=C)
    assert tuple(got.shape) == (B, C, Cl)
    if not B:
        return
    want = jfi.forest_infer_cells(jnp.asarray(feats)[:, fi],
                                  jnp.asarray(th), jnp.asarray(tb),
                                  n_cells=C, tb=B, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = tb[T, 0].copy()                     # leaf 0, in tree order
    for t in range(1, T):
        empty += tb[T + t, 0]
    np.testing.assert_array_equal(got[:, 1].numpy(),
                                  np.broadcast_to(empty, (B, Cl)))
    assert torch.equal(got, tref.forest_infer_cells(
        torch.from_numpy(feats), torch.from_numpy(fi), torch.from_numpy(th),
        torch.from_numpy(tb), C))


# ---------------------------------------------------------------------------
# serving on the bridged world
# ---------------------------------------------------------------------------

def test_ai_query_compact_matches_reference(world):
    """Slot tables, ``n_pred``, ``fallback`` and ``cell_id`` of the
    forest bank's AI path, bit for bit."""
    jh, th, q = world["jh"], world["th"], world["q"]
    want = j_ai_compact(jh.ait, jh.tree, jnp.asarray(q), max_results=MR)
    got = ai_query_compact(th.ait, th.tree, torch.from_numpy(q),
                           max_results=MR)
    _assert_fields_equal(got, want)
    assert int(got.n_pred.sum()) > 0


def test_hybrid_query_matches_reference(world):
    """Every ``hybrid_query`` field (counts, result ids, routing,
    fallback and truncation flags) bit for bit on the bridged world, and
    the forest bank answers part of the batch on the AI path."""
    jh, th, q = world["jh"], world["th"], world["q"]
    want = j_hybrid(jh, jnp.asarray(q), max_visited=MV, max_results=MR)
    got = hybrid_query(th, torch.from_numpy(q), max_visited=MV,
                       max_results=MR)
    _assert_fields_equal(got, want)
    assert got.used_ai.any() and (~got.used_ai).any()


def _brute_counts_ids(pts, q):
    inside = np_contains_point(q[:, None, :],
                               np.asarray(pts, np.float32)[None])
    return inside.sum(axis=1), inside


def test_forest_stream_matches_reference_and_brute_force(world):
    """The range stream through ``serve_workload`` (Hilbert order, both
    tiers) equals the reference's field for field, and every count and
    untruncated id set matches brute-force containment exactly."""
    jh, th, wl, pts = world["jh"], world["th"], world["wl"], world["pts"]
    jn = jax.jit(lambda x: j_hybrid(jh, x, max_visited=MV, max_results=MR))
    jw = jax.jit(lambda x: j_hybrid(jh, x, max_visited=MV * WF,
                                    max_results=MR * WF))
    want = jschedule.serve_workload(jn, wl.queries, batch=32, sort="hilbert",
                                    wide_fn=jw, trunc_field="truncated")
    rep = schedule.serve_workload(
        lambda x: hybrid_query(th, x, max_visited=MV, max_results=MR),
        wl.queries, batch=32, sort="hilbert",
        wide_fn=lambda x: hybrid_query(th, x, max_visited=MV * WF,
                                       max_results=MR * WF),
        trunc_field="truncated", device=CPU)
    _assert_fields_equal(rep.stats, want.stats)
    assert (rep.n_reserved, rep.wide_batches) == (want.n_reserved,
                                                  want.wide_batches)
    assert rep.n_reserved > 0
    n, inside = _brute_counts_ids(pts, wl.queries)
    np.testing.assert_array_equal(rep.stats.n_results, n)
    for j in range(len(n)):
        ids = rep.stats.result_ids[j]
        assert set(ids[ids >= 0].tolist()) == \
            set(np.flatnonzero(inside[j]).tolist())


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

ARGV = ["--device", "cpu", "--points", "3000", "--queries", "300",
        "--batch", "64", "--node-capacity", "32", "--classifier", "forest"]


def test_serve_main_forest_range(capsys):
    """``--classifier forest`` serves the range stream end to end on the
    CPU: every count matches the labels, and the report says the dense
    score table stays (no prediction kernel for forest banks)."""
    serve.main(ARGV + ["--reps", "1"])
    out = capsys.readouterr().out
    assert "# oracle: 0 / 300 n_results mismatches" in out
    assert "the forest bank has no fused prediction kernel" in out


def test_forest_mixed_stream_skips_refits(capsys):
    """A forest-bank mixed stream under ``--policy default`` runs to its
    end: the server gets no ``FitState`` (as the reference's driver gives
    none), and the refit chunks the policy asks for are skipped and
    counted, with the notice printed once. A policy that demotes every
    serve-eligible cell with traffic and promotes it a segment later
    forces such chunks (a promotion is a forced refit); every count still
    matches brute force per segment."""
    args = serve.parse_args(ARGV + [
        "--insert-rate", "0.05", "--insert-every", "1", "--repack-every",
        "100", "--policy", "default"])
    idx = serve.build_index(args)
    server = serve.make_fresh_server(idx, args)
    assert server.fit_state is None and server.policy is not None
    server.policy = dataclasses.replace(
        server.policy, demote_mispredict=-1.0, min_traffic=0.0,
        promote_after=1)
    assert isinstance(server.policy, DefaultPolicy)
    capsys.readouterr()
    mixed, server, _, mism = serve.serve_mixed(idx, idx.extra, args,
                                               server=server)
    out = capsys.readouterr().out
    skipped = sum(d.refit_skipped for _, d in mixed.maintenance)
    assert mism == 0
    assert len(mixed.maintenance) == mixed.n_segments
    assert skipped > 0 and not server.refits
    assert out.count("cell-granular refit disabled") == 1
    assert f"({skipped} skipped)" in out


def test_serve_main_forest_mixed_default_policy(capsys):
    """The satellite's command line: ``--classifier forest --insert-rate
    0.05 --policy default`` runs to its end with 0 oracle mismatches."""
    serve.main(ARGV + ["--insert-rate", "0.05", "--insert-every", "1",
                       "--repack-every", "100", "--policy", "default"])
    out = capsys.readouterr().out
    assert "# oracle: 0 / 300 n_results mismatches" in out
    assert "# policy:" in out
