"""The port's ``refit_cells`` at the draw where the reference's property
test fails, pinned with fixed inputs.

``tests/test_refit.py::test_refit_cells_equals_full_fit_knn`` draws
(seed, m) with hypothesis. At seed 26130, m 16 the reference's refit
renames an unchanged cell's leaf ids through ``spans.remap_label_map``
without sorting them again (``src/repro/core/build.py:340-346``), so its
``label_map`` and ``labels`` columns sit in another order than a full fit
of the new tree gives, while every served field is the same. The port
copies the step. This file holds, on the reference test's own world
(2,000 ``tweets_like`` points, capacity 32, 100 queries, a 4x4 kNN bank,
16 points inserted in one corner):

* the port's refit bit-equal to the reference's refit (bank, guard,
  certificates);
* the port's refit equal to the port's full fit of the new tree up to a
  per-cell permutation of the label columns (``label_map``, ``lmask``
  and the ``labels`` columns moved together);
* the two serving the same fields, the router held fixed.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build as jbuild, device_tree as jdt  # noqa: E402
from repro.core import labels as jlabels  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro_torch.core import build, device_tree as dt, labels  # noqa: E402
from repro_torch.core.hybrid import hybrid_query  # noqa: E402
from repro_torch.core.rtree import RTree  # noqa: E402
from repro_torch.data import synth  # noqa: E402

SEED, M = 26130, 16
LKW = {"max_results": 2048}
FIELDS = ("feats", "labels", "label_map", "lmask")


def _corner(pts):
    """The reference test's ``_insert_corner`` points for (SEED, M)."""
    rng = np.random.default_rng(SEED)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    corner = lo + rng.uniform(0.0, 0.1, 2) * (hi - lo)
    return (corner + np.abs(rng.normal(0, 0.004, (M, 2)))).astype(np.float32)


def _refit_world(synth_mod, rtree, flatten, make_workload, fit_airtree,
                 refit_cells):
    """Fit, insert in a corner, refit and fit the new tree from scratch:
    ``(refit hybrid, refit state, full hybrid, full report, queries)``."""
    pts = synth_mod.tweets_like(2000, seed=SEED % 1000)
    tree = rtree(max_entries=32).insert_all(pts)
    qs = synth_mod.synth_queries(pts, 1e-3, 100, seed=SEED % 1000 + 1)
    kw = dict(kind="knn", grid_sizes=(4,), label_kwargs=LKW)
    dtree = flatten(tree)
    hyb, rep = fit_airtree(dtree, make_workload(dtree, qs, **LKW), **kw)
    state = rep.fit_state
    tree.insert_all(_corner(pts))
    dtree2 = flatten(tree)
    hyb_r, state_r, rrep = refit_cells(
        dataclasses.replace(hyb, tree=dtree2), state)
    assert rrep.cells_stale_left == 0
    hyb_f, rep_f = fit_airtree(dtree2, make_workload(dtree2, qs, **LKW),
                               max_labels=state.cl, max_queries=state.qp,
                               **kw)
    return hyb_r, state_r, hyb_f, rep_f, qs


@pytest.fixture(scope="module")
def worlds():
    port = _refit_world(synth, RTree,
                        lambda t: dt.flatten(t, device="cpu"),
                        labels.make_workload, build.fit_airtree,
                        build.refit_cells)
    ref = _refit_world(jsynth, JRTree, jdt.flatten, jlabels.make_workload,
                       jbuild.fit_airtree, jbuild.refit_cells)
    return port, ref


def _canonical(bank, c):
    """Cell ``c``'s label columns in label-id order (masked ones last):
    ``(label_map, lmask, labels)``."""
    lm = bank.label_map[c].numpy()
    ok = bank.lmask[c].numpy()
    order = np.argsort(np.where(ok, lm, np.iinfo(np.int32).max),
                       kind="stable")
    return lm[order], ok[order], bank.labels[c].numpy()[:, order]


def test_refit_pin_port_equals_reference_refit(worlds):
    (hyb_r, state_r, *_), (jhyb_r, jstate_r, *_) = worlds
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(hyb_r.ait.bank, f).numpy(),
            np.asarray(getattr(jhyb_r.ait.bank, f)), err_msg=f)
    np.testing.assert_array_equal(hyb_r.ait.cell_ok.numpy(),
                                  np.asarray(jhyb_r.ait.cell_ok))
    np.testing.assert_array_equal(np.asarray(state_r.exact),
                                  np.asarray(jstate_r.exact))
    assert np.asarray(state_r.exact_valid).all()


def test_refit_pin_equals_full_fit_up_to_label_order(worlds):
    hyb_r, state_r, hyb_f, rep_f, _ = worlds[0]
    a, b = hyb_r.ait.bank, hyb_f.ait.bank
    np.testing.assert_array_equal(a.feats.numpy(), b.feats.numpy())
    for c in range(a.label_map.shape[0]):
        for x, y in zip(_canonical(a, c), _canonical(b, c)):
            np.testing.assert_array_equal(x, y, err_msg=f"cell {c}")
    np.testing.assert_array_equal(hyb_r.ait.cell_ok.numpy(),
                                  hyb_f.ait.cell_ok.numpy())
    np.testing.assert_array_equal(np.asarray(state_r.exact),
                                  np.asarray(rep_f.fit_state.exact))


def test_refit_pin_serves_as_full_fit(worlds):
    hyb_r, _, hyb_f, _, qs = worlds[0]
    hyb_f = dataclasses.replace(hyb_f, router=hyb_r.router)
    q = torch.from_numpy(qs)
    a = hybrid_query(hyb_r, q, max_visited=256, max_results=512)
    b = hybrid_query(hyb_f, q, max_visited=256, max_results=512)
    for f in ("used_ai", "n_results", "result_ids", "guarded",
              "leaf_accesses", "mispredict"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)
