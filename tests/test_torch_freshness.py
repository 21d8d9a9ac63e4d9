"""The port's freshness path (mixed read/write stream) against the JAX
package, on the CPU.

Inputs are made with numpy from seeds. The delta probe goes through the
JAX kernel wrapper (Pallas in interpret mode here), the JAX plain
reference and the port's dispatch (its plain version on CPU tensors);
every output is bit-equal. The serving world is the reference's trained
kNN world of ``tests/test_delta.py`` (6000 ``tweets_like`` points, 600
held out as inserts, a 6×6 grid), carried across with
``repro_torch.bridge``; the kNN bank is deterministic, so the mixed
stream and the whole maintenance loop (span-diff repacks, ``refit_cells``
chunks, the policy's decisions) must match the reference field for
field. Result counts are also held against brute-force containment over
each segment's visible points.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import build as jbuild, delta as jdelta  # noqa: E402
from repro.core import device_tree as jdt, grid as jgrid  # noqa: E402
from repro.core import labels as jlabels, schedule as jschedule  # noqa: E402
from repro.core import spans as jspans, telemetry as jtele  # noqa: E402
from repro.core import monitor as jmonitor  # noqa: E402
from repro.core.hybrid import HybridResult as JResult  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import build, delta, device_tree as dt  # noqa: E402
from repro_torch.core import labels, monitor, schedule, spans  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.core.geometry import np_contains_point  # noqa: E402
from repro_torch.core.grid import Grid  # noqa: E402
from repro_torch.core.hybrid import HybridResult, hybrid_query  # noqa: E402
from repro_torch.core.rtree import RTree  # noqa: E402
from repro_torch.data import synth  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py)
from helpers.torch_inputs import delta_inputs  # noqa: E402

CPU = "cpu"
FRESH = dict(delta_cap=1024, max_visited=64, max_results=256,
             wide_factor=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _assert_tuple_equal(got, want, msg=""):
    for f in type(want)._fields:
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)),
                                      err_msg=f"{msg}{f}")


# ---------------------------------------------------------------------------
# the kernel's plain version and wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,cap,fill,k", [
    (37, 300, 211, 8),     # partial buffer, edge rows at k and k + 1
    (64, 1000, 1000, 16),  # full buffer
    (8, 100, 0, 4),        # all +inf: nothing hits
    (21, 777, 600, 8),     # cap not a multiple of 512
    (5, 1, 1, 4),          # one-point store
])
def test_delta_probe_matches_jax(B, cap, fill, k):
    """``slot_idx``, ``valid`` and ``count`` bit-equal across the JAX
    kernel (interpret), the JAX reference, the port's plain version and
    its CPU dispatch; rows at exactly k and k + 1 hits and rects whose
    edges and corners pass through buffer points."""
    q, pts = delta_inputs(np.random.default_rng(B + cap), B, cap, fill, k)
    want = jops.delta_probe(jnp.asarray(q), jnp.asarray(pts), k=k)
    want_r = jref.delta_probe(jnp.asarray(q), jnp.asarray(pts), k)
    got_p = tref.delta_probe(torch.from_numpy(q), torch.from_numpy(pts), k)
    got = tops.delta_probe(torch.from_numpy(q), torch.from_numpy(pts), k=k)
    for i, name in enumerate(("slot_idx", "valid", "count")):
        for g in (want_r[i], got_p[i], got[i]):
            np.testing.assert_array_equal(_np(g), np.asarray(want[i]),
                                          err_msg=name)
    count = got[2].numpy()
    assert count[0] == 0
    if fill > k:
        assert count[1:4].tolist() == [k, k + 1, k - 1]
    if fill == 0:
        assert not count.any()


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

def test_stage_inserts_ids_and_overflow():
    """Staging rounds to f32 exactly as the reference, ids continue the
    tree's numbering, and overflow raises in both packages."""
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-1, 1, (10, 2)), rng.uniform(-1, 1, (6, 2))
    js = jdelta.stage_inserts(jdelta.make_delta(16, base=100), a)
    ts = delta.stage_inserts(delta.make_delta(16, base=100, device=CPU), a)
    js, ts = jdelta.stage_inserts(js, b), delta.stage_inserts(ts, b)
    assert (ts.n, ts.base, ts.capacity) == (js.n, js.base, js.capacity)
    np.testing.assert_array_equal(ts.xy.numpy(), np.asarray(js.xy))
    np.testing.assert_array_equal(delta.staged_points(ts),
                                  jdelta.staged_points(js))
    for stage, store in ((jdelta.stage_inserts, js),
                         (delta.stage_inserts, ts)):
        with pytest.raises(ValueError, match="overflow"):
            stage(store, rng.uniform(-1, 1, (1, 2)))
    q = np.array([[-1, -1, 1, 1], [0, 0, 0.5, 0.5]], np.float32)
    jh = jdelta.probe(js.xy, jnp.asarray(q), k=8, base=js.base)
    th = delta.probe(ts.xy, torch.from_numpy(q), k=8, base=ts.base)
    _assert_tuple_equal(th, jh)


def _results(rng, B, mr):
    """A ``HybridResult`` pair (port, reference) whose rows hold
    ``n_results`` tree ids (-1 padded), some crossing ``mr``."""
    n = rng.integers(0, mr + 4, B).astype(np.int32)
    n[:6] = [0, mr - 8, mr - 2, mr, mr + 3, 3]
    rid = np.full((B, mr), -1, np.int32)
    for r in range(B):
        m = min(int(n[r]), mr)
        rid[r, :m] = rng.choice(900, m, replace=False)
    z = np.zeros(B, np.int32)
    fields = dict(routed_high=rng.uniform(size=B) < 0.5,
                  used_ai=rng.uniform(size=B) < 0.3, n_results=n,
                  result_ids=rid, leaf_accesses=z + 3, n_visited_r=z + 4,
                  n_true=z + 2, truncated=rng.uniform(size=B) < 0.2,
                  guarded=rng.uniform(size=B) < 0.2,
                  mispredict=rng.uniform(size=B) < 0.1, cell_id=z - 1)
    return (HybridResult(**{k: torch.from_numpy(np.asarray(v))
                            for k, v in fields.items()}),
            JResult(**{k: jnp.asarray(v) for k, v in fields.items()}))


def test_merge_hybrid_result_matches_jax():
    """Every merged field bit-equal, with rows whose merged ids cross
    ``max_results`` and rows whose hits overflow the ``k`` slots."""
    rng = np.random.default_rng(1)
    B, mr, k = 40, 24, 8
    q, pts = delta_inputs(rng, B, 300, 260, k)
    tres, jres = _results(rng, B, mr)
    th = delta.probe(torch.from_numpy(pts), torch.from_numpy(q), k=k,
                     base=1000)
    jh = jdelta.probe(jnp.asarray(pts), jnp.asarray(q), k=k, base=1000)
    count = th.count.numpy()
    assert (count > k).any() and ((count > 0) & (count <= k)).any()
    got = delta.merge_hybrid_result(tres, th)
    want = jdelta.merge_hybrid_result(jres, jh)
    _assert_tuple_equal(got, want)
    crossing = (tres.n_results.numpy() < mr) \
        & (tres.n_results.numpy() + count > mr)
    assert crossing.any() and got.truncated.numpy()[crossing].all()


# ---------------------------------------------------------------------------
# telemetry and the monitor
# ---------------------------------------------------------------------------

def test_telemetry_matches_jax():
    rng = np.random.default_rng(2)
    xs = rng.exponential(1.0, 700)
    je, te = jtele.Ewma(0.3), telemetry.Ewma(0.3)
    jr, tr = jtele.QuantileReservoir(256, 5), telemetry.QuantileReservoir(
        256, 5)
    jw = jtele.SegmentWindow(6, ("n", "a", "b"), window=3)
    tw = telemetry.SegmentWindow(6, ("n", "a", "b"), window=3)
    for i, x in enumerate(xs):
        assert te.update(x) == je.update(x)
        jr.add(x)
        tr.add(x)
        keys = rng.integers(0, 5, 4)
        vals = {"a": rng.integers(0, 2, 4), "b": rng.integers(0, 3, 4)}
        jw.add(keys, vals)
        tw.add(keys, vals)
        if i % 50 == 49:
            jw.roll()
            tw.roll()
    assert tr.summary() == jr.summary()
    for f in ("a", "b"):
        np.testing.assert_array_equal(tw.rate(f), jw.rate(f))
    np.testing.assert_array_equal(tw.count_median(), jw.count_median())


def _boundary_points(bbox, g):
    """Points exactly on every interior cell boundary of the grid's f32
    cell width ``span * f32(1/g)``, and one ulp either side."""
    b = np.asarray(bbox, np.float32)
    inv = np.float32(1) / np.float32(g)
    cw, ch = (b[2] - b[0]) * inv, (b[3] - b[1]) * inv
    xs = b[0] + cw * np.arange(1, g, dtype=np.float32)
    ys = b[1] + ch * np.arange(1, g, dtype=np.float32)
    xs = np.concatenate([xs, np.nextafter(xs, np.float32(np.inf)),
                         np.nextafter(xs, np.float32(-np.inf))])
    ys = np.concatenate([ys, np.nextafter(ys, np.float32(np.inf)),
                         np.nextafter(ys, np.float32(-np.inf))])
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32)


def test_monitor_matches_jax_on_cell_boundaries():
    """The same inserts (on cell boundaries, out of the box), serve
    signals, demotions and repack give the same staleness, rates,
    ``cell_ok``, policy decisions and stats."""
    rng = np.random.default_rng(3)
    qs = np.asarray(jsynth.synth_queries(jsynth.tweets_like(800, seed=1),
                                         2e-3, 60, seed=2))
    g = 5
    jg = jgrid.fit_grid(qs, g)
    tg = Grid(bbox=torch.from_numpy(np.array(jg.bbox)), g=g)
    fit = rng.uniform(size=g * g) < 0.7
    jm = jmonitor.FreshnessMonitor(jg, fit, window=3)
    tm = monitor.FreshnessMonitor(tg, fit, window=3)
    pol = dict(refit_chunk=2, repack_at=0.5, min_traffic=1.0,
               promote_after=1)
    jp, tp = jmonitor.DefaultPolicy(**pol), monitor.DefaultPolicy(**pol)
    pts = np.concatenate([_boundary_points(jg.bbox, g),
                          [[1e9, -1e9], [-5.0, 400.0]]])
    for seg in range(4):
        for m in (jm, tm):
            m.note_inserts(pts[seg::4])
        B = 64
        fields = dict(cell_id=rng.integers(-1, g * g, B).astype(np.int32),
                      guarded=rng.uniform(size=B) < 0.3,
                      mispredict=rng.uniform(size=B) < 0.4,
                      used_ai=rng.uniform(size=B) < 0.5,
                      delta_hits=rng.integers(0, 3, B).astype(np.int32))
        st = type("S", (), fields)
        tst = type("T", (), {k: torch.from_numpy(v)
                             for k, v in fields.items()})
        jm.note_serve(st)
        tm.note_serve(tst)
        jm.roll_segment()
        tm.roll_segment()
        dj = jp.decide(jm, delta_fill=seg * 30, delta_capacity=100)
        dt_ = tp.decide(tm, delta_fill=seg * 30, delta_capacity=100)
        _assert_tuple_equal(dt_, dj, f"segment {seg}: ")
        for m, d in ((jm, dj), (tm, dt_)):
            m.force_demote(d.demote)
            m.clear_demote(d.promote)
        if seg == 2:
            changed = rng.uniform(size=g * g) < 0.3
            jm.note_repack(changed=changed)
            tm.note_repack(changed=changed)
        np.testing.assert_array_equal(tm.stale, jm.stale)
        np.testing.assert_array_equal(tm.cell_ok(), jm.cell_ok())
        np.testing.assert_array_equal(tm.guard_array().numpy(),
                                      np.asarray(jm.guard_array()))
        for f in ("guarded", "mispredict", "used_ai", "delta_hits"):
            np.testing.assert_array_equal(tm.rolling(f), jm.rolling(f))
        assert tm.stats(7) == jm.stats(7)
    assert jm.span_stale.any() and (jm.stale > 0).sum() >= 5


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_spans_match_jax_across_repack():
    """Signatures, spans, the span diff and the label-map rename are
    equal before and after a repack (same points, same grid)."""
    pts = synth.crimes_like(3000, seed=4)
    base, extra = pts[:2700], pts[2700:]
    qs = synth.synth_queries(pts, 1e-3, 100, seed=5)
    jg = jgrid.fit_grid(qs, 6)
    tg = Grid(bbox=torch.from_numpy(np.array(jg.bbox)), g=6)
    js = jdelta.stage_inserts(jdelta.make_delta(512, base=2700), extra)
    ts = delta.stage_inserts(delta.make_delta(512, base=2700, device=CPU),
                             extra)
    jt0 = jdt.flatten(JRTree.str_bulk(base, max_entries=32))
    tt0 = dt.flatten(RTree.str_bulk(base, max_entries=32), device=CPU)
    _, jt1, jall, _ = jdelta.repack(base, js, max_entries=32)
    _, tt1, tall, _ = delta.repack(base, ts, max_entries=32)
    np.testing.assert_array_equal(tall, jall)
    sigs, sp = [], []
    for jt, tt in ((jt0, tt0), (jt1, tt1)):
        js_, ts_ = jspans.leaf_signatures(jt), spans.leaf_signatures(tt)
        assert ts_ == js_
        jsp, tsp = jspans.cell_spans(jt, jg), spans.cell_spans(tt, tg)
        assert tsp == jsp
        sigs.append(js_)
        sp.append(jsp)
    jch, jrm = jspans.diff_spans(sp[0], sp[1], sigs[0], sigs[1])
    tch, trm = spans.diff_spans(sp[0], sp[1], sigs[0], sigs[1])
    np.testing.assert_array_equal(tch, jch)
    np.testing.assert_array_equal(trm, jrm)
    assert jch.any() and (jrm >= 0).any()
    rng = np.random.default_rng(6)
    lm = rng.integers(0, len(sigs[0]), (36, 10)).astype(np.int32)
    lmk = rng.uniform(size=(36, 10)) < 0.7
    for a, b in zip(spans.remap_label_map(lm, lmk, trm),
                    jspans.remap_label_map(lm, lmk, jrm)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the mixed stream and the maintenance loop on the reference's kNN world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """``tests/test_delta.py``'s trained kNN world, fitted by the
    reference and bridged."""
    pts = jsynth.tweets_like(6000, seed=0)
    base, extra = pts[:5400], pts[5400:]
    jtree = jdt.flatten(JRTree.str_bulk(base, max_entries=32))
    qs = jsynth.synth_queries(pts, 2e-4, 300, seed=1)
    wl = jlabels.make_workload(jtree, qs)
    jh, rep = jbuild.fit_airtree(jtree, wl, kind="knn", grid_sizes=(6,))
    return dict(base=base, extra=extra, qs=qs, wl=wl, jh=jh, rep=rep,
                th=bridge.hybrid_from_reference(jh, device=CPU))


def _mixed(srv, w, mod, sort="hilbert", repack_every=400):
    return mod.serve_mixed_workload(srv, w["wl"].queries, w["extra"],
                                    batch=64, sort=sort, insert_every=1,
                                    repack_every=repack_every)


def _assert_mixed_equal(tm, jm):
    _assert_tuple_equal(tm.stats, jm.stats, "stats.")
    for f in ("n_queries", "n_batches", "n_reserved", "n_inserts",
              "n_repacks", "n_segments", "seg_bounds", "sort"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert len(tm.staged) == len(jm.staged)
    for a, b in zip(tm.staged, jm.staged):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def plain_streams(world):
    w = world
    jsrv = jmonitor.FreshServer(w["base"], w["jh"], **FRESH)
    tsrv = monitor.FreshServer(w["base"], w["th"], **FRESH)
    return _mixed(jsrv, w, jschedule), _mixed(tsrv, w, schedule), tsrv, jsrv


def test_mixed_stream_matches_jax(world, plain_streams):
    """``serve_mixed_workload`` over a ``FreshServer`` (guard, delta
    probe, two tiers, a scheduler repack): every stats field, the
    report's counters and the staged chunks equal the reference's."""
    jm, tm, tsrv, jsrv = plain_streams
    _assert_mixed_equal(tm, jm)
    assert tm.n_repacks >= 1 and int(tm.stats.delta_hits.sum()) > 0
    assert tsrv.stats() == jsrv.stats()


def test_mixed_stream_brute_force_and_order(world, plain_streams):
    """0 mismatches against brute force over each segment's visible
    points (counts everywhere, id sets on fitting rows), and arrival
    order serves the same rows as Hilbert order."""
    _, tm, _, _ = plain_streams
    w = world
    mism, id_mism, rows = serve.mixed_oracle(
        tm, w["base"], w["wl"].queries, CPU, np.arange(tm.n_queries))
    assert (mism, id_mism) == (0, 0) and rows > 250
    tsrv = monitor.FreshServer(w["base"], w["th"], **FRESH)
    arrival = _mixed(tsrv, w, schedule, sort="none")
    _assert_tuple_equal(arrival.stats, tm.stats, "arrival order: ")


def test_policy_loop_matches_jax(world):
    """``DefaultPolicy`` with the bridged ``FitState``: policy repacks
    (span diff, renames, invalidation) and refit chunks give the same
    decisions, ``RefitReport``s, monitor state, certificates, bank
    buffers and stream stats as the reference."""
    w = world
    pol = dict(refit_chunk=4, repack_at=0.25)
    jsrv = jmonitor.FreshServer(w["base"], w["jh"],
                                fit_state=w["rep"].fit_state,
                                policy=jmonitor.DefaultPolicy(**pol),
                                **FRESH)
    tsrv = monitor.FreshServer(
        w["base"], w["th"],
        fit_state=bridge.fit_state_from_reference(w["rep"].fit_state),
        policy=monitor.DefaultPolicy(**pol), **FRESH)
    jm = _mixed(jsrv, w, jschedule, repack_every=0)
    tm = _mixed(tsrv, w, schedule, repack_every=0)
    _assert_mixed_equal(tm, jm)
    assert len(tm.maintenance) == len(jm.maintenance)
    for (ts, td), (js, jd) in zip(tm.maintenance, jm.maintenance):
        assert ts == js
        _assert_tuple_equal(td, jd, f"decision {ts}: ")
    assert sum(d.repack for _, d in tm.maintenance) >= 2
    assert len(tsrv.refits) == len(jsrv.refits)
    for tr, jr in zip(tsrv.refits, jsrv.refits):
        assert dataclasses.replace(tr, train_seconds=0).__dict__ == \
            dataclasses.replace(jr, train_seconds=0).__dict__
    assert sum(r.cells_refit for r in tsrv.refits) > 0
    assert tsrv.stats() == jsrv.stats()
    for f in ("fit_ok", "stale", "span_stale", "forced_demote",
              "demoted_at"):
        np.testing.assert_array_equal(getattr(tsrv.monitor, f),
                                      getattr(jsrv.monitor, f), err_msg=f)
    np.testing.assert_array_equal(tsrv.hybrid.ait.cell_ok.numpy(),
                                  np.asarray(jsrv.hybrid.ait.cell_ok))
    tf, jf = tsrv.fit_state, jsrv.fit_state
    for f in ("exact", "exact_valid", "cell_stale"):
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f),
                                      err_msg=f)
    assert tf.spans == jf.spans and tf.sigs == jf.sigs
    assert all(np.array_equal(a, b) for a, b in zip(tf.true_rows,
                                                    jf.true_rows))
    for f in ("feats", "labels", "label_map", "lmask"):
        np.testing.assert_array_equal(
            getattr(tsrv.hybrid.ait.bank, f).numpy(),
            np.asarray(getattr(jsrv.hybrid.ait.bank, f)), err_msg=f)
    np.testing.assert_array_equal(tsrv.points, jsrv.points)
    np.testing.assert_array_equal(tsrv.hybrid.tree.leaf_entry_ids.numpy(),
                                  np.asarray(jsrv.hybrid.tree.leaf_entry_ids))


def test_one_segment_stream_stages_inserts(world):
    """A stream that fits in one segment stages its inserts after the
    stream; no query of it sees them."""
    w = world
    tsrv = monitor.FreshServer(w["base"], w["th"], **FRESH)
    q = w["wl"].queries[:64]
    mixed = schedule.serve_mixed_workload(tsrv, q, w["extra"][:40],
                                          batch=64, sort="none",
                                          insert_every=8)
    assert mixed.n_segments == 1
    assert mixed.n_inserts == 40 and tsrv.delta_fill == 40
    assert not mixed.stats.delta_hits.any()
    plain = hybrid_query(w["th"], torch.from_numpy(q), max_visited=64,
                         max_results=256)
    np.testing.assert_array_equal(mixed.stats.n_results,
                                  plain.n_results.numpy())


# ---------------------------------------------------------------------------
# the port's own builds
# ---------------------------------------------------------------------------

def test_fit_airtree_knn_matches_jax(world):
    """``fit_airtree(kind="knn")`` on the port's copy of the tree gives
    the reference's bank, guard and ``FitState``."""
    w = world
    ttree = dt.flatten(RTree.str_bulk(w["base"], max_entries=32),
                       device=CPU)
    wl = labels.make_workload(ttree, w["qs"])
    th, trep = build.fit_airtree(ttree, wl, kind="knn", grid_sizes=(6,))
    jh, jrep = w["jh"], w["rep"]
    for f in ("feats", "labels", "label_map", "lmask"):
        np.testing.assert_array_equal(getattr(th.ait.bank, f).numpy(),
                                      np.asarray(getattr(jh.ait.bank, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(th.ait.cell_ok.numpy(),
                                  np.asarray(jh.ait.cell_ok))
    assert trep.exact_fit == jrep.exact_fit
    tf, jf = trep.fit_state, jrep.fit_state
    for f in ("queries", "exact", "exact_valid", "cell_ids", "cell_valid",
              "overflow", "cell_stale"):
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f),
                                      err_msg=f)
    assert (tf.qp, tf.cl, tf.kind) == (jf.qp, jf.cl, jf.kind)
    assert tf.spans == jf.spans and tf.sigs == jf.sigs
    assert all(np.array_equal(a, b) for a, b in zip(tf.true_rows,
                                                    jf.true_rows))


def test_own_mlp_world_policy_exact_and_ai_returns():
    """The port's own MLP world (Guttman tree, MLP bank trained by the
    port) under ``--policy default`` with inserts in one corner: exact
    against per-segment brute force, refit chunks run, and after a final
    repack and ``refit_cells`` of every stale cell the AI path answers
    again, still exactly."""
    pts = synth.tweets_like(2500, seed=7)
    tree = dt.flatten(RTree(max_entries=32).insert_all(pts), device=CPU)
    qs = synth.synth_queries(pts, 5e-4, 160, seed=8)
    wl = labels.make_workload(tree, qs)
    hyb, rep = build.fit_airtree(tree, wl, kind="mlp", grid_sizes=(4,),
                                 mlp_hidden=16, mlp_epochs=600)
    assert rep.cell_fit.any()
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    rng = np.random.default_rng(9)
    ins = (lo + 0.02 * (hi - lo)
           + np.abs(rng.normal(0, 0.004, (120, 2)))).astype(np.float32)
    srv = monitor.FreshServer(pts, hyb, delta_cap=256, max_visited=64,
                              max_results=256, fit_state=rep.fit_state,
                              policy=monitor.DefaultPolicy(repack_at=0.1))
    stream = np.tile(qs, (2, 1))
    mixed = schedule.serve_mixed_workload(srv, stream, ins, batch=40,
                                          insert_every=1)
    assert sum(d.repack for _, d in mixed.maintenance) >= 1
    assert sum(r.cells_refit for r in srv.refits) > 0
    mism, _, _ = serve.mixed_oracle(mixed, pts, stream, CPU)
    assert mism == 0
    srv.repack()
    srv.refit_cells()
    assert not srv.fit_state.cell_stale.any()
    out = srv.serve(torch.from_numpy(qs))
    allp = np.concatenate([pts, ins]).astype(np.float32)
    want = np_contains_point(qs[:, None, :], allp[None]).sum(1)
    np.testing.assert_array_equal(out.n_results.numpy(), want)
    assert out.used_ai.numpy().any(), "refit must restore AI service"


def test_serve_main_mixed_knn(capsys):
    """``launch.serve --insert-rate --classifier knn`` on the CPU ends
    with a clean per-segment oracle."""
    serve.main(["--device", "cpu", "--points", "3000", "--queries", "300",
                "--batch", "64", "--node-capacity", "32",
                "--insert-rate", "0.05", "--classifier", "knn",
                "--insert-every", "1", "--repack-every", "100",
                "--policy", "default"])
    out = capsys.readouterr().out.strip().splitlines()
    assert any(ln.startswith("# policy:") for ln in out)
    assert out[-1].startswith("# oracle: 0 / 300 ")
