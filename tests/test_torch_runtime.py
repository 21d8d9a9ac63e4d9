"""The port's open-loop runtime and arrival processes against the JAX
package, on the CPU.

Arrival stamps are host numpy on a seed, so ``make_arrivals`` is
bit-equal for every kind. ``run_stream`` runs with an injected
``service_time`` model (never the wall clock), so its clock, its batch
formation and its tier decisions are deterministic: on the reference's
kNN world (2500 ``tweets_like`` points, 150 queries at selectivity 3e-3
so that a third of them overflow a narrow bound of 2 leaves, a 4×4
grid), carried across with
``repro_torch.bridge``, the port's ``RuntimeReport`` equals the
reference's field for field — stats, completion stamps, degraded and
missed rows, batch counts and the telemetry quantiles. When no deadline
fires it equals the port's closed-loop ``serve_workload``, and every
row that is not degraded is exact against brute-force containment.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import build as jbuild, device_tree as jdt  # noqa: E402
from repro.core import labels as jlabels  # noqa: E402
from repro.core import runtime as jruntime  # noqa: E402
from repro.core.hybrid import hybrid_query as j_hybrid  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.data import arrivals as jarrv, synth as jsynth  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import runtime, schedule  # noqa: E402
from repro_torch.core.geometry import np_contains_point  # noqa: E402
from repro_torch.core.hybrid import hybrid_query  # noqa: E402
from repro_torch.data import arrivals  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

CPU = "cpu"
BATCH, MV, MR, WF = 32, 2, 256, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def service_time(n_valid, tier):
    """The injected clock: a fixed cost per step plus a cost per row."""
    return (2e-3 + 1e-5 * n_valid) if tier == "narrow" \
        else (6e-3 + 2e-5 * n_valid)


CAPACITY = BATCH / (service_time(BATCH, "narrow")
                    + service_time(BATCH, "wide"))
STEP = service_time(BATCH, "narrow") + service_time(BATCH, "wide")


@pytest.fixture(scope="module")
def world():
    """The reference's kNN world, its bridged port, and both packages'
    narrow/wide ``hybrid_query`` steps (narrow ``max_visited`` 2, so rows
    overflow onto the wide tier)."""
    pts = jsynth.tweets_like(2500, seed=0)
    jtree = jdt.flatten(JRTree(max_entries=32).insert_all(pts))
    qs = jsynth.synth_queries(pts, 3e-3, 150, seed=1)
    wl = jlabels.make_workload(jtree, qs)
    jh, _ = jbuild.fit_airtree(jtree, wl, kind="knn", grid_sizes=(4,))
    th = bridge.hybrid_from_reference(jh, device=CPU)
    jn = jax.jit(lambda x: j_hybrid(jh, x, max_visited=MV, max_results=MR))
    jw = jax.jit(lambda x: j_hybrid(jh, x, max_visited=MV * WF,
                                    max_results=MR * WF))

    def tn(x):
        return hybrid_query(th, x, max_visited=MV, max_results=MR)

    def tw(x):
        return hybrid_query(th, x, max_visited=MV * WF, max_results=MR * WF)
    return dict(pts=pts, q=wl.queries, jn=jn, jw=jw, tn=tn, tw=tw)


def _port(w, arr, deadline_s, formation, sort="hilbert"):
    return runtime.run_stream(
        w["tn"], w["q"], arr, batch=BATCH, deadline_s=deadline_s, sort=sort,
        wide_fn=w["tw"], trunc_field="truncated", formation=formation,
        service_time=service_time, device=CPU)


def _assert_reports_equal(got, want):
    for f in want.stats._fields:
        np.testing.assert_array_equal(getattr(got.stats, f),
                                      np.asarray(getattr(want.stats, f)),
                                      err_msg=f"stats.{f}")
    for f in ("n_queries", "n_batches", "n_wide_batches", "n_degraded",
              "n_missed", "goodput", "mean_fill", "formation", "sort"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("arrival_s", "done_s", "latency_s", "degraded", "missed"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.telemetry == want.telemetry


# ---------------------------------------------------------------------------
# arrivals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_arrivals_matches_reference(kind, seed):
    """Generated stamps bit-equal for each kind and seed."""
    got = arrivals.make_arrivals(kind, 1000, 250.0, seed=seed)
    want = jarrv.make_arrivals(kind, 1000, 250.0, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64 and np.all(np.diff(got) >= 0)


@pytest.mark.parametrize("stamps,n,rate", [
    ([0.5, 0.1, 0.9, 0.3], None, None),      # unsorted, rebased
    ([0.5, 0.1, 0.9, 0.3], 10, 40.0),        # tiled and rescaled
    ([2.0], 3, None),                        # one arrival tiles on its gap
    ([1.0, 1.0, 1.0], 7, None),              # duplicate stamps
    ([], None, None),                        # empty trace, empty stream
])
@pytest.mark.parametrize("suffix", [".npy", ".txt"])
def test_trace_arrivals_match_reference(tmp_path, stamps, n, rate, suffix):
    """A saved trace replays to the same stamps through both packages'
    ``make_arrivals("trace")`` / ``load_trace``."""
    path = str(tmp_path / f"trace{suffix}")
    arrivals.save_trace(path, np.asarray(stamps, np.float64))
    got = arrivals.load_trace(path, n=n, rate=rate)
    np.testing.assert_array_equal(got, jarrv.load_trace(path, n=n,
                                                        rate=rate))
    if n is not None:
        np.testing.assert_array_equal(
            arrivals.make_arrivals("trace", n, rate or 0.0, trace=path),
            jarrv.make_arrivals("trace", n, rate or 0.0, trace=path))


# ---------------------------------------------------------------------------
# run_stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("formation,load,deadline,kind", [
    ("deadline", 1.5, 6.0, "poisson"),   # over capacity, auto deadline
    ("full", 1.5, 6.0, "poisson"),       # fixed-full-batch baseline
    ("deadline", 3.0, 0.8, "bursty"),    # tight: rows degrade, miss
    ("full", 0.5, 0.8, "poisson"),       # underload, tight deadline
])
def test_run_stream_matches_reference(world, formation, load, deadline,
                                      kind):
    """Same world, arrivals and injected clock → the same report, field
    for field (deadlines in multiples of one narrow + wide step)."""
    arr = arrivals.make_arrivals(kind, len(world["q"]), load * CAPACITY,
                                 seed=3)
    want = jruntime.run_stream(
        world["jn"], world["q"], arr, batch=BATCH,
        deadline_s=deadline * STEP, sort="hilbert", wide_fn=world["jw"],
        trunc_field="truncated", formation=formation,
        service_time=service_time)
    got = _port(world, arr, deadline * STEP, formation)
    _assert_reports_equal(got, want)
    assert got.n_wide_batches + got.n_degraded > 0


def test_tight_deadline_degrades_rows(world):
    """The tight bursty case degrades some rows and leaves others exact:
    every non-degraded row matches brute-force containment, and every
    degraded row keeps its truncation flag (flagged, never dropped)."""
    arr = arrivals.make_arrivals("bursty", len(world["q"]), 3.0 * CAPACITY,
                                 seed=3)
    rep = _port(world, arr, 0.8 * STEP, "deadline")
    assert 0 < rep.n_degraded < rep.n_queries
    assert rep.stats.truncated[rep.degraded].all()
    want = np_contains_point(world["q"][:, None, :],
                             world["pts"].astype(np.float32)[None]).sum(1)
    ok = ~rep.degraded
    np.testing.assert_array_equal(rep.stats.n_results[ok], want[ok])
    assert (rep.stats.n_results[~ok] <= want[~ok]).all()
    assert np.all(rep.done_s > rep.arrival_s)


@pytest.mark.parametrize("formation", ["deadline", "full"])
@pytest.mark.parametrize("sort", ["hilbert", "none"])
def test_run_stream_equals_serve_workload_without_deadlines(
        world, formation, sort):
    """No deadline fires → the open-loop rows equal the closed-loop
    scheduler's, field for field (only the grouping into batches
    differs), and no row degrades or misses."""
    arr = arrivals.make_arrivals("poisson", len(world["q"]), CAPACITY,
                                 seed=1)
    rep = _port(world, arr, 1e9, formation, sort=sort)
    closed = schedule.serve_workload(
        world["tn"], world["q"], batch=BATCH, sort=sort, wide_fn=world["tw"],
        trunc_field="truncated", device=CPU)
    for f in closed.stats._fields:
        np.testing.assert_array_equal(getattr(rep.stats, f),
                                      getattr(closed.stats, f), err_msg=f)
    assert rep.n_degraded == rep.n_missed == 0 and rep.goodput == 1.0
    assert rep.n_wide_batches > 0


def test_run_stream_batch_of_one(world):
    """Batch 1: every query is its own dispatch, rows still equal."""
    q = world["q"][:20]
    arr = arrivals.make_arrivals("poisson", len(q), 50.0, seed=2)
    rep = runtime.run_stream(world["tn"], q, arr, batch=1, deadline_s=1e9,
                             wide_fn=world["tw"], trunc_field="truncated",
                             service_time=service_time, device=CPU)
    closed = schedule.serve_workload(world["tn"], q, batch=1,
                                     wide_fn=world["tw"], device=CPU)
    np.testing.assert_array_equal(rep.stats.n_results,
                                  closed.stats.n_results)
    assert rep.n_batches == len(q) and rep.mean_fill == 1.0


@pytest.mark.parametrize("kw,match", [
    (dict(formation="eager"), "formation"),
    (dict(arr=np.array([0.2, 0.1])), "sorted"),
    (dict(arr=np.array([0.1])), "shape"),
    (dict(batch=0), "batch"),
])
def test_run_stream_rejects_bad_input(world, kw, match):
    q = world["q"][:2]
    args = dict(arr=np.array([0.1, 0.2]), batch=4, formation="deadline")
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        runtime.run_stream(world["tn"], q, args["arr"], batch=args["batch"],
                           deadline_s=1.0, formation=args["formation"],
                           service_time=service_time, device=CPU)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

ARGV = ["--device", "cpu", "--points", "3000", "--queries", "300",
        "--batch", "64", "--node-capacity", "32", "--classifier", "knn"]


@pytest.mark.parametrize("formation", ["deadline", "full"])
def test_serve_main_open_loop(capsys, formation):
    """``--arrival poisson`` serves the range stream open-loop on the CPU
    and closes with the no-drop oracle at 0 mismatches (the oracle does
    not depend on the clock: a non-degraded row is exact whatever its
    latency)."""
    serve.main(ARGV + ["--arrival", "poisson", "--formation", formation])
    out = capsys.readouterr().out
    for line in ("# open loop: poisson arrivals", "# latency: p50",
                 "# goodput:"):
        assert line in out
    assert "non-degraded n_results mismatches vs workload labels" in out
    oracle = [ln for ln in out.splitlines() if ln.startswith("# oracle")]
    assert oracle and "; 0 / " in oracle[0]


def test_serve_rejects_open_loop_for_other_query_types():
    with pytest.raises(SystemExit):
        serve.parse_args(ARGV + ["--query-type", "knn", "--arrival",
                                 "poisson"])
