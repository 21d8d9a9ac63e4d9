"""The port's serving engine past one rank, on the CPU, against the JAX
package's sharded engine at the same mesh.

The port's ranks are subprocesses (``tests/helpers/torch_mesh.py``): each
joins a ``gloo`` group through a ``file://`` rendezvous under the test's
temporary directory, so this worker never initialises a process group,
changes its environment or its JAX device count. One spawn a world size
runs every case: world 2 (a 1×2 mesh, ``data`` × ``model``), 3 (1×3) and
4 (2×2), all three started before the reference runs.

The reference's engine is its stage bodies (``_r_path``, ``_ai_path``,
``_delta_path``, ``_route_combine``) under ``jax.vmap`` with the axis
names ``data`` and ``model`` over the padded hybrid's shards stacked by
``tree_shardings_p``: ``psum``, ``pmax``, ``all_gather(tiled=True)`` and
``axis_index`` act over a vmapped axis as over a ``shard_map``'s, and
the body sees each shard's arrays, as under ``shard_map``. It is jitted
with the tree an argument, as ``tests/test_torch_engine.py`` jits the
one-rank step. The world is that file's: 2500 ``tweets_like`` points
and the three banks fitted by the reference. Integer and bool fields
must be bit-equal, dtypes included; MLP rows with a cell-slot score
within 1e-5 of the threshold are reported, not compared.
"""
import dataclasses
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import build as jbuild, device_tree as jdt  # noqa: E402
from repro.core import engine as jeng, grid as jgrid  # noqa: E402
from repro.core import labels as jlabels, monitor as jmonitor  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core.aitree import cell_slot_probs as j_probs  # noqa: E402
from repro.core.rtree import RTree as JRTree  # noqa: E402
from repro.data import synth as jsynth  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.core import engine, monitor, schedule  # noqa: E402
from repro_torch.core.device_tree import build_walk_pack  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from helpers.torch_mesh import ROOT, Ranks  # noqa: E402

CPU = "cpu"
NEAR = 1e-5
KINDS = ("knn", "mlp", "forest")
UNIONS = ("topk", "pmax")
FITS = {"knn": dict(grid_sizes=(6,)),
        "mlp": dict(grid_sizes=(4,), mlp_hidden=16, mlp_epochs=800),
        "forest": dict(grid_sizes=(4,))}
MESHES = {2: (1, 2), 3: (1, 3), 4: (2, 2)}
SERVE = [(k, u, d) for k in KINDS for u in UNIONS for d in (False, True)]
FRESH_POLICY = dict(refit_chunk=4, repack_at=0.25)
FRESH_KW = dict(delta_cap=512, wide_factor=8)
FRESH_RUN = dict(batch=32, sort="hilbert", insert_every=1)


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


# ---------------------------------------------------------------------------
# the reference's sharded engine under vmap
# ---------------------------------------------------------------------------

def _model_dim(spec):
    return tuple(spec).index("model") if "model" in tuple(spec) else None


def _stack_shards(h_p, n_model: int):
    """``(stacked, in_axes)``: every leaf of the padded hybrid that
    ``tree_shardings_p`` splits over ``model``, cut into its ``n_model``
    shards and stacked on a new axis 0 (in_axes 0); the rest as it is
    (in_axes None)."""
    spec = jeng.tree_shardings_p(h_p, "model")

    def is_spec(x):
        return isinstance(x, P)

    def stack(s, x):
        d = _model_dim(s)
        return x if d is None else jnp.stack(jnp.split(x, n_model, axis=d))
    stacked = jax.tree.map(stack, spec, h_p, is_leaf=is_spec)
    axes = jax.tree.map(lambda s: None if _model_dim(s) is None else 0,
                        spec, is_leaf=is_spec)
    return stacked, axes


class RefEngine:
    """The reference's serve steps at a ``(n_data, n_model)`` mesh, a list
    of ``(cfg, delta)`` variants compiled together: ``(padded hybrid,
    [queries [B, 4] a variant], delta_xy) → [ServeStats a variant]``
    (the model replicas checked equal)."""

    def __init__(self, variants, kind: str, mesh_shape):
        self.variants, self.kind = variants, kind
        self.nd, self.nm = mesh_shape
        self._jit = {}

    def _body(self, h, qs, xy):
        outs = []
        for (cfg, delta), q in zip(self.variants, qs):
            rp = jeng._r_path(h, q, cfg, "model")
            ap = jeng._ai_path(h, q, cfg, self.kind, "model", self.nm)
            d = jeng._delta_path(q, xy, cfg) if delta else None
            outs.append(jeng._route_combine(h, q, rp, ap, d))
        return outs

    def __call__(self, h_p, qs, xy=None):
        stacked, axes = _stack_shards(h_p, self.nm)
        key = jax.tree.structure(axes, is_leaf=lambda x: x is None)
        if key not in self._jit:
            inner = jax.vmap(self._body, in_axes=(axes, None, None),
                             axis_name="model")
            self._jit[key] = jax.jit(jax.vmap(
                inner, in_axes=(None, 0, None), axis_name="data"))
        qs = [jnp.asarray(q).reshape(self.nd, -1, 4) for q in qs]
        xy = jnp.zeros((1, 2), jnp.float32) if xy is None else \
            jnp.asarray(xy)
        outs = []
        for out in self._jit[key](stacked, qs, xy):
            fields = []
            for f in out:
                f = np.asarray(f)                   # [nd, nm, B / nd]
                assert (f == f[:, :1]).all(), "model replicas differ"
                fields.append(f[:, 0].reshape(-1))
            outs.append(type(out)(*fields))
        return outs


def ref_step(cfg, kind: str, mesh_shape):
    """One ``(cfg, delta=True)`` variant as a step ``(padded hybrid,
    queries, delta_xy) → ServeStats``, the reference server's shape."""
    eng = RefEngine([(cfg, True)], kind, mesh_shape)
    return lambda h_p, q, xy: eng(h_p, [q], xy)[0]


# ---------------------------------------------------------------------------
# the worlds, and one spawn a world size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """The reference's tree, workload and three fitted banks, bridged; a
    query batch with edge rows; a staged insert buffer; point queries."""
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
    q = np.concatenate([wl.queries[:62], [np.concatenate([lo, hi])],
                        [[500, 500, 501, 501]]]).astype(np.float32)
    xy = np.full((512, 2), np.inf, np.float32)
    xy[:300] = jsynth.tweets_like(300, seed=5)
    xy[:4] = q[0, [[0, 1], [2, 3], [0, 3], [2, 1]]]
    p = pts[np.random.default_rng(5).integers(0, len(pts), 64)]
    q_point = np.concatenate([p, p], axis=1).astype(np.float32)
    return dict(pts=pts, wl=wl, jh=jh, th=th, q=q, xy=xy, q_point=q_point)


@pytest.fixture(scope="module")
def fresh_world():
    """``tests/test_torch_engine.py``'s mixed-stream world: a kNN bank on
    2250 bulk-loaded points, the other 250 staged as inserts; port
    copies of the ``FitState`` taken before any reference server runs."""
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


@pytest.fixture(scope="module")
def reference(world):
    """``reference(kind, n)``: the reference's engine at world ``n``'s
    mesh on the world's batches, every serve variant and the point step
    compiled together, keyed as the ranks' results are."""
    cache = {}

    def get(kind, n):
        if (kind, n) not in cache:
            keys = [("serve", kind, u, d) for u in UNIONS
                    for d in (False, True)] + [("point", kind)]
            variants = [(jeng.EngineConfig(max_visited=16, score_union=u), d)
                        for _, _, u, d in keys[:-1]]
            variants.append((jeng.point_config(jeng.EngineConfig()), False))
            h_p = jeng.pad_tree_for_sharding(world["jh"][kind], MESHES[n][1])
            outs = RefEngine(variants, kind, MESHES[n])(
                h_p, [world["q"]] * 4 + [world["q_point"]], world["xy"])
            cache[(kind, n)] = dict(zip(keys, outs))
        return cache[(kind, n)]
    return get


class _Joined(dict):
    """World size → its ranks' results, each spawn joined on first use."""

    def __init__(self, running: dict):
        super().__init__()
        self.running = running

    def __missing__(self, n):
        self[n] = self.running[n].wait()
        return self[n]


@pytest.fixture(scope="module")
def ranks(world, fresh_world, tmp_path_factory):
    """Each world size's ranks' results: every serve, point and two-tier
    case, and at world 2 the mixed stream through ``EngineFreshServer``.
    All three spawns start at once and run while the reference does."""
    fw = fresh_world
    running = {}
    for n, shape in MESHES.items():
        job = dict(mesh=shape, hybrids=world["th"], q=world["q"],
                   xy=world["xy"], q_point=world["q_point"],
                   stream=world["wl"].queries, max_visited=16,
                   serve=SERVE, point=KINDS, two_tier=KINDS)
        if n == 2:
            job["fresh"] = dict(
                base=fw["base"], hybrid=fw["th"], kind="knn",
                cfg=dict(max_visited=1), fit_state=fw["fits"][0],
                policy=FRESH_POLICY, kw=FRESH_KW, queries=fw["qs"],
                inserts=fw["extra"], run=FRESH_RUN)
        running[n] = Ranks(job, n, tmp_path_factory.mktemp(f"world{n}"))
    yield _Joined(running)
    for r in running.values():
        r.stop()


# ---------------------------------------------------------------------------
# shard_for_rank
# ---------------------------------------------------------------------------

def _port_leaves(obj, path=""):
    """``(path, tensor)`` of every tensor field of a (nested) dataclass."""
    if torch.is_tensor(obj):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _port_leaves(getattr(obj, f.name), f"{path}/{f.name}")
    elif isinstance(obj, tuple):
        for i, v in enumerate(obj):
            yield from _port_leaves(v, f"{path}/{i}")


@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_shard_for_rank_matches_reference(world, kind, n_shards):
    """Each rank's shard of the padded hybrid equals the reference's
    padded hybrid sliced as ``tree_shardings_p`` splits it, field by
    field (the walk pack aside); the local walk pack is
    ``build_walk_pack`` of the local levels, with empty child ranges for
    internal nodes whose children live on another rank."""
    jp = jeng.pad_tree_for_sharding(world["jh"][kind], n_shards)
    stacked, _ = _stack_shards(jp, n_shards)
    spec = jeng.tree_shardings_p(jp, "model")
    tp = engine.pad_tree_for_sharding(world["th"][kind], n_shards)
    for r in range(n_shards):
        sh = engine.shard_for_rank(tp, engine.ModelAxis(index=r,
                                                        size=n_shards))
        want = dict(_port_leaves(jax.tree.map(
            lambda s, x: torch.from_numpy(np.array(
                x if _model_dim(s) is None else x[r])),
            spec, stacked, is_leaf=lambda x: isinstance(x, P))))
        got = {p: t for p, t in _port_leaves(sh)
               if not p.startswith("/tree/wpack")}
        assert got.keys() == want.keys()
        for p, w in want.items():
            assert got[p].dtype == w.dtype, p
            np.testing.assert_array_equal(_np(got[p]), _np(w), err_msg=p)
        levels, wp = sh.tree.levels, sh.tree.wpack
        assert wp.level_sizes[-1] == tp.tree.n_leaves // n_shards
        built = build_walk_pack([lv.mbrs for lv in levels],
                                [lv.parent for lv in levels])
        for f in ("int_mbrs", "int_parents", "child_ranges"):
            assert torch.equal(getattr(wp, f), getattr(built, f)), f
        assert (wp.offsets, wp.level_sizes) == (built.offsets,
                                                built.level_sizes)
        rng = _np(wp.child_ranges[wp.offsets[-2]:])
        assert (rng[:, 1] - rng[:, 0]).sum() == levels[-1].mbrs.shape[0]
        assert (rng[:, 1] == rng[:, 0]).any(), \
            "no internal node has its children on another rank"


def test_shard_for_rank_needs_padding(world):
    """An unpadded hybrid whose leaves do not split evenly raises."""
    th = world["th"]["knn"]
    n = next(n for n in (3, 5, 7) if th.tree.n_leaves % n)
    with pytest.raises(ValueError, match="pad_tree_for_sharding"):
        engine.shard_for_rank(th, engine.ModelAxis(index=0, size=n))


# ---------------------------------------------------------------------------
# the steps over the mesh against the reference's sharded engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", sorted(MESHES))
@pytest.mark.parametrize("kind,union,delta", SERVE)
def test_serve_step_over_mesh_matches_reference(world, ranks, reference,
                                                kind, union, delta, n):
    """Every ``ServeStats`` field of the serve step over the mesh equals
    the reference's engine at the same mesh, per bank, score union and
    insert buffer, on every rank."""
    jh, q = world["jh"][kind], world["q"]
    want = reference(kind, n)[("serve", kind, union, delta)]
    skip = _near_rows(jh, q, jeng.EngineConfig().max_cells)
    for r, out in enumerate(ranks[n]):
        _assert_fields_equal(out[("serve", kind, union, delta)], want, skip,
                             msg=f"rank {r}: ")
    got = ranks[n][0][("serve", kind, union, delta)]
    assert got.r_truncated.any() and got.used_ai.any()
    assert got.delta_hits.any() == delta


@pytest.mark.parametrize("n", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_point_step_over_mesh_matches_reference(world, ranks, reference,
                                                kind, n):
    """The point step over the mesh: every field equal to the
    reference's at the same mesh on every rank, nothing truncated."""
    jh, q = world["jh"][kind], world["q_point"]
    want = reference(kind, n)[("point", kind)]
    for r, out in enumerate(ranks[n]):
        _assert_fields_equal(out[("point", kind)], want,
                             _near_rows(jh, q, 1), msg=f"rank {r}: ")
    got = ranks[n][0][("point", kind)]
    assert not got.r_truncated.any() and (got.n_results >= 1).all()


@pytest.mark.parametrize("n", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
def test_two_tier_stream_over_mesh(world, ranks, kind, n):
    """The two-tier stream over the mesh: the narrow tier's
    ``r_truncated`` rows are re-served wide, no truncation is left, the
    counts equal the workload's labels on every rank, and the rows the
    narrow tier did not flag keep its stats."""
    wl = world["wl"]
    for out in ranks[n]:
        first, rep = out[("two_tier", kind)]
        trunc = first.stats.r_truncated
        assert trunc.any(), "fixture too weak: nothing overflowed"
        assert rep.n_reserved == int(trunc.sum())
        assert not rep.stats.r_truncated.any()
        np.testing.assert_array_equal(rep.stats.n_results, wl.n_results)
        for f in rep.stats._fields:
            np.testing.assert_array_equal(getattr(rep.stats, f)[~trunc],
                                          getattr(first.stats, f)[~trunc],
                                          err_msg=f)


# ---------------------------------------------------------------------------
# EngineFreshServer over a 1x2 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fresh_reference(fresh_world):
    """The reference's ``EngineFreshServer`` at ``n_model=2`` (its steps
    the vmapped sharded engine) and the port's one-rank server, on the
    mixed stream."""
    w = fresh_world
    jcfg = jeng.EngineConfig(max_visited=1)
    jsrv = jmonitor.EngineFreshServer(
        w["base"], w["jh"], jax.make_mesh((1, 1, 1), ("pod", "data",
                                                      "model")),
        jcfg, kind="knn", n_model=2, fit_state=w["rep"].fit_state,
        policy=jmonitor.DefaultPolicy(**FRESH_POLICY), **FRESH_KW)
    jsrv._jnarrow = ref_step(jcfg, "knn", (1, 2))
    jsrv._jwide = ref_step(jeng.wide_config(jcfg, FRESH_KW["wide_factor"]),
                           "knn", (1, 2))
    jm = jschedule.serve_mixed_workload(jsrv, w["qs"], w["extra"],
                                        **FRESH_RUN)
    tsrv = monitor.EngineFreshServer(
        w["base"], w["th"], engine.EngineConfig(max_visited=1), kind="knn",
        fit_state=w["fits"][1], policy=monitor.DefaultPolicy(**FRESH_POLICY),
        **FRESH_KW)
    tm = schedule.serve_mixed_workload(tsrv, w["qs"], w["extra"],
                                       **FRESH_RUN)
    return dict(jsrv=jsrv, jm=jm, tm=tm)


def test_engine_fresh_server_over_mesh_matches_reference(ranks,
                                                         fresh_reference):
    """Inserts, policy repacks, refit chunks and ``on_segment`` over a
    1×2 mesh: every served ``ServeStats`` field, the report's counters,
    the decisions, the refit reports and ``stats()`` equal the
    reference's ``EngineFreshServer`` at ``n_model=2``, on both ranks;
    ``n_results`` equals the port's one-rank server's."""
    jsrv, jm = fresh_reference["jsrv"], fresh_reference["jm"]
    for r, out in enumerate(ranks[2]):
        tm = out["fresh"]["mixed"]
        _assert_fields_equal(tm.stats, jm.stats, msg=f"rank {r}: stats.")
        for f in ("n_queries", "n_batches", "n_reserved", "n_inserts",
                  "n_repacks", "n_segments", "seg_bounds"):
            assert getattr(tm, f) == getattr(jm, f), f
        assert len(tm.maintenance) == len(jm.maintenance)
        for (ts, td), (js, jd) in zip(tm.maintenance, jm.maintenance):
            assert ts == js
            for f in jd._fields:
                np.testing.assert_array_equal(getattr(td, f), getattr(jd, f),
                                              err_msg=f"decision {ts}: {f}")
        assert [dataclasses.replace(x, train_seconds=0).__dict__
                for x in out["fresh"]["refits"]] == \
            [dataclasses.replace(x, train_seconds=0).__dict__
             for x in jsrv.refits]
        assert tuple(out["fresh"]["stats"]) == tuple(jsrv.stats())
    tm = ranks[2][0]["fresh"]["mixed"]
    assert sum(d.repack for _, d in tm.maintenance) >= 1
    assert sum(x.cells_refit for x in ranks[2][0]["fresh"]["refits"]) > 0
    assert int(tm.stats.delta_hits.sum()) > 0
    assert tm.n_reserved > 0 and not tm.stats.r_truncated.any()
    np.testing.assert_array_equal(tm.stats.n_results,
                                  fresh_reference["tm"].stats.n_results)


def test_engine_fresh_server_ranks_agree(ranks):
    """After every maintenance step both ranks hold the same hybrid
    (tree, bank, ``cell_ok``), and different shards of it."""
    a, b = (out["fresh"]["digests"] for out in ranks[2])
    assert len(a) == len(b) > 0
    assert [h for h, _ in a] == [h for h, _ in b]
    assert all(sa != sb for (_, sa), (_, sb) in zip(a, b))


@pytest.mark.parametrize("n", sorted(MESHES))
def test_ranks_hold_the_same_results(ranks, n):
    """Every rank holds the whole batch's stats: all ranks' results are
    equal, case by case."""
    def stats(key, val):
        return [r.stats for r in val] if key[0] == "two_tier" else [val]
    first = ranks[n][0]
    for r, out in enumerate(ranks[n][1:], 1):
        assert out.keys() == first.keys()
        for key in out.keys() - {"fresh", "launches"}:
            for a, b in zip(stats(key, out[key]), stats(key, first[key])):
                _assert_fields_equal(a, b, msg=f"rank {r} {key}: ")


# ---------------------------------------------------------------------------
# the axis and the mesh without a group; the driver under torch.distributed
# ---------------------------------------------------------------------------

def test_mesh_needs_an_initialised_group():
    """``make_debug_mesh`` and a model axis past one rank refuse to run
    without a process group; the reference driver's mesh shapes and the
    batch axes hold."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        meshlib.make_debug_mesh(1, 2)
    with pytest.raises(RuntimeError, match="process group"):
        engine.model_axis(3)
    assert [meshlib.serve_mesh_shape(n) for n in (1, 2, 3, 4, 8)] == \
        [(1, 1), (1, 2), (1, 3), (2, 2), (4, 2)]
    one = meshlib.Mesh(shape=(1, 1), rank=0, model=engine.ONE_RANK,
                       data=engine.ONE_RANK, device=torch.device(CPU))
    assert meshlib.batch_axes(one) == ("data",)


DRIVER = ["--device", "cpu", "--points", "2000", "--queries", "256",
          "--batch", "64", "--reps", "1", "--node-capacity", "32",
          "--classifier", "knn", "--distributed"]
STREAMS = {"range": [], "point": ["--query-type", "point"],
           "mixed": ["--insert-rate", "0.05", "--insert-every", "1",
                     "--repack-every", "100", "--policy", "default"],
           "open loop": ["--arrival", "poisson"]}


def _oracle(text: str) -> str:
    lines = [ln for ln in text.splitlines() if ln.startswith("# oracle:")]
    assert len(lines) == 1, text[-3000:]
    return lines[0]


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.serve --distributed --device cpu`` at toy scale,
    one run a stream, all four at once (each in a session of its own,
    stopped at its time limit)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    procs = {}
    for name, extra in STREAMS.items():
        log = tmp_path_factory.mktemp("driver") / "out.log"
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "2", "-m",
                 "repro_torch.launch.serve", *DRIVER, *extra],
                env=env, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                start_new_session=True), log)
    out = {}
    for name, (p, log) in procs.items():
        try:
            p.wait(timeout=180)
        except subprocess.TimeoutExpired:
            # torch.distributed.run stops its workers (sessions of their
            # own) on SIGTERM; SIGKILL only if it does not end
            os.killpg(p.pid, signal.SIGTERM)
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        out[name] = (p.returncode, log.read_text())
    return out


@pytest.mark.parametrize("stream", list(STREAMS))
def test_serve_driver_distributed(driver_runs, stream, capsys):
    """Two ranks serve the stream through the engine: the engine line is
    printed once (rank 0 alone prints), and the ``# oracle`` line — 0
    mismatches against the labels or the brute-force counts — is the one
    a one-rank run prints, so ``n_results`` is equal row for row (the
    open loop's rows not degraded: which rows miss their deadline
    depends on the clock)."""
    from repro_torch.launch import serve
    rc, text = driver_runs[stream]
    assert rc == 0, text[-3000:]
    assert len(re.findall(r"# distributed: world 2, mesh 1x2 \(data x "
                          r"model\), backend gloo, on the CPU: the engine "
                          r"serves", text)) == 1, text[-3000:]
    serve.main(DRIVER + STREAMS[stream])
    one = capsys.readouterr().out
    assert "# distributed: world 1" in one and "hybrid path serves" in one
    pattern = (r"# oracle: (0 truncated \(exactness asserted\); "
               r"|0 dropped; )?0 /")
    assert re.match(pattern, _oracle(one)) and re.match(pattern, _oracle(text))
    if stream != "open loop":
        assert _oracle(text) == _oracle(one)
