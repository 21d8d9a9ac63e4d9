"""The CUDA kernels against their plain PyTorch versions, on the card.

Card-only (marker ``gpu``): every test takes the ``cuda`` fixture, which
skips when no CUDA device is present, so on a CPU-only machine the file
collects and skips. On the card run it with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The inputs are the edge-row sets of ``tests/test_torch_kernels.py``
(which holds the plain versions against the JAX package; the inputs
live in ``tests/helpers/torch_inputs.py``), moved to the
card; the kernels must agree bit for bit, and each call must launch its
kernel once. The walk ladder's rungs are driven through ``traversal``
with ``ops.MAX_DYNAMIC_SMEM`` lowered inside the test (``monkeypatch``),
so small trees take each rung.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import device_tree as dt  # noqa: E402
from repro_torch.data.synth import strip_queries  # noqa: E402
from repro_torch.data.synth_tree import synth_levels  # noqa: E402
from repro_torch.kernels import cuda as kcuda, ops, ref  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py); the card's
# environment may carry another top-level ``tests`` package
from helpers.torch_inputs import (  # noqa: E402
    delta_inputs, edge_bank, edge_queries, forest_cells_inputs, key_centres,
    knn_inputs, levels, rects)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import resolve_device
    return resolve_device("cuda")


def _g(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _launched(name, fn):
    before = kcuda.KERNELS[name].launches
    out = fn()
    torch.cuda.synchronize()
    assert kcuda.KERNELS[name].launches == before + 1
    return out


@pytest.mark.parametrize("n_levels", [3, 1])
def test_traverse_fused_kernel(cuda, n_levels):
    """Bit-equal dense walk; a single-level tree is one mbr_intersect."""
    rng = np.random.default_rng(0)
    mbrs, parents = levels(rng, L=5000, n1=90)
    if n_levels == 1:
        mbrs, parents = mbrs[-1:], [np.zeros(len(mbrs[-1]), np.int32)]
    q = _g(edge_queries(rng, mbrs[-1]), cuda)
    mb = [_g(m, cuda) for m in mbrs]
    pa = [_g(p, cuda) for p in parents]
    name = "traverse_fused" if n_levels > 1 else "mbr_intersect"
    got = _launched(name, lambda: ops.traverse_fused(q, mb, pa))
    assert torch.equal(got, ref.traverse_fused(q, mb, pa))


def test_leaf_refine_kernel(cuda):
    rng = np.random.default_rng(1)
    L, M, B, K = 400, 128, 96, 64
    ent = rng.uniform(0, 1, (L, M, 2)).astype(np.float32)
    ent[:, 100:] = np.inf
    q = rects(rng, B, 0, 0.8, 0.4)
    idx = rng.integers(-5, L + 5, (B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) < 0.75
    valid[(idx < 0) | (idx >= L)] = False
    valid[3] = False
    args = [_g(a, cuda) for a in (q, ent, idx, valid)]
    got = _launched("leaf_refine", lambda: ops.leaf_refine(*args))
    safe = torch.clamp(args[2], 0, L - 1)
    want = ref.leaf_refine(args[0], args[1][..., 0], args[1][..., 1], safe,
                           args[3])
    assert torch.equal(got, want) and not got[3].any()


def test_forest_infer_kernel(cuda):
    rng = np.random.default_rng(2)
    B, F, T, D = 700, 6, 16, 6
    x = rng.normal(size=(B, F)).astype(np.float32)
    fi = rng.integers(0, F, (T, D)).astype(np.int32)
    th = rng.normal(size=(T, D)).astype(np.float32)
    x[0, fi[0, 0]] = th[0, 0]
    tb = rng.uniform(0, 1, (T, 2 ** D, 1)).astype(np.float32)
    args = [_g(a, cuda) for a in (x, fi, th, tb)]
    got = _launched("forest_infer", lambda: ops.forest_infer(*args))
    want = ref.forest_infer(args[0][:, args[1].long()], args[2], args[3])
    assert torch.equal(got, want)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("D", [1, 8])
@pytest.mark.parametrize("Cl", [1, 37])
def test_forest_infer_cells_kernel(cuda, T, D, Cl):
    """Bit-equal votes (tree order in both) with 77 queries (not a
    multiple of the 32-query tile), an empty cell and a feature exactly
    on its threshold; one launch, and none for an empty batch."""
    rng = np.random.default_rng(T + 10 * D + 100 * Cl)
    args = [_g(a, cuda) for a in forest_cells_inputs(rng, 77, 6, T, D, Cl)]
    got = _launched("forest_infer_cells",
                    lambda: ops.forest_infer_cells(*args, n_cells=6))
    assert torch.equal(got, ref.forest_infer_cells(*args, 6))
    before = kcuda.KERNELS["forest_infer_cells"].launches
    empty = ops.forest_infer_cells(args[0][:0], *args[1:], n_cells=6)
    assert tuple(empty.shape) == (0, 6, Cl)
    assert kcuda.KERNELS["forest_infer_cells"].launches == before


def test_forest_bank_cuda_equals_cpu(cuda):
    """The port's forest build on the card and on the CPU: the same bank
    (host fit), ``cell_probs_dense`` through the kernel bit-equal to the
    gathered form over every cell, and every ``hybrid_query`` field of
    the range stream equal."""
    from repro_torch.core import build, device_tree as dt, labels
    from repro_torch.core.classifiers import forest
    from repro_torch.core.hybrid import hybrid_query
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    pts = synth.tweets_like(3000, seed=0)
    qs = synth.synth_queries(pts, 2e-4, 200, seed=1)
    out = {}
    for dev in ("cpu", cuda):
        tree = dt.flatten(RTree(max_entries=32).insert_all(pts), device=dev)
        hyb, _ = build.fit_airtree(tree, labels.make_workload(tree, qs),
                                   kind="forest", grid_sizes=(6,))
        q = torch.from_numpy(qs).to(dev)
        out[str(dev)] = (hyb, hybrid_query(hyb, q, max_visited=4,
                                           max_results=256))
    (ch, cr), (gh, gr) = out["cpu"], out[str(cuda)]
    assert torch.equal(ch.ait.bank.tables, gh.ait.bank.tables.cpu())
    for f in cr._fields:
        assert torch.equal(getattr(cr, f), getattr(gr, f).cpu()), f
    bank = gh.ait.bank
    q = torch.from_numpy(qs).to(cuda)
    dense = _launched("forest_infer_cells",
                      lambda: forest.cell_probs_dense(bank, q))
    ids = torch.arange(bank.n_cells, dtype=torch.int32,
                       device=cuda).expand(q.shape[0], -1)
    assert torch.equal(dense, forest.cell_probs_for(bank, q, ids))


def test_mlp_predict_compact_kernel(cuda):
    rng = np.random.default_rng(3)
    L, k, B, S = 200, 6, 48, 4
    arrays = edge_bank(rng, L, k)

    class Bank:
        pass

    bank = Bank()
    for name, a in arrays.items():
        setattr(bank, name, _g(a, cuda))
    q = _g(rng.normal(size=(B, 4)).astype(np.float32), cuda)
    cid = rng.integers(0, 8, (B, S)).astype(np.int32)
    ok = rng.uniform(size=(B, S)) < 0.8
    cid[:3] = [[3, 3, 3, 3], [0, 3, 3, 3], [0, 1, 3, 3]]
    ok[:3] = True
    cid, ok = _g(cid, cuda), _g(ok, cuda)
    idx, valid, cnt = _launched("mlp_predict_compact",
                                lambda: ops.mlp_predict_compact(
                                    q, bank, cid, ok, n_leaves=L, k=k,
                                    threshold=0.5))
    x, c = ops.mlp_inputs(q, bank, cid)
    pidx, pvalid, pcnt = ref.mlp_predict_compact(
        x, c, ok, bank.w1, bank.b1, bank.w2, bank.b2, bank.label_map,
        bank.lmask, n_leaves=L, k=k, threshold=0.5)
    scores = ref.mlp_predict_scores(x, c, ok, bank.w1, bank.b1, bank.w2,
                                    bank.b2, bank.label_map, bank.lmask, L)
    keep = ~((scores - 0.5).abs() < 1e-5).any(1)
    assert torch.equal(idx[keep], pidx[keep])
    assert torch.equal(cnt[keep], pcnt[keep])
    assert cnt[:3].tolist() == [0, k, k + 1]


@pytest.mark.parametrize("n_levels", [3, 1])
@pytest.mark.parametrize("k", [64, 512])
def test_traverse_compact_kernel(cuda, n_levels, k):
    """Bit-equal to ``compact_mask_counted`` of the walk, with rows
    visiting 0, exactly k and k + 1 leaves (all L on the single level,
    which is one mbr_intersect); the kernel itself also walks zero
    internal levels when launched directly."""
    rng = np.random.default_rng(4)
    mbrs, parents = levels(rng, L=5000, n1=90)
    if n_levels == 1:
        mbrs, parents = mbrs[-1:], [np.zeros(len(mbrs[-1]), np.int32)]
    q = np.concatenate([edge_queries(rng, mbrs[-1]),
                        strip_queries(mbrs[-1], [0, k, k + 1, 5000])])
    q, mb = _g(q, cuda), [_g(m, cuda) for m in mbrs]
    pa = [_g(p, cuda) for p in parents]
    name = "traverse_compact" if n_levels > 1 else "mbr_intersect"
    got = _launched(name, lambda: ops.traverse_compact(q, mb, pa, k))
    want = ref.traverse_compact(q, mb, pa, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2][-4:].tolist() == [0, k, k + 1, 5000]
    launch, (idx, cnt) = ops.prepare("traverse_compact", q, mb, pa, k)
    _launched("traverse_compact", launch)
    assert torch.equal(idx, want[0]) and torch.equal(cnt, want[2])


def test_mbr_intersect_kernel(cuda):
    """Bit-equal at a width off the kernel's chunk, with rects touching
    only at an edge, point rects and a batch off the query tile."""
    rng = np.random.default_rng(8)
    m = rects(rng, 9001, size=0.05)
    q = rects(rng, 77, -0.1, 1.0, 0.2)
    q[0] = [m[0, 2], m[0, 1], m[0, 2] + 0.01, m[0, 3]]      # edge
    q[1] = [m[5, 0], m[5, 1], m[5, 0], m[5, 1]]             # corner
    q[2] = [5, 5, 6, 6]                                     # empty
    qg, mg = _g(q, cuda), _g(m, cuda)
    got = _launched("mbr_intersect", lambda: ops.mbr_intersect(qg, mg))
    assert torch.equal(got, ref.mbr_intersect(qg, mg))
    assert got[0, 0] and got[1, 5] and not got[2].any()


def _sliced_tree(cuda, L=20_000, fanout=6, tl=512, table="built"):
    """A synthetic STR hierarchy on the card with its table: ``built``,
    ``degenerate`` (every window the whole lane-padded level) or
    ``shifted`` (every other tile's windows moved one block on, some past
    the level's end: both versions must drop the same leaves)."""
    mbrs, parents = synth_levels(L, fanout, np.random.default_rng(L),
                                 str_pack=True)
    sl = dt.build_ancestor_table(parents, tl=tl, device=cuda)
    if table == "degenerate":
        widths = tuple(-(-len(p) // dt.LANE) * dt.LANE for p in parents[:-1])
        sl = dt.AncestorTable(
            starts=torch.zeros_like(sl.starts), widths=widths, tl=tl)
    elif table == "shifted":
        st = sl.starts.clone()
        st[1:, 1::2] += 1
        st[-1, -1] = -(-len(parents[-2]) // sl.widths[-1])
        sl = dt.AncestorTable(starts=st, widths=sl.widths, tl=tl)
    return ([_g(m, cuda) for m in mbrs], [_g(p, cuda) for p in parents], sl,
            mbrs)


@pytest.mark.parametrize("table", ["built", "degenerate", "shifted"])
def test_traverse_fused_sliced_kernel(cuda, table):
    mb, pa, sl, mbrs = _sliced_tree(cuda, table=table)
    rng = np.random.default_rng(9)
    q = _g(np.concatenate([edge_queries(rng, mbrs[-1]),
                           rects(rng, 60, -1, 1, 0.1),
                           [[-2, -2, 2, 2]]]).astype(np.float32), cuda)
    launch, got = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    _launched("traverse_fused_sliced", launch)
    want = ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths, sl.tl)
    assert torch.equal(got, want)
    full = ref.traverse_fused(q, mb, pa)
    assert torch.equal(got, full) == (table != "shifted")
    assert not got[0].any() and (table == "shifted" or got[-1].all())


@pytest.mark.parametrize("table", ["built", "degenerate", "shifted"])
@pytest.mark.parametrize("k", [64, 512])
def test_traverse_compact_sliced_kernel(cuda, table, k):
    """Bit-equal to ``compact_mask_counted`` of the windowed walk, with
    rows visiting 0, exactly k and k + 1 leaves and a batch off the
    query tile."""
    mb, pa, sl, mbrs = _sliced_tree(cuda, table=table)
    rng = np.random.default_rng(10)
    q = np.concatenate([edge_queries(rng, mbrs[-1]),
                        rects(rng, 60, -1, 1, 0.1),
                        strip_queries(mbrs[-1], [0, k, k + 1])])
    q = _g(q.astype(np.float32), cuda)
    launch, (idx, cnt) = ops.prepare("traverse_compact_sliced", q, mb, pa,
                                     sl, k)
    _launched("traverse_compact_sliced", launch)
    want = ref.traverse_compact_sliced(q, mb, pa, sl.starts, sl.widths,
                                       sl.tl, k)
    assert torch.equal(idx, want[0]) and torch.equal(cnt, want[2])
    if table != "shifted":
        assert cnt[-3:].tolist() == [0, k, k + 1]


@pytest.mark.parametrize("kind", ["fused", "compact"])
@pytest.mark.parametrize("rung", ["full", "sliced", "per_level"])
def test_walk_rungs_through_traversal(cuda, monkeypatch, kind, rung):
    """Each rung of the ladder through ``traversal`` on a small tree (the
    limit lowered so the tree takes it) launches its kernels, and gives
    the CPU's answer."""
    from repro_torch.core import traversal
    mb, pa, sl, mbrs = _sliced_tree(cuda, L=6000, fanout=5, tl=256)
    tree = dt.DeviceTree(
        levels=tuple(dt.Level(mbrs=m, parent=p) for m, p in zip(mb, pa)),
        leaf_entries=torch.full((6000, 8, 2), float("inf"), device=cuda),
        leaf_entry_ids=torch.full((6000, 8), -1, dtype=torch.int32,
                                  device=cuda),
        leaf_counts=torch.zeros(6000, dtype=torch.int32, device=cuda),
        n_points=0, max_entries=8, aslices=sl)
    sizes = [len(m) for m in mbrs]
    limit = {"full": ops.MAX_DYNAMIC_SMEM,
             "sliced": ops.walk_smem(kind, "sliced", sizes, sl.widths,
                                     sl.tl),
             "per_level": 1}[rung]
    monkeypatch.setattr(ops, "MAX_DYNAMIC_SMEM", limit)
    assert ops.walk_route(kind, sizes, sl.widths, sl.tl) == rung
    q = _g(rects(np.random.default_rng(11), 90, -1, 1, 0.2), cuda)
    kcuda.reset_launch_counts()
    if kind == "fused":
        got = [traversal.visited_leaf_mask(tree, q)]
        want = [ref.traverse_fused(q.cpu(), [m.cpu() for m in mb],
                                   [p.cpu() for p in pa])]
    else:
        got = list(traversal.visited_leaves_compact(tree, q, 64))
        want = list(ref.traverse_compact(q.cpu(), [m.cpu() for m in mb],
                                         [p.cpu() for p in pa], 64))
        want.append(want[2] > 64)
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    expect = {"full": {f"traverse_{kind}": 1},
              "sliced": {f"traverse_{kind}_sliced": 1},
              "per_level": {"mbr_intersect": len(sizes)}}[rung]
    assert {n: c for n, c in counts.items() if c} == expect
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_spatial_key_kernel(cuda, curve):
    c = _g(key_centres(np.random.default_rng(5), n=5000), cuda)
    launch, got = ops.prepare("spatial_key", c, curve)
    _launched("spatial_key", launch)
    assert torch.equal(got, ref.spatial_key(c, curve=curve))
    q = _g(rects(np.random.default_rng(6), 700, -3, 3, 0.5), cuda)
    flat = _g(np.array([0.5, 0.5, 0.5, 0.5], np.float32), cuda)
    got = _launched("spatial_key", lambda: ops.spatial_key(q, flat, curve))
    want = ref.spatial_key(ops.spatial_key_inputs(q, flat), curve=curve)
    assert torch.equal(got, want)


def test_knn_browse_kernel(cuda):
    c3, ent, idx, valid = knn_inputs(np.random.default_rng(7), L=400,
                                     M=128, B=96, K=64, fill=100)
    args = [_g(a, cuda) for a in (c3, ent, idx, valid)]
    got = _launched("knn_browse", lambda: ops.knn_browse(*args))
    safe = torch.clamp(args[2], 0, 399)
    want = ref.knn_browse(args[0], args[1][..., 0], args[1][..., 1], safe,
                          args[3])
    assert torch.equal(got, want)
    assert float(got[1, 0, 0]) == float(args[0][1, 2])   # d2 == r2 kept
    assert torch.isinf(got[3]).all() and torch.isinf(got[..., 100:]).all()


@pytest.mark.parametrize("B,cap,fill,k", [
    (512, 8192, f, k) for k in (64, 512) for f in (0, 1170, 6144, 8192)
] + [(37, 777, 600, 8), (5, 1, 1, 4)])
def test_delta_probe_kernel(cuda, B, cap, fill, k):
    """Bit-equal to ``compact_mask_counted`` of the containment mask at
    the serving shapes (B 512, cap 8192, the narrow and wide k) and at a
    cap that is not a multiple of the block and a one-point store; rows
    with exactly k and k + 1 hits and edges through buffer points."""
    q, pts = delta_inputs(np.random.default_rng(fill + k), B, cap, fill, k)
    q, pts = _g(q, cuda), _g(pts, cuda)
    got = _launched("delta_probe", lambda: ops.delta_probe(q, pts, k=k))
    want = ref.delta_probe(q, pts, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if fill > k:
        assert got[2][:4].tolist() == [0, k, k + 1, k - 1]


def test_fresh_server_cuda_equals_cpu(cuda):
    """A toy mixed stream with the maintenance loop (kNN bank built by
    the port on the CPU, carried to the card): every stats field, the
    decisions and the final guard equal the same stream on the CPU, and
    each served batch launched the probe once."""
    from repro_torch import bridge
    from repro_torch.core import build, device_tree as dt, labels
    from repro_torch.core import monitor, schedule
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    pts = synth.tweets_like(3000, seed=0)
    base, extra = pts[:2700], pts[2700:]
    tree = dt.flatten(RTree.str_bulk(base, max_entries=32), device="cpu")
    qs = synth.synth_queries(pts, 2e-4, 200, seed=1)
    hyb, rep = build.fit_airtree(tree, labels.make_workload(tree, qs),
                                 kind="knn", grid_sizes=(6,))
    out = {}
    for dev in ("cpu", cuda):
        srv = monitor.FreshServer(
            base, bridge.hybrid_from_reference(hyb, dev), delta_cap=512,
            max_visited=64, max_results=256,
            fit_state=bridge.fit_state_from_reference(rep.fit_state),
            policy=monitor.DefaultPolicy(repack_at=0.25))
        before = kcuda.KERNELS["delta_probe"].launches
        calls = [0]
        serve_fn, wide_fn = srv.serve, srv.serve_wide

        def counted(fn):
            def call(q):
                calls[0] += 1
                return fn(q)
            return call
        srv.serve, srv.serve_wide = counted(serve_fn), counted(wide_fn)
        mixed = schedule.serve_mixed_workload(srv, qs, extra, batch=64,
                                              insert_every=1)
        torch.cuda.synchronize()
        if dev != "cpu":
            assert kcuda.KERNELS["delta_probe"].launches - before == \
                calls[0]
        out[str(dev)] = (mixed, srv)
    (cm, cs), (gm, gs) = out["cpu"], out[str(cuda)]
    for f in cm.stats._fields:
        assert np.array_equal(getattr(cm.stats, f), getattr(gm.stats, f)), f
    assert [(s, d.repack, d.refit.tolist()) for s, d in cm.maintenance] \
        == [(s, d.repack, d.refit.tolist()) for s, d in gm.maintenance]
    assert torch.equal(cs.hybrid.ait.cell_ok, gs.hybrid.ait.cell_ok.cpu())
    assert sum(d.repack for _, d in gm.maintenance) >= 1


def test_walk_probe_runs(cuda, capsys):
    """``launch.walk_probe`` at a small size: every kernel it times is
    bit-equal to its plain version (it asserts so) and it reports each."""
    from repro_torch.launch import walk_probe
    assert walk_probe.main(["--leaves", "20000", "--queries", "64"]) == 0
    out = capsys.readouterr().out
    for name in ("traverse_compact_sliced", "traverse_fused_sliced",
                 "mbr_intersect"):
        assert name in out
