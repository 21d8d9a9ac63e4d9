"""The CUDA kernels against their plain PyTorch versions, on the card.

Card-only (marker ``gpu``): every test takes the ``cuda`` fixture, which
skips when no CUDA device is present, so on a CPU-only machine the file
collects and skips. On the card run it with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The inputs are the edge-row sets of ``tests/test_torch_kernels.py``
(which holds the plain versions against the JAX package; the inputs
live in ``tests/helpers/torch_inputs.py``), moved to the
card; the kernels must agree bit for bit (``wkv6`` to the reference's
float tolerance, see its section), and each call must launch its kernel
once. The walk ladder's rungs are driven through ``traversal``
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
    knn_inputs, knn_tie_inputs, levels, rects)

pytestmark = pytest.mark.gpu


# The counted refine's and the router forest's inputs, shared with
# tests/test_torch_kernels.py (which imports them from here: this file
# imports only numpy and torch).
def refine_inputs(rng, L, M, B, K):
    """Refine inputs ``(queries [B, 4], entries [L, M, 2], leaf_idx [B, K],
    valid [B, K])``: leaves filled to 3/4 of M (+inf past), random slots,
    and the edge rows: row 1's first slot names leaf 4 with a degenerate
    query on its entry 2; row 2 holds out-of-range ids on masked slots;
    row 3 is all invalid; row 4 holds out-of-range ids on valid slots
    (they are clamped into [0, L), so they name leaves 0 and L - 1)."""
    ent = rng.uniform(0, 1, (L, M, 2)).astype(np.float32)
    ent[:, max(3, 3 * M // 4):] = np.inf
    q = rects(rng, B, 0, 0.8, 0.4)
    q[1] = [ent[4, 2, 0], ent[4, 2, 1], ent[4, 2, 0], ent[4, 2, 1]]
    idx = rng.integers(0, L, (B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) < 0.75
    idx[1, 0], valid[1, 0] = 4, True
    idx[2, :3] = [-1, L, L + 7][:K]
    valid[2, :3] = False
    valid[3] = False                                    # empty row
    idx[4, :2] = [-3, L + 2][:K]
    valid[4, :2] = True
    return q, ent, idx, valid


def router_inputs(rng, B, T, D, C, F=6):
    """Forest inputs ``(features [B, F], feat_idx [T, D], thresh [T, D],
    tables [T, 2^D, C])`` with queries 0 and 1 exactly on a threshold
    (the split is a strict >: they go left)."""
    x = rng.normal(size=(B, F)).astype(np.float32)
    fi = rng.integers(0, F, (T, D)).astype(np.int32)
    th = rng.normal(size=(T, D)).astype(np.float32)
    if B > 1:
        x[0, fi[0, 0]] = th[0, 0]
        x[1, fi[-1, -1]] = th[-1, -1]
    tb = rng.uniform(0, 1, (T, 2 ** D, C)).astype(np.float32)
    return x, fi, th, tb


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


def _has_childless(parents):
    """Does some internal node of the level above the leaves have no
    children?"""
    return len(np.unique(parents[-1])) < len(parents[-2])


@pytest.mark.parametrize("n1", [90, 2000])
@pytest.mark.parametrize("n_levels", [3, 1])
def test_traverse_fused_kernel(cuda, n_levels, n1):
    """Bit-equal dense walk, with 2,000 internal nodes over 5,000 leaves
    (many with no children); a single-level tree is one mbr_intersect."""
    rng = np.random.default_rng(0)
    mbrs, parents = levels(rng, L=5000, n1=n1)
    assert _has_childless(parents) == (n1 == 2000)
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


@pytest.mark.parametrize("M", [8, 16, 128])
@pytest.mark.parametrize("K", [1, 64, 512])
def test_leaf_refine_counted_kernel(cuda, M, K):
    """Mask and counts in one launch, bit-equal to the plain version on
    the edge rows (an all-invalid row, out-of-range ids on masked and on
    valid slots: the kernel's clamp is ``torch.clamp``'s), the counts
    equal to the mask's integer sum; ``ops.leaf_refine`` is the same
    launch's mask."""
    rng = np.random.default_rng(M + K)
    args = [_g(a, cuda) for a in refine_inputs(rng, 400, M, 96, K)]
    got, counts = _launched("leaf_refine",
                            lambda: ops.leaf_refine_counted(*args))
    q, ent, idx, valid = args
    want, want_counts = ref.leaf_refine_counted(q, ent[..., 0], ent[..., 1],
                                                idx, valid)
    assert torch.equal(got, want) and torch.equal(counts, want_counts)
    assert torch.equal(counts, got.to(torch.int32).sum(-1, dtype=torch.int32))
    assert counts.dtype == torch.int32 and not got[3].any()
    assert bool(got[1, 0, 2])
    mask = _launched("leaf_refine", lambda: ops.leaf_refine(*args))
    assert torch.equal(mask, want)


def test_leaf_refine_refuses_m_not_multiple_of_4(cuda):
    """Leaves of 6 entries: the wrapper raises before any launch."""
    rng = np.random.default_rng(6)
    args = [_g(a, cuda) for a in refine_inputs(rng, 40, 6, 16, 8)]
    before = kcuda.KERNELS["leaf_refine"].launches
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.leaf_refine_counted(*args)
    assert kcuda.KERNELS["leaf_refine"].launches == before


def odd_ids(fi, F):
    """``fi`` with ids the reference's gather wraps or clamps: -1, -F - 1,
    F + 1, -F, F and -2 first."""
    fi = fi.copy()
    odd = [-1, -F - 1, F + 1, -F, F, -2][:fi.size]
    fi.flat[:len(odd)] = odd
    return fi


@pytest.mark.parametrize("ids", ["in_range", "odd"])
@pytest.mark.parametrize("T,D,C", [(16, 6, 1), (16, 6, 37), (4, 5, 3),
                                   (16, 12, 1), (1, 1, 1)])
def test_forest_infer_gathering_kernel(cuda, T, D, C, ids):
    """One launch that gathers its own features, bit-equal to the plain
    gather and vote sum: the router's shape (tables staged in shared
    memory), 37 classes and 16 trees of depth 12 (tables read from
    global memory), 700 queries (not a multiple of the 8-query tile),
    two on a threshold, feature ids in range or wrapped and clamped as
    the reference's gather takes them; an empty batch launches
    nothing."""
    rng = np.random.default_rng(T + 10 * D + 100 * C)
    x, fi, th, tb = router_inputs(rng, 700, T, D, C)
    if ids == "odd":
        fi = odd_ids(fi, x.shape[1])
    x, fi, th, tb = (_g(a, cuda) for a in (x, fi, th, tb))
    got = _launched("forest_infer", lambda: ops.forest_infer(x, fi, th, tb))
    assert torch.equal(got, ref.forest_infer(ref.forest_select(x, fi), th,
                                             tb))
    before = kcuda.KERNELS["forest_infer"].launches
    empty = ops.forest_infer(x[:0], fi, th, tb)
    assert tuple(empty.shape) == (0, C)
    assert kcuda.KERNELS["forest_infer"].launches == before


@pytest.mark.parametrize("ids", ["in_range", "odd"])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("D", [1, 8])
@pytest.mark.parametrize("Cl", [1, 37])
def test_forest_infer_cells_kernel(cuda, T, D, Cl, ids):
    """Bit-equal votes (tree order in both) with 77 queries (not a
    multiple of the 32-query tile), an empty cell, a feature exactly on
    its threshold and, for "odd", feature ids the reference's gather
    wraps or clamps; one launch, and none for an empty batch."""
    rng = np.random.default_rng(T + 10 * D + 100 * Cl)
    inputs = list(forest_cells_inputs(rng, 77, 6, T, D, Cl))
    if ids == "odd":
        inputs[1] = odd_ids(inputs[1], inputs[0].shape[1])
    args = [_g(a, cuda) for a in inputs]
    got = _launched("forest_infer_cells",
                    lambda: ops.forest_infer_cells(*args, n_cells=6))
    assert torch.equal(got, ref.forest_infer_cells(*args, 6))
    before = kcuda.KERNELS["forest_infer_cells"].launches
    empty = ops.forest_infer_cells(args[0][:0], *args[1:], n_cells=6)
    assert tuple(empty.shape) == (0, 6, Cl)
    assert kcuda.KERNELS["forest_infer_cells"].launches == before


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("Cl", [670, 672, 671])
def test_forest_infer_cells_kernel_label_vectors(cuda, T, Cl):
    """The deployment's 670 labels (float2 vectors) and 672 / 671 (float4
    and scalar), 515 queries with runs of repeated queries (their rows
    reuse the vectors in registers) and an empty cell, the tables a view
    off 16 bytes (the wrapper copies it): bit-equal, one launch."""
    rng = np.random.default_rng(T + Cl)
    x, fi, th, tb = forest_cells_inputs(rng, 515, 7, T, 4, Cl)
    x[20:40] = x[19]
    args = [_g(a, cuda) for a in (x, fi, th, tb)]
    odd = torch.empty(tb.size + 1, dtype=torch.float32, device=cuda)
    odd[1:] = args[3].reshape(-1)
    args[3] = odd[1:].view(tb.shape)
    got = _launched("forest_infer_cells",
                    lambda: ops.forest_infer_cells(*args, n_cells=7))
    assert torch.equal(got, ref.forest_infer_cells(*args, 7))


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


@pytest.mark.parametrize("n1", [90, 2000])
@pytest.mark.parametrize("n_levels", [3, 1])
@pytest.mark.parametrize("k", [64, 512])
def test_traverse_compact_kernel(cuda, n_levels, k, n1):
    """Bit-equal to ``compact_mask_counted`` of the walk, with rows
    visiting 0, exactly k and k + 1 leaves (all L on the single level,
    which is one mbr_intersect) and, at 2,000 internal nodes, many with
    no children; the kernel itself also walks zero internal levels when
    launched directly."""
    rng = np.random.default_rng(4)
    mbrs, parents = levels(rng, L=5000, n1=n1)
    assert _has_childless(parents) == (n1 == 2000)
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


@pytest.mark.parametrize("k", [64, 512])
@pytest.mark.parametrize("tree", ["deep", "childless"])
def test_walk_kernels_edge_rows(cuda, tree, k):
    """Both full walks, one launch each, bit-equal to their plain
    versions on a tree of four internal levels (``synth_levels``, fanout
    8) and on one whose internal nodes are mostly childless, with rows
    visiting 0, k, k + 1 and all L leaves, a row at x0 > x1 (which meets
    no leaf), and 45 rows (a multiple of neither CTA's queries); through
    ``prepare`` too, with the pack built beforehand."""
    rng = np.random.default_rng(k)
    if tree == "deep":
        mbrs, parents = synth_levels(4000, 8, rng)
        assert [len(p) for p in parents] == [1, 8, 63, 500, 4000]
    else:
        mbrs, parents = levels(rng, L=3000, n1=6000)
        assert _has_childless(parents)
    L = len(mbrs[-1])
    q = np.concatenate([edge_queries(rng, mbrs[-1]),
                        strip_queries(mbrs[-1], [0, k, k + 1, L])])
    lo, hi = mbrs[-1][:, 0].min(), mbrs[-1][:, 2].max()
    mid = (lo + hi) / 2
    inverted = [[mid + 0.25, -9, mid - 0.25, 9]]
    q = _g(np.concatenate([q, inverted]).astype(np.float32), cuda)
    assert q.shape[0] == 45
    mb = [_g(m, cuda) for m in mbrs]
    pa = [_g(p, cuda) for p in parents]
    mask = _launched("traverse_fused", lambda: ops.traverse_fused(q, mb, pa))
    want_mask = ref.traverse_fused(q, mb, pa)
    assert torch.equal(mask, want_mask)
    got = _launched("traverse_compact",
                    lambda: ops.traverse_compact(q, mb, pa, k))
    want = ref.traverse_compact(q, mb, pa, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2][-5:].tolist() == [0, k, k + 1, L, 0]
    pack = dt.build_walk_pack(mb, pa)
    launch, (idx, cnt) = ops.prepare("traverse_compact", q, mb, pa, k, pack)
    _launched("traverse_compact", launch)
    assert torch.equal(idx, want[0]) and torch.equal(cnt, want[2])
    launch, out = ops.prepare("traverse_fused", q, mb, pa, pack)
    _launched("traverse_fused", launch)
    assert torch.equal(out, want_mask)


@pytest.mark.parametrize("kind", ["fused", "compact"])
def test_walk_refuses_parents_out_of_order(cuda, kind):
    """A tree whose leaves' parents are not non-decreasing (children not
    contiguous) on the full rung: the wrapper raises ``ValueError`` and
    launches nothing."""
    rng = np.random.default_rng(12)
    mbrs, parents = levels(rng, L=500, n1=20)
    parents[-1] = parents[-1].copy()
    parents[-1][[3, 400]] = parents[-1][[400, 3]]
    assert parents[-1][3] != parents[-1][400]
    q = _g(edge_queries(rng, mbrs[-1]), cuda)
    mb = [_g(m, cuda) for m in mbrs]
    pa = [_g(p, cuda) for p in parents]
    assert ops.walk_route(kind, [len(m) for m in mbrs]) == "full"
    kcuda.reset_launch_counts()
    with pytest.raises(ValueError, match="non-decreasing"):
        if kind == "fused":
            ops.traverse_fused(q, mb, pa)
        else:
            ops.traverse_compact(q, mb, pa, 64)
    torch.cuda.synchronize()
    assert not any(kcuda.launch_counts().values())


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


@pytest.mark.parametrize("B", [1, 33, 512])
@pytest.mark.parametrize("N", [1, 15, 16, 17, 1000, 12_730, 12_731])
def test_mbr_intersect_kernel_widths(cuda, N, B):
    """Bit-equal at widths around the 16-byte block and the 512-MBR tile
    and at the deployment's leaf level (12,730: rows 2-byte aligned),
    with rects touching only at an edge; one launch."""
    rng = np.random.default_rng(N + B)
    m = rects(rng, N, size=0.05)
    q = rects(rng, B, -0.1, 1.0, 0.2)
    q[0] = [m[0, 2], m[0, 1], m[0, 2] + 0.01, m[0, 3]]      # edge
    qg, mg = _g(q, cuda), _g(m, cuda)
    got = _launched("mbr_intersect", lambda: ops.mbr_intersect(qg, mg))
    assert torch.equal(got, ref.mbr_intersect(qg, mg))
    assert got[0, 0]


@pytest.mark.parametrize("order", ["non_decreasing", "shuffled"])
@pytest.mark.parametrize("N", [17, 9001])
def test_mbr_intersect_folded_kernel(cuda, order, N):
    """The folded form (``parent_mask[:, parents] & hit`` in one launch)
    bit-equal to the plain version with parents in order and shuffled
    (not contiguous), dead and live parent rows; an empty batch launches
    nothing."""
    rng = np.random.default_rng(N)
    n_prev, B = 257, 77
    m = rects(rng, N, size=0.05)
    q = rects(rng, B, -0.1, 1.0, 0.3)
    parents = np.sort(rng.integers(0, n_prev, N)).astype(np.int32)
    if order == "shuffled":
        parents = rng.permutation(parents)
    pm = rng.uniform(size=(B, n_prev)) < 0.7
    pm[1] = True
    pm[2] = False
    qg, mg, pmg, pg = (_g(a, cuda) for a in (q, m, pm, parents))
    got = _launched("mbr_intersect",
                    lambda: ops.mbr_intersect(qg, mg, pmg, pg))
    assert torch.equal(got, ref.mbr_intersect(qg, mg, pmg, pg))
    assert torch.equal(got[1], ref.mbr_intersect(qg, mg)[1])
    assert not got[2].any()
    before = kcuda.KERNELS["mbr_intersect"].launches
    empty = ops.mbr_intersect(qg[:0], mg, pmg[:0], pg)
    assert tuple(empty.shape) == (0, N)
    assert kcuda.KERNELS["mbr_intersect"].launches == before


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


@pytest.mark.parametrize("L,tl", [(20_000, 512), (9_001, 512),
                                  (20_000, 16), (300_000, 1024)])
@pytest.mark.parametrize("table", ["built", "degenerate", "shifted"])
def test_traverse_fused_sliced_kernel(cuda, table, L, tl):
    """Bit-equal to the windowed plain version, and on a built or
    degenerate table to the full walk's kernel: batches of 1, 15, 17, 70
    and 513 rows (the last query tile partial), an odd L (no row but row
    0 starts 16-aligned), a last leaf tile shorter than tl, a batch that
    misses the root (every tile's walk ends at its first window) and one
    of small rects in a corner (walks that end in lower windows), and
    the shifted table's windows past the level's end; tables of so many
    tiles that a CTA walks several query tiles (tl 16; and tl 1,024,
    two rounds of leaves a tile); one launch each."""
    mb, pa, sl, mbrs = _sliced_tree(cuda, L=L, tl=tl, table=table)
    sizes = [len(m) for m in mbrs]
    if ops.walk_smem("fused", "sliced", sizes, sl.widths, tl) > \
            ops.MAX_DYNAMIC_SMEM:       # the 300K tree's degenerate table
        with pytest.raises(ValueError, match="shared memory"):
            ops.prepare("traverse_fused_sliced", _g(rects(
                np.random.default_rng(0), 4), cuda), mb, pa, sl)
        assert ops.walk_route("fused", sizes, sl.widths, tl) == "per_level"
        return
    rng = np.random.default_rng(9)
    base = np.concatenate([edge_queries(rng, mbrs[-1]),
                           rects(rng, 60, -1, 1, 0.1),
                           [[-2, -2, 2, 2]]]).astype(np.float32)
    big = np.concatenate([rects(rng, 513 - len(base), -1, 1, 0.1), base])
    far = np.tile(np.float32([[5, 5, 6, 6]]), (40, 1))
    corner = rects(rng, 40, -1, -0.95, 0.02)
    for qa in (base, base[-1:], base[:15], base[-17:], big, far, corner):
        q = _g(qa.astype(np.float32), cuda)
        launch, got = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
        _launched("traverse_fused_sliced", launch)
        want = ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths,
                                         sl.tl)
        assert torch.equal(got, want)
        flaunch, full = ops.prepare("traverse_fused", q, mb, pa)
        flaunch()
        assert torch.equal(full, ref.traverse_fused(q, mb, pa))
        if table != "shifted":
            assert torch.equal(got, full)
        else:       # the shifted windows only drop leaves
            assert not (got & ~full).any()
        if qa is far:
            assert not got.any()
    q = _g(base, cuda)
    got = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    got[0]()
    assert not got[1][0].any() and (table == "shifted" or got[1][-1].all())
    assert table != "shifted" or \
        not torch.equal(got[1], ref.traverse_fused(q, mb, pa))


@pytest.mark.parametrize("segments", ["auto", "1", "2", "n_tiles"])
@pytest.mark.parametrize("table", ["built", "degenerate", "shifted"])
@pytest.mark.parametrize("k", [64, 512])
def test_traverse_compact_sliced_kernel(cuda, monkeypatch, table, k,
                                        segments):
    """Bit-equal to ``compact_mask_counted`` of the windowed walk, with
    rows visiting 0, exactly k, k + 1 and all L leaves, batches of 1, of
    106 (off the query tile) and of 513 rows, and the segment count the
    wrapper picks or forced to 1, 2 and n_tiles (``monkeypatch``); one
    launch count per call."""
    mb, pa, sl, mbrs = _sliced_tree(cuda, table=table)
    if segments != "auto":
        S = sl.n_tiles if segments == "n_tiles" else int(segments)
        monkeypatch.setattr(ops, "compact_sliced_segments",
                            lambda B, n_tiles: S)
    rng = np.random.default_rng(10)
    base = np.concatenate([edge_queries(rng, mbrs[-1]),
                           rects(rng, 62, -1, 1, 0.1),
                           strip_queries(mbrs[-1], [0, k, k + 1]),
                           [[-2, -2, 2, 2]]]).astype(np.float32)
    big = np.concatenate([rects(rng, 513 - len(base), -1, 1, 0.1), base])
    L = len(mbrs[-1])
    for q in (base, base[-1:], big.astype(np.float32)):
        q = _g(q, cuda)
        launch, (idx, cnt) = ops.prepare("traverse_compact_sliced", q, mb,
                                         pa, sl, k)
        _launched("traverse_compact_sliced", launch)
        want = ref.traverse_compact_sliced(q, mb, pa, sl.starts, sl.widths,
                                           sl.tl, k)
        assert torch.equal(idx, want[0]) and torch.equal(cnt, want[2])
        if table != "shifted":
            assert cnt[-1] == L > k
            if q.shape[0] > 1:
                assert cnt[-4:].tolist() == [0, k, k + 1, L]


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
             "sliced": max(ops.walk_smem(kind, "sliced", sizes, sl.widths,
                                         sl.tl),
                           ops.sliced_rung_bytes(kind, sizes, sl.widths,
                                                 sl.tl)),
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
    """Keys through the contract (rects and frame in, one launch), bit-
    equal to ``ref.spatial_key(ops.spatial_key_inputs(...))``: the edge
    centres as degenerate rects (c, c, c, c) under the unit frame, which
    normalizes each to exactly c (the frame's corners: 1.0 clips to
    32767; centres outside it; exact quantization steps and the floats
    just below; ±inf), random rects in a frame, a zero-extent frame and
    ``bbox=None``; through ``prepare`` and the wrapper."""
    c = key_centres(np.random.default_rng(5), n=5000)
    edge = _g(np.concatenate([c, c], 1), cuda)
    unit = _g(np.array([0, 0, 1, 1], np.float32), cuda)
    assert torch.equal(ops.spatial_key_inputs(edge, unit), _g(c, cuda))
    q = _g(rects(np.random.default_rng(6), 700, -3, 3, 0.5), cuda)
    frame = _g(np.array([-1, -2, 1, 2], np.float32), cuda)
    flat = _g(np.array([0.5, 0.5, 0.5, 0.5], np.float32), cuda)
    for r, bbox in ((edge, unit), (q, frame), (q, flat), (q, None)):
        want = ref.spatial_key(ops.spatial_key_inputs(r, bbox), curve=curve)
        launch, got = ops.prepare("spatial_key", r, bbox, curve)
        _launched("spatial_key", launch)
        assert torch.equal(got, want)
        got = _launched("spatial_key",
                        lambda: ops.spatial_key(r, bbox, curve))
        assert torch.equal(got, want)
    keys = ops.spatial_key(edge, unit, curve)
    assert keys[1] == keys[12]          # (1, 1) clips to (32767, 32767)


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


def _topk_equal(args, k):
    got = _launched("knn_browse", lambda: ops.knn_browse_topk(*args, k))
    safe = torch.clamp(args[3], 0, args[1].shape[0] - 1)
    want = ref.knn_browse_topk(args[0], args[1][..., 0], args[1][..., 1],
                               args[2], safe, args[4], k)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    return got


def serving_slots(rng, L, M, B, K, frac, fill=100):
    """Selecting-form inputs at a serving shape: leaves of ``fill``
    entries (+inf and id -1 past), centres at entries, a radius that takes
    in tens to thousands of candidates, slot tables whose valid prefix
    averages ``frac`` of K (1.0: every slot, as on the 40M-point index),
    and the last 12 rows repeating row B - 13 (the scheduler's padding)."""
    ent = rng.uniform(0, 1, (L, M, 2)).astype(np.float32)
    ent[:, fill:] = np.inf
    ids = rng.permutation(L * M).astype(np.int32).reshape(L, M)
    ids[:, fill:] = -1
    c = ent[rng.integers(0, L, B), rng.integers(0, fill, B)]
    r2 = rng.choice(np.array([1e-4, 1e-3, 1e-2], np.float32), (B, 1))
    idx = rng.integers(0, L, (B, K)).astype(np.int32)
    n_vis = np.minimum(K, rng.integers(0, int(2 * frac * K) + 1, B))
    if frac >= 1:
        n_vis[:] = K
    valid = np.arange(K)[None, :] < n_vis[:, None]
    c3 = np.concatenate([c, r2], 1)
    for a in (c3, idx, valid):
        a[-12:] = a[-13]
    return c3, ent, ids, idx, valid


@pytest.mark.parametrize("K,frac", [(64, 0.1), (512, 0.02), (64, 1.0),
                                    (512, 1.0)])
def test_knn_browse_topk_kernel(cuda, K, frac):
    """The selecting form at the serving shapes (B 512, M 128, k 8): the
    872K deployment's narrow and wide tables (a short valid prefix) and
    the 40M-point index's (every slot valid); bit-equal on the k
    distances, ids and counts, one knn_browse launch a call."""
    rng = np.random.default_rng(K + int(frac * 100))
    args = [_g(a, cuda) for a in serving_slots(rng, 3000, 128, 512, K,
                                               frac)]
    d2k, _, nw = _topk_equal(args, 8)
    assert int(nw.max()) > 8 and torch.isfinite(d2k).any()


@pytest.mark.parametrize("k,M", [(1, 16), (8, 16), (64, 16), (8, 128),
                                 (64, 128), (5, 66)])
def test_knn_browse_topk_kernel_ties(cuda, k, M):
    """Tie-heavy lattice inputs (duplicate points within a leaf and across
    slots, d2 == r2, r2 < 0 and +inf, an all-invalid row, clamped ids),
    k 1, 8 and 64, leaves of 16, 128 and 66 entries (a slot's second
    unit partly idle): bit-equal, one launch."""
    args = [_g(a, cuda) for a in knn_tie_inputs(
        np.random.default_rng(k + M), L=40, M=M, B=24, K=8,
        fill=min(M, 100) - 4)]
    _topk_equal(args, k)


def test_knn_browse_topk_kernel_refuses(cuda):
    """k past KNN_MAX_K and odd leaves raise before any launch."""
    args = [_g(a, cuda) for a in knn_tie_inputs(
        np.random.default_rng(0), L=40, M=16, B=24, K=8)]
    before = kcuda.KERNELS["knn_browse"].launches
    with pytest.raises(ValueError, match="knn_browse_topk"):
        ops.knn_browse_topk(*args, ops.KNN_MAX_K + 1)
    with pytest.raises(ValueError, match="knn_browse_topk"):
        ops.knn_browse_topk(args[0], args[1][:, :15].contiguous(),
                            args[2][:, :15].contiguous(), *args[3:], 8)
    assert kcuda.KERNELS["knn_browse"].launches == before


def test_knn_query_cuda_equals_cpu(cuda):
    """``knn_query`` on the card: one knn_browse launch and one compact
    walk a call, nothing else of the port's kernels, and every field
    equal to the same call on the CPU (plain versions)."""
    from repro_torch.core import knn
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    pts = synth.tweets_like(20000, seed=0)
    host = RTree.str_bulk(pts, max_entries=32)
    q = np.concatenate([pts[:300], pts[:300]], 1).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        tree = dt.flatten(host, device=dev)
        r = knn.default_radius(tree, 8)
        kcuda.reset_launch_counts()
        out[str(dev)] = knn.knn_query(tree, _g(q, dev), k=8, radius=r)
        if dev != "cpu":
            torch.cuda.synchronize()
            launched = {n: c for n, c in kcuda.launch_counts().items() if c}
            assert launched == {"knn_browse": 1, "traverse_compact": 1}
    for g, w in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("B,cap,fill,k", [
    (512, 8192, f, k) for k in (64, 512) for f in (0, 1170, 6144, 8192)
] + [(37, 777, 600, 8), (5, 1, 1, 4), (64, 40001, 30000, 64)])
def test_delta_probe_kernel(cuda, B, cap, fill, k):
    """Bit-equal to ``compact_mask_counted`` of the containment mask at
    the serving shapes (B 512, cap 8192, the narrow and wide k), at a
    cap that is not a multiple of the block, on a one-point store and on
    a buffer too large to stage in shared memory (swept from global
    memory); rows with exactly k and k + 1 hits and edges through buffer
    points."""
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



# the engine step's launches a step: the compact walk, the R and AI
# refines, the router and the insert buffer's probe
ENGINE_LAUNCHES = {"traverse_compact": 1, "leaf_refine": 2,
                   "forest_infer": 1, "delta_probe": 1}


@pytest.mark.parametrize("kind", ["knn", "mlp", "forest"])
def test_engine_step_cuda_equals_cpu(cuda, kind):
    """The engine's serve step (both score unions, a staged insert
    buffer; bank built by the port on the CPU, carried to the card) on
    the card against the same step on the CPU: every ``ServeStats``
    field bit-equal (MLP rows with a cell-slot score within 1e-5 of the
    threshold reported, not compared), and each step launched the
    kernels of ``ENGINE_LAUNCHES`` that many times, plus
    ``mlp_predict_compact`` once for the MLP bank's ``topk`` union."""
    from repro_torch import bridge
    from repro_torch.core import build, device_tree as dt, engine, labels
    from repro_torch.core.aitree import cell_slot_probs
    from repro_torch.core.grid import cells_of_queries
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    pts = synth.tweets_like(3000, seed=0)
    qs = synth.synth_queries(pts, 2e-3, 200, seed=1)
    tree = dt.flatten(RTree(max_entries=32).insert_all(pts), device="cpu")
    fits = {"knn": dict(grid_sizes=(6,)), "forest": dict(grid_sizes=(6,)),
            "mlp": dict(grid_sizes=(4,), mlp_hidden=16, mlp_epochs=400)}
    hyb, _ = build.fit_airtree(tree, labels.make_workload(tree, qs),
                               kind=kind, max_pred=16, **fits[kind])
    ghyb = bridge.hybrid_from_reference(hyb, cuda)
    q = torch.from_numpy(qs)
    xy = torch.full((512, 2), float("inf"))
    xy[:300] = torch.from_numpy(synth.tweets_like(300, seed=5)).float()
    keep = torch.ones(q.shape[0], dtype=torch.bool)
    if kind == "mlp":
        ids, _, _ = cells_of_queries(hyb.ait.grid, q, 4)
        p = cell_slot_probs(hyb.ait, q, ids)
        keep = ~((p - hyb.ait.threshold).abs() < 1e-5).any(dim=(1, 2))
        print(f"near-threshold rows (reported, not compared): "
              f"{torch.nonzero(~keep).flatten().tolist()}")
    for union in ("topk", "pmax"):
        step = engine.make_serve_step(
            engine.EngineConfig(max_visited=4, score_union=union), kind=kind)
        want = step(hyb, q, xy)
        before = kcuda.launch_counts()
        got = step(ghyb, q.to(cuda), xy.to(cuda))
        torch.cuda.synchronize()
        after = kcuda.launch_counts()
        for f in want._fields:
            assert torch.equal(getattr(got, f).cpu()[keep],
                               getattr(want, f)[keep]), (union, f)
        need = dict(ENGINE_LAUNCHES, mlp_predict_compact=int(
            kind == "mlp" and union == "topk"))
        assert {n: after[n] - before[n] for n in after} == \
            {n: need.get(n, 0) for n in after}, union
        assert got.r_truncated.any() and got.delta_hits.any()

def test_walk_probe_runs(cuda, capsys):
    """``launch.walk_probe`` at a small size: every kernel it times is
    bit-equal to its plain version (it asserts so) and it reports each."""
    from repro_torch.launch import walk_probe
    assert walk_probe.main(["--leaves", "20000", "--queries", "64"]) == 0
    out = capsys.readouterr().out
    for name in ("traverse_compact_sliced", "traverse_fused_sliced",
                 "mbr_intersect"):
        assert name in out


# ---------------------------------------------------------------------------
# wkv6 (the rwkv6 scan): a tolerance, not bits — the chunk-parallel kernels
# (split-TF32 tensor-core products) and the sequential plain version add
# the same float32 terms in another order. rtol = atol = 5e-4 is the
# reference's own (tests/test_kernels.py). ``chunk`` is the kernels' C.
# ---------------------------------------------------------------------------

def _wkv6_args(dev, seed, BH, T, dk, dv, lo=0.05, hi=0.999):
    rng = np.random.default_rng(seed)
    r, k = (rng.normal(size=(BH, T, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(BH, T, dv)).astype(np.float32)
    w = rng.uniform(lo, hi, size=(BH, T, dk)).astype(np.float32)
    u = rng.normal(size=(BH, dk)).astype(np.float32)
    return [_g(a, dev) for a in (r, k, v, w, u)]


def _wkv6_close(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("BH,T,dk,dv,chunk", [
    (1, 16, 8, 8, 16), (3, 64, 8, 16, 16), (2, 48, 16, 16, 16),
    (1, 33, 8, 8, 16), (2, 128, 32, 32, 64),     # the reference's table
    (2, 97, 64, 64, 64), (3, 200, 16, 40, 64),   # padded T; dv past a slice
    (40, 4096, 64, 64, 64),                      # rwkv6-3b, batch 1
    (320, 4096, 64, 64, 64),                     # rwkv6-3b, batch 8
    (40, 32768, 64, 64, 64),                     # batch 1, 512 chunk states
])
def test_wkv6_kernel(cuda, BH, T, dk, dv, chunk):
    args = _wkv6_args(cuda, BH * T + dv, BH, T, dk, dv)
    got = _launched("wkv6", lambda: ops.wkv6(*args, chunk=chunk))
    _wkv6_close(got, ref.wkv6(*args))


@pytest.mark.parametrize("case", ["extreme", "zero", "zero_bounds", "bf16"])
def test_wkv6_kernel_decay_edges(cuda, case):
    """Decay in [1e-8, 0.1]; decay exactly 0 on a whole step and on some
    channels (the sequential definition resets the state; the reference's
    chunked TPU kernel gives NaN there), also at the first and last step
    of 16-step sub-chunks and of 64-step chunks; bf16 inputs."""
    lo, hi = (1e-8, 0.1) if case == "extreme" else (0.05, 0.999)
    args = _wkv6_args(cuda, 7, 4, 333, 64, 64, lo, hi)
    if case == "zero":
        args[3][0, 70] = 0.0
        args[3][1, 5, :7] = 0.0
        args[3][2, 127] = 0.0                      # a chunk's last step
    if case == "zero_bounds":
        for row, step, n_ch in [(0, 0, None), (0, 15, None), (0, 16, None),
                                (1, 31, 9), (1, 32, None), (2, 63, None),
                                (2, 64, 5), (3, 191, None), (3, 192, None),
                                (3, 332, None)]:
            args[3][row, step, :n_ch] = 0.0
    if case == "bf16":
        args = [a.to(torch.bfloat16) for a in args]
    got = _launched("wkv6", lambda: ops.wkv6(*args))
    _wkv6_close(got, ref.wkv6(*args))


def test_wkv6_one_launch_a_call(cuda):
    """One ``ops.wkv6`` call is one launch on the wrapper's count (its
    three kernels go out in one ``wkv6_launch``), and no other kernel's."""
    args = _wkv6_args(cuda, 9, 2, 200, 64, 64)
    kcuda.reset_launch_counts()
    ops.wkv6(*args)
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    assert counts["wkv6"] == 1
    assert sum(counts.values()) == 1


@pytest.mark.parametrize("chunk", [8, 24, 128])
def test_wkv6_launch_refuses_other_chunks(cuda, chunk):
    """The C launcher itself refuses a chunk that is no multiple of 16 or
    past 64 (cudaErrorInvalidValue, 1) before it launches anything: the
    kernels' layout holds at most four 16-step sub-chunks."""
    BH, T, D = 1, 384, ops.WKV6_HEAD
    r, k, v, w = (torch.ones(BH, T, D, device=cuda) for _ in range(4))
    u = torch.ones(BH, D, device=cuda)
    states = torch.empty(BH, T // 8, D, D, device=cuda)
    decay = torch.empty(BH, T // 8, D, device=cuda)
    y = torch.full((BH, T, D), 7.0, device=cuda)
    kernel = kcuda.KERNELS["wkv6"]
    before = kernel.launches
    with pytest.raises(RuntimeError, match="cudaError_t 1$"):
        kernel(*(a.data_ptr() for a in (r, k, v, w, u)), BH, T, chunk,
               states.data_ptr(), decay.data_ptr(), y.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert kernel.launches == before
    assert bool((y == 7.0).all())


def test_rwkv_time_mix_full_width_layer(cuda):
    """One rwkv6-3b layer (d 2560, 40 heads of 64) in bf16: the time-mix
    on the card (one wkv6 launch) against the same layer on the CPU (the
    plain scan). bf16 matmuls round differently on the two devices, so
    the output is held to 2e-2 of its largest magnitude, the bound of the
    reference's decode-vs-forward check."""
    from repro_torch import configs
    from repro_torch.models import ssm, transformer as tf
    cfg = configs.get_config("rwkv6_3b")
    p = tf._block_params(cfg, torch.Generator().manual_seed(0),
                         torch.bfloat16, "cpu")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 160, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    zeros = torch.zeros((2, cfg.d_model), dtype=torch.bfloat16)
    wkv = torch.zeros((2, cfg.n_heads, 64, 64))
    with torch.no_grad():
        want = ssm.rwkv_time_mix(cfg, p, x, zeros, wkv)[0]
        pg = {k: v.to(cuda) for k, v in p.items()}
        got = _launched("wkv6", lambda: ssm.rwkv_time_mix(
            cfg, pg, x.to(cuda), zeros.to(cuda), wkv.to(cuda))[0])
    err = float((got.cpu().float() - want.float()).abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= 2e-2 * float(want.float().abs().max()), err


# ---------------------------------------------------------------------------
# wkv6 under autograd and the train step (the training slice): the forward
# is the kernel (one launch), the backward the plain scan recomputed, as the
# reference's custom_vjp; held to the scan under autograd at 5e-4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,T,dtype", [(320, 128, "float32"),
                                        (8, 37, "float32"),
                                        (4, 50, "bfloat16")])
def test_wkv6_autograd_function(cuda, BH, T, dtype):
    args = [a.to(getattr(torch, dtype)).requires_grad_()
            for a in _wkv6_args(cuda, BH + T, BH, T, 64, 64)]
    gy = torch.randn(BH, T, 64, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(T))
    y = _launched("wkv6", lambda: ops.wkv6(*args))
    assert "WKV6" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, args, gy)
    xr = [a.detach().clone().requires_grad_() for a in args]
    yr = ref.wkv6(*xr)
    want = torch.autograd.grad(yr, xr, gy)
    _wkv6_close(y.detach(), yr.detach())
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w.float(), rtol=5e-4,
                                   atol=5e-4)


def test_wkv6_no_grad_takes_no_function(cuda):
    args = [a.requires_grad_() for a in _wkv6_args(cuda, 3, 2, 40, 64, 64)]
    with torch.no_grad():
        y = _launched("wkv6", lambda: ops.wkv6(*args))
    assert y.grad_fn is None


@pytest.mark.parametrize("arch", ["rwkv6_3b", "llama3_405b", "qwen2_72b",
                                  "qwen2_vl_72b", "gemma2_9b",
                                  "h2o_danube3_4b", "hymba_1_5b",
                                  "whisper_small", "deepseek_moe_16b",
                                  "deepseek_v2_236b"])
def test_train_step_card_against_cpu(cuda, arch):
    """One ``reduced(...)`` train step on the card against the same step
    on the CPU from the same weights: loss, grad norm and lr within 1e-4
    relative; 2 wkv6 launches a layer for rwkv6 (forward + remat
    "dots"), no kernel of ``kernels/csrc`` for the other families; the
    state stays on the card. (The new params are not compared: AdamW's
    first step moves each by about lr · sign(g), so a gradient near 0
    moves its param by up to 2 · lr on a difference of float order.)"""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.training import optimizer as opt, train_loop, tree
    cfg = configs.reduced(configs.get_config(arch))
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0)
    s_cpu = train_loop.init_train_state(
        cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
        opt_cfg=ocfg, device="cpu")
    s_card = tree.rebuild(s_cpu, lambda _, t: t.to(cuda))
    batch = train.synthetic_batch(cfg, 4, 96, 0)
    step = train_loop.make_train_step(cfg, opt_cfg=ocfg)
    kcuda.reset_launch_counts()
    s_card, m_card = step(s_card, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    want = {"wkv6": 2 * cfg.n_layers} if cfg.family == "ssm" else {}
    assert {k: c for k, c in kcuda.launch_counts().items() if c} == want
    s_cpu, m_cpu = step(s_cpu, batch)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m_card[k]), float(m_cpu[k]),
                                   rtol=1e-4, err_msg=k)
    assert all(a.device.type == "cuda" for _, a in tree.leaves(s_card))
    assert int(s_card.opt.step) == int(s_cpu.opt.step) == 1


def test_train_entry_points_run_on_the_card(cuda):
    from repro_torch import configs
    from repro_torch.training import train_loop, tree
    cfg = configs.reduced(configs.get_config("rwkv6_3b"))
    state = train_loop.init_train_state(cfg,
                                        torch.Generator().manual_seed(0))
    assert all(t.device.type == "cuda" for _, t in tree.leaves(state))


# ---------------------------------------------------------------------------
# the LM serving families (dense ×5, hymba, whisper, the moe pair):
# forward and decode on the card against the same port code on the CPU,
# float32, within 1e-4 of the largest magnitude; no kernel of
# kernels/csrc launches on these paths
# ---------------------------------------------------------------------------

def _lm_world(arch, dev):
    from helpers.torch_lm import batch, perturbed
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    cfg = configs.reduced(configs.get_config(arch))
    p = tf.init_params(cfg, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(len(arch))
    p = perturbed(p, rng)

    def tree(t, d):
        return {k: tree(v, d) for k, v in t.items()} if isinstance(t, dict) \
            else torch.from_numpy(t).to(d)
    nb = batch(cfg, rng, 2, 24)
    return cfg, tree(p, "cpu"), tree(p, dev), nb


def _lm_close(got, want, tol=1e-4):
    got, want = got.cpu().float(), want.float()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("arch", ["llama3_405b", "qwen2_72b", "qwen2_vl_72b",
                                  "gemma2_9b", "h2o_danube3_4b",
                                  "hymba_1_5b", "whisper_small",
                                  "deepseek_moe_16b", "deepseek_v2_236b"])
def test_lm_serving_card_against_cpu(cuda, arch):
    """``forward`` over 24 tokens (past the reduced window of 16) and
    ``prefill_via_decode`` of the same tokens (the rings wrap), every
    cache field and ``pos``, on the card against the CPU."""
    from helpers.torch_lm import fill_cross
    from repro_torch.models import transformer as tf
    from repro_torch.serving import decode, kvcache
    from repro_torch.training import tree
    cfg, p_cpu, p_card, nb = _lm_world(arch, cuda)
    outs = {}
    kcuda.reset_launch_counts()
    for where, p in (("cpu", p_cpu), ("card", p_card)):
        dev = "cpu" if where == "cpu" else cuda
        b = {k: torch.from_numpy(v).to(dev) for k, v in nb.items()
             if k != "labels"}
        with torch.no_grad():
            logits = tf.forward(cfg, p, b)
            cache = kvcache.make_cache(cfg, 2, 32, dtype=torch.float32,
                                       device=dev)
            if cfg.family == "encdec":
                cache = fill_cross(cfg, p, b["frames"], cache)
            last, cache = decode.prefill_via_decode(cfg, p, cache,
                                                    b["tokens"])
        outs[where] = (logits, last, cache)
    torch.cuda.synchronize()
    assert not any(kcuda.launch_counts().values())
    (lc, dc, cc), (lg, dg, cg) = outs["cpu"], outs["card"]
    _lm_close(lg, lc)
    _lm_close(dg, dc)
    assert int(cg["pos"]) == int(cc["pos"]) == 24
    want = dict(tree.leaves(cc))
    for name, t in tree.leaves(cg):
        assert t.device.type == "cuda", name
        _lm_close(t, want[name])


# ---------------------------------------------------------------------------
# the moe family's pieces: moe_ffn (its stats exact, its bf16 combine the
# same bits run to run) and MLA decode against the latent cache, on the
# card against the CPU
# ---------------------------------------------------------------------------

def _moe_block(arch, dev, dtype=torch.float32):
    from repro_torch.models import transformer as tf
    cfg, p_cpu, p_card, _ = _lm_world(arch, dev)
    def cast(p):
        return {k: v if k == "router" else v.to(dtype)
                for k, v in tf.layer(p, 0)["moe"].items()}
    return cfg, cast(p_cpu), cast(p_card)


@pytest.mark.parametrize("kw", [{}, {"capacity_factor": 8.0},
                                {"deterministic_capacity": 5}],
                         ids=["capacity_1.25", "drop_free", "deterministic"])
def test_moe_ffn_card_against_cpu(cuda, kw):
    """``load`` and ``dropped_frac`` equal, the output within 1e-4."""
    from repro_torch.models import moe
    cfg, p_cpu, p_card = _moe_block("deepseek_moe_16b", cuda)
    x = torch.from_numpy(np.random.default_rng(17).normal(
        size=(2, 40, 64)).astype(np.float32))
    want, wst = moe.moe_ffn(cfg, p_cpu, x, **kw)
    got, gst = moe.moe_ffn(cfg, p_card, x.to(cuda), **kw)
    _lm_close(got, want)
    assert torch.equal(gst.load.cpu(), wst.load)
    assert float(gst.dropped_frac) == float(wst.dropped_frac)


def test_moe_ffn_bf16_same_bits_run_to_run(cuda):
    """bf16 on the card, 2,048 tokens at a capacity of 400 (~500 pairs
    an expert, so many drop into the spare row at once): two runs give
    the same bits (the dispatch writes distinct slots and the combine
    adds in a fixed order: no atomic add), the stats equal the CPU's."""
    from repro_torch.models import moe
    cfg, p_cpu, p_card = _moe_block("deepseek_moe_16b", cuda,
                                    torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(18).normal(
        size=(4, 512, 64)).astype(np.float32)).to(torch.bfloat16)
    kw = {"deterministic_capacity": 400}
    first, st = moe.moe_ffn(cfg, p_card, x.to(cuda), **kw)
    again, _ = moe.moe_ffn(cfg, p_card, x.to(cuda), **kw)
    assert first.dtype == torch.bfloat16
    assert torch.equal(first.view(torch.int16), again.view(torch.int16))
    _, wst = moe.moe_ffn(cfg, p_cpu, x, **kw)
    assert torch.equal(st.load.cpu(), wst.load)
    assert float(st.dropped_frac) > 0


@pytest.mark.parametrize("pos", [5, 31, 40])
def test_mla_decode_card_against_cpu(cuda, pos):
    """One MLA decode layer against a noisy latent cache of 32 slots:
    the output and the written latent; at 40 the write past the cache
    is dropped (no index past S reaches the card)."""
    from repro_torch.serving import decode
    from repro_torch.models import transformer as tf
    cfg, p_cpu, p_card, _ = _lm_world("deepseek_v2_236b", cuda)
    rng = np.random.default_rng(pos)
    h = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    ckv = torch.from_numpy(rng.normal(size=(3, 32, 32)).astype(np.float32))
    kr = torch.from_numpy(rng.normal(size=(3, 32, 8)).astype(np.float32))
    outs = {}
    for where, p, dev in (("cpu", p_cpu, "cpu"), ("card", p_card, cuda)):
        c, k = ckv.to(dev), kr.to(dev)
        o = decode._mla_decode(cfg, tf.layer(p, 0)["attn"], h.to(dev), c, k,
                               torch.tensor(pos, dtype=torch.int32,
                                            device=dev))
        outs[where] = (o, c, k)
    for got, want in zip(outs["card"], outs["cpu"]):
        _lm_close(got, want)
    if pos >= 32:
        assert torch.equal(outs["card"][1].cpu(), ckv)


# ---------------------------------------------------------------------------
# the bf16 AdamW state (llama3-405b's and deepseek-v2-236b's training on
# the card) updated in slices
# ---------------------------------------------------------------------------

def test_apply_updates_bf16_state_card_against_cpu(cuda, monkeypatch):
    """bf16 params with a bf16 AdamW state (the 100B+ configs'), updated
    in slices of 4,096 elements (a leaf of 40,000 spans ten), on the
    card against the CPU: params, m and v within 1 bf16 ulp (float32
    ``sqrt`` is correctly rounded on the card, not always on the CPU),
    the grad norm of exact-sum gradients within 1 float32 ulp."""
    from repro_torch.training import optimizer as opt, tree
    monkeypatch.setattr(opt, "SLICE", 4096)
    rng = np.random.default_rng(12)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))
    p = {"w": t(rng.normal(0, 0.02, (200, 200))),
         "layers": {"router": t(rng.normal(0, 0.1, (2, 64, 8)))}}
    p["w"] = p["w"].to(torch.bfloat16)
    g = tree.rebuild(p, lambda _, x: t(rng.integers(
        -6, 7, tuple(x.shape)) * 2.0 ** -9).to(x.dtype))
    m = tree.rebuild(p, lambda _, x: t(rng.normal(
        0, 0.01, tuple(x.shape))).to(torch.bfloat16))
    v = tree.rebuild(p, lambda _, x: t(rng.uniform(
        0, 1e-3, tuple(x.shape))).to(torch.bfloat16))
    ocfg = opt.AdamWConfig(clip_norm=0.5, warmup_steps=10,
                           state_dtype=torch.bfloat16)
    out = {}
    for dev in ("cpu", cuda):
        def on(tr):
            return tree.rebuild(tr, lambda _, x: x.to(dev, copy=True))
        s = opt.OptState(step=torch.tensor(3, dtype=torch.int32,
                                           device=dev), m=on(m), v=on(v))
        out[str(dev)] = opt.apply_updates(ocfg, on(p), on(g), s)
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out[str(cuda)]
    gn_c, gn_g = float(mc["grad_norm"]), float(mg["grad_norm"])
    assert abs(gn_g - gn_c) <= float(np.spacing(np.float32(gn_c)))
    for a, b in zip(tree.leaves({"p": pg, "m": sg.m, "v": sg.v}),
                    tree.leaves({"p": pc, "m": sc.m, "v": sc.v})):
        x, y = a[1].cpu(), b[1]
        assert a[0] == b[0] and x.dtype == y.dtype, a[0]
        if x.dtype == torch.bfloat16:
            d = (x.view(torch.int16).int() - y.view(torch.int16).int()).abs()
            assert int(d.max()) <= 1, a[0]
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2.4e-7,
                                       atol=0, err_msg=a[0])


def test_engine_mesh_on_one_card_equals_one_rank(cuda, tmp_path):
    """Two ranks sharing the card over ``gloo`` (a 1x2 mesh, ranks
    spawned by ``tests/helpers/torch_mesh.py``): for each bank the serve
    step (both unions, with and without a staged buffer) and the point
    step equal the one-rank engine on the card field for field on both
    ranks (MLP rows with a cell-slot score within 1e-5 of the threshold
    reported, not compared); the two-tier stream clears ``r_truncated``
    with the workload's counts; each rank launched the engine's
    kernels."""
    from helpers.torch_mesh import spawn
    from repro_torch import bridge
    from repro_torch.core import build, device_tree as dt, engine, labels
    from repro_torch.core.aitree import cell_slot_probs
    from repro_torch.core.grid import cells_of_queries
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    pts = synth.tweets_like(2500, seed=0)
    qs = synth.synth_queries(pts, 2e-4, 150, seed=1)
    tree = dt.flatten(RTree(max_entries=32).insert_all(pts), device="cpu")
    wl = labels.make_workload(tree, qs)
    fits = {"knn": dict(grid_sizes=(6,)), "forest": dict(grid_sizes=(4,)),
            "mlp": dict(grid_sizes=(4,), mlp_hidden=16, mlp_epochs=400)}
    hyb = {k: build.fit_airtree(tree, wl, kind=k, max_pred=16, **f)[0]
           for k, f in fits.items()}
    p = pts[np.random.default_rng(5).integers(0, len(pts), 64)]
    q_point = np.concatenate([p, p], axis=1).astype(np.float32)
    xy = np.full((512, 2), np.inf, np.float32)
    xy[:300] = synth.tweets_like(300, seed=5)
    serve = [(k, u, d) for k in fits for u in ("topk", "pmax")
             for d in (False, True)]
    ranks = spawn(dict(mesh=(1, 2), device="cuda", hybrids=hyb, q=qs[:64],
                       xy=xy, q_point=q_point, stream=qs, max_visited=16,
                       serve=serve, point=list(fits), two_tier=list(fits)),
                  2, tmp_path)
    g = {k: bridge.hybrid_from_reference(h, cuda) for k, h in hyb.items()}
    for kind, union, delta in serve + [(k, "point", False) for k in fits]:
        q = q_point if union == "point" else qs[:64]
        keep = np.ones(q.shape[0], bool)
        if kind == "mlp":
            ids, _, _ = cells_of_queries(hyb[kind].ait.grid,
                                         torch.from_numpy(q), 4)
            sp = cell_slot_probs(hyb[kind].ait, torch.from_numpy(q), ids)
            keep = ~((sp - hyb[kind].ait.threshold).abs() < 1e-5).any(
                dim=(1, 2)).numpy()
        if union == "point":
            step = engine.make_point_serve_step(engine.EngineConfig(),
                                                kind=kind)
            key, args = ("point", kind), ()
        else:
            step = engine.make_serve_step(engine.EngineConfig(
                max_visited=16, score_union=union), kind=kind)
            key = ("serve", kind, union, delta)
            args = (_g(xy, cuda),) if delta else ()
        want = step(g[kind], _g(q, cuda), *args)
        for r, out in enumerate(ranks):
            for f in want._fields:
                np.testing.assert_array_equal(
                    getattr(out[key], f)[keep],
                    getattr(want, f).cpu().numpy()[keep],
                    err_msg=f"rank {r} {key} {f}")
    for r, out in enumerate(ranks):
        for kind in fits:
            first, rep = out[("two_tier", kind)]
            assert first.stats.r_truncated.any()
            assert not rep.stats.r_truncated.any()
            np.testing.assert_array_equal(rep.stats.n_results, wl.n_results)
        for name in ("traverse_compact", "leaf_refine", "forest_infer",
                     "mlp_predict_compact", "delta_probe", "spatial_key"):
            assert out["launches"][name] > 0, (r, name)
        assert out["launches"]["traverse_fused"] == 0, r


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_train_mesh_on_one_card_equals_one_rank(cuda, tmp_path, mesh):
    """Two ranks sharing the card over ``gloo`` train ``reduced(rwkv6_3b)``
    two steps (``tests/helpers/torch_mesh.py``'s ``step`` case): at 1x2
    every rank's gathered params, m and v, loss and grad norm equal the
    one-rank step on the card bit for bit; at 2x1 (the data ranks add
    their halves' gradients) loss and grad norm within 1e-5 relative and
    the state within 1e-4 of each leaf's largest value. Every rank
    launches ``wkv6`` 2 x depth times a step."""
    from helpers.torch_mesh import spawn
    from repro_torch import configs
    from repro_torch.launch import train as launch_train
    from repro_torch.training import optimizer as opt, train_loop, tree
    cfg = configs.reduced(configs.get_config("rwkv6_3b"))
    adamw = dict(lr=3e-4, warmup_steps=10, decay_steps=100)
    s0 = train_loop.init_train_state(
        cfg, torch.Generator(cuda).manual_seed(0), dtype=torch.float32,
        opt_cfg=opt.AdamWConfig(**adamw), device=cuda)
    batches = [launch_train.synthetic_batch(cfg, 8, 16, s) for s in (0, 1)]
    host = tree.rebuild(s0, lambda _, x: x.cpu())
    ranks = spawn(dict(device="cuda", train=[("step", dict(
        mesh=mesh, arch="rwkv6_3b", state=host, batches=batches,
        opt=adamw))]), 2, tmp_path)
    step = train_loop.make_train_step(cfg, opt_cfg=opt.AdamWConfig(**adamw))
    ms = []
    for b in batches:
        s0, m = step(s0, {k: v.to(cuda) for k, v in b.items()})
        ms.append({k: float(v) for k, v in m.items()})
    want = dict(tree.leaves(s0))
    for r, out in enumerate(ranks):
        res = out["train"][0]
        assert res["launches"]["wkv6"] == 2 * 2 * cfg.n_layers, r
        got = dict(tree.leaves(res["state"]))
        for k, w in want.items():
            w = w.cpu()
            if mesh == (1, 2):
                assert torch.equal(got[k], w), (r, k)
            else:
                top = float(w.abs().max()) if w.is_floating_point() else 0
                torch.testing.assert_close(got[k], w, rtol=0,
                                           atol=1e-4 * top, msg=(r, k))
        for g, w in zip(res["metrics"], ms):
            if mesh == (1, 2):
                assert g == w, r
            else:
                for key in ("loss", "grad_norm"):
                    assert abs(g[key] - w[key]) <= 1e-5 * abs(w[key]), \
                        (r, key)
