"""Parity of the port's serving kernels with the JAX package's.

Inputs are made with numpy from a seed and go through the JAX kernel
wrapper (``repro.kernels.ops``, Pallas in interpret mode here), the JAX
plain reference (``repro.kernels.ref``) and the port's dispatch
(``repro_torch.kernels.ops``), which on CPU tensors runs the plain
PyTorch version that the CUDA kernels are held against on the card.
Integer and bool outputs must be bit-equal; the forest's float votes
too (both sum trees in ascending order). MLP scores agree within 1e-5;
a predicted-leaf row whose score lies within 1e-5 of the threshold is
reported, not failed. kNN distances are bit-equal to the JAX reference
evaluated op by op, and within 1 ulp of the jitted Pallas kernel, where
XLA:CPU may contract ``dx*dx + dy*dy`` into an FMA.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import traversal as jtrav  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels import spatial_key as jskey  # noqa: E402
from repro_torch.data.synth import strip_queries  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py); the card's
# environment may carry another top-level ``tests`` package
from helpers.torch_inputs import (  # noqa: E402
    edge_bank, edge_queries, key_centres, knn_inputs, levels, rects)
from test_torch_cuda import refine_inputs, router_inputs  # noqa: E402

NEAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_levels", [3, 1])
def test_traverse_fused_matches_jax(n_levels):
    """Dense visited mask, bit-equal, on a 3-level tree and on the
    single-level tree (root == leaves)."""
    rng = np.random.default_rng(0)
    mbrs, parents = levels(rng)
    if n_levels == 1:
        mbrs, parents = mbrs[-1:], [np.zeros(len(mbrs[-1]), np.int32)]
    q = edge_queries(rng, mbrs[-1])
    want_k = np.asarray(jops.traverse_fused(
        jnp.asarray(q), [jnp.asarray(m) for m in mbrs],
        [jnp.asarray(p) for p in parents]))
    want_r = np.asarray(jref.traverse_fused(
        jnp.asarray(q), [jnp.asarray(m) for m in mbrs],
        [jnp.asarray(p) for p in parents]))
    got = tops.traverse_fused(_t(q), [_t(m) for m in mbrs],
                              [_t(p) for p in parents]).numpy()
    np.testing.assert_array_equal(want_k, want_r)
    np.testing.assert_array_equal(got, want_k)
    assert not got[0].any() and got.sum() > 0


def test_leaf_refine_matches_jax():
    """Per-entry containment over named leaves: +inf padding never
    matches, invalid slots (including out-of-range ids, which the
    wrapper clamps) are all False, an all-invalid row stays empty."""
    rng = np.random.default_rng(1)
    L, M, B, K = 50, 16, 24, 8
    ent = rng.uniform(0, 1, (L, M, 2)).astype(np.float32)
    ent[:, 12:] = np.inf
    q = rects(rng, B, 0, 0.8, 0.4)
    q[1] = [ent[4, 2, 0], ent[4, 2, 1], ent[4, 2, 0], ent[4, 2, 1]]
    idx = rng.integers(0, L, (B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) < 0.75
    idx[2, :3] = [-1, L, L + 7]
    valid[2, :3] = False
    valid[3] = False                                    # empty row
    idx[1, 0], valid[1, 0] = 4, True
    want = np.asarray(jops.leaf_refine(jnp.asarray(q), jnp.asarray(ent),
                                       jnp.asarray(idx), jnp.asarray(valid)))
    got = tops.leaf_refine(_t(q), _t(ent), _t(idx), _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[3].any() and got[1, 0, 2]


def test_forest_infer_matches_jax_bit_exact():
    """Summed votes of the router's shape (T=16, D=6, C=1), with some
    features exactly on their thresholds (``>`` is strict)."""
    rng = np.random.default_rng(2)
    B, F, T, D = 37, 6, 16, 6
    x = rng.normal(size=(B, F)).astype(np.float32)
    fi = rng.integers(0, F, (T, D)).astype(np.int32)
    th = rng.normal(size=(T, D)).astype(np.float32)
    x[0, fi[0, 0]] = th[0, 0]
    x[1, fi[3, 2]] = th[3, 2]
    tb = rng.uniform(0, 1, (T, 2 ** D, 1)).astype(np.float32)
    want = np.asarray(jops.forest_infer(jnp.asarray(x), jnp.asarray(fi),
                                        jnp.asarray(th), jnp.asarray(tb)))
    got = tops.forest_infer(_t(x), _t(fi), _t(th), _t(tb)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M,K", [(16, 8), (8, 1), (128, 64)])
def test_leaf_refine_counted_matches_jax(M, K):
    """The counted refine, bit-equal to the JAX package on the edge rows
    (an all-invalid row; out-of-range ids, masked and valid): the mask to
    its interpret-mode kernel, the counts to its ``refine_leaves``."""
    rng = np.random.default_rng(100 + M + K)
    q, ent, idx, valid = refine_inputs(rng, 50, M, 24, K)
    jq, jent, jidx, jvalid = map(jnp.asarray, (q, ent, idx, valid))
    want = np.asarray(jops.leaf_refine(jq, jent, jidx, jvalid))
    want_counts = np.asarray(jtrav.refine_leaves(
        _Tree(jent), jq, jidx, jvalid, use_kernel=True).counts)
    got, counts = tops.leaf_refine_counted(_t(q), _t(ent), _t(idx),
                                           _t(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(
        tops.leaf_refine(_t(q), _t(ent), _t(idx), _t(valid)).numpy(), want)
    assert not got[3].any() and got[1, 0, 2] and counts[1, 0] >= 1


@pytest.mark.parametrize("T", [1, 16])
@pytest.mark.parametrize("D", [1, 8])
@pytest.mark.parametrize("C", [1, 3])
def test_forest_infer_on_thresholds_matches_jax(T, D, C):
    """Summed votes, bit-equal, with two queries exactly on a threshold,
    for one tree and sixteen, depth 1 and 8, one class and three."""
    rng = np.random.default_rng(T + 10 * D + 100 * C)
    x, fi, th, tb = router_inputs(rng, 37, T, D, C)
    want = np.asarray(jops.forest_infer(*map(jnp.asarray, (x, fi, th, tb))))
    got = tops.forest_infer(_t(x), _t(fi), _t(th), _t(tb)).numpy()
    np.testing.assert_array_equal(got, want)


class _Tree:
    """The one field of a ``DeviceTree`` that ``refine_leaves`` reads."""

    def __init__(self, leaf_entries):
        self.leaf_entries = leaf_entries


class _Bank:
    """MLPBank-shaped container for the kernel wrappers of both
    packages (duck-typed: both read attributes only)."""

    def __init__(self, conv, **arrays):
        for k, v in arrays.items():
            setattr(self, k, conv(v))


def _near_rows(scores, threshold):
    return np.flatnonzero(
        (np.abs(scores - threshold) < NEAR).any(axis=1))


def test_mlp_predict_compact_matches_jax():
    """Compact slot table and distinct count, bit-equal, on the edge
    rows (empty, exactly k, k + 1 overflow, duplicate leaves across
    cells, padded slots) and on random rows; scores within 1e-5."""
    rng = np.random.default_rng(3)
    L, k, B, S = 200, 6, 48, 4
    arrays = edge_bank(rng, L, k)
    q = rng.normal(size=(B, 4)).astype(np.float32)
    cid = rng.integers(0, 8, (B, S)).astype(np.int32)
    ok = rng.uniform(size=(B, S)) < 0.8
    edge = {0: ([3, 3, 3, 3], [True] * 4),            # 0 predicted
            1: ([0, 3, 3, 3], [True] * 4),            # exactly k
            2: ([0, 1, 3, 3], [True] * 4),            # k + 1
            3: ([0, 2, 3, 3], [True] * 4),            # duplicates
            4: ([0, 1, 5, 6], [False] * 4),           # all padded
            5: ([1, 0, 9, -4], [True, True, False, False])}  # bad ids
    for r, (c, v) in edge.items():
        cid[r], ok[r] = c, v
    jb = _Bank(jnp.asarray, **arrays)
    tb = _Bank(_t, **arrays)
    want = [np.asarray(a) for a in jops.mlp_predict_compact(
        jnp.asarray(q), jb, jnp.asarray(cid), jnp.asarray(ok),
        n_leaves=L, k=k, threshold=0.5)]
    got = [a.numpy() for a in tops.mlp_predict_compact(
        _t(q), tb, _t(cid), _t(ok), n_leaves=L, k=k, threshold=0.5)]
    cid_c = np.clip(cid, 0, 7)
    j_scores = np.asarray(jref.mlp_predict_scores(
        jnp.asarray(q), jnp.asarray(cid_c), jnp.asarray(ok), jb.w1, jb.b1,
        jb.w2, jb.b2, jb.label_map, jb.lmask, L))
    t_scores = tref.mlp_predict_scores(
        _t(q), _t(cid_c), _t(ok), tb.w1, tb.b1, tb.w2, tb.b2, tb.label_map,
        tb.lmask, L).numpy()
    np.testing.assert_allclose(t_scores, j_scores, rtol=0, atol=NEAR)
    near = _near_rows(j_scores, 0.5)
    if near.size:
        print(f"near-threshold rows (reported, not compared): {near}")
    keep = np.setdiff1d(np.arange(B), near)
    for name, g, w in zip(("leaf_idx", "valid", "count"), got, want):
        np.testing.assert_array_equal(g[keep], w[keep], err_msg=name)
    count = got[2]
    assert count[0] == 0 and count[1] == k and count[2] == k + 1
    assert count[3] == k and count[4] == 0
    np.testing.assert_array_equal(got[0][2], np.arange(10, 10 + k))


@pytest.mark.parametrize("n_levels", [3, 1])
def test_traverse_compact_matches_jax(n_levels):
    """Slot table, validity and visited count, bit-equal to the JAX
    kernel (interpret mode) and to ``compact_mask_counted`` of the walk,
    with rows visiting 0, exactly k and k + 1 leaves, and k past L."""
    rng = np.random.default_rng(4)
    mbrs, parents = levels(rng)
    if n_levels == 1:
        mbrs, parents = mbrs[-1:], [np.zeros(len(mbrs[-1]), np.int32)]
    L = len(mbrs[-1])
    for k in (6, 40, L + 3):
        q = np.concatenate([edge_queries(rng, mbrs[-1]),
                            strip_queries(mbrs[-1], [0, k, k + 1]
                                          if k < L else [0, L])])
        jargs = (jnp.asarray(q), [jnp.asarray(m) for m in mbrs],
                 [jnp.asarray(p) for p in parents], k)
        want = [np.asarray(a) for a in jops.traverse_compact(*jargs)]
        got = [a.numpy() for a in tops.traverse_compact(
            _t(q), [_t(m) for m in mbrs], [_t(p) for p in parents], k)]
        for name, g, w in zip(("leaf_idx", "valid", "count"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{name}, k={k}")
        n = len(q)
        if k < L:
            np.testing.assert_array_equal(got[2][n - 3:], [0, k, k + 1])
        else:
            np.testing.assert_array_equal(got[2][n - 2:], [0, L])
        assert got[2][0] == 0 and (got[0][~got[1]] == 0).all()


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_spatial_key_matches_jax(curve):
    """Keys of normalized centres, bit-equal to the JAX kernel
    (interpret mode) and reference, with the edge rows: corners (1.0
    clips to 32767), outside the frame, exact quantization steps."""
    c = key_centres(np.random.default_rng(5))
    got = tref.spatial_key(_t(c), curve=curve).numpy()
    fin = np.isfinite(c).all(axis=1) & (np.abs(c) < 4).all(axis=1)
    n = int(fin.sum())
    cp = np.pad(c[fin], ((0, -n % 128), (0, 0)))    # the kernel's tiling
    want_k = np.asarray(jskey.spatial_key_t(jnp.asarray(cp.T), curve=curve,
                                            tb=128, interpret=True))[0, :n]
    want_r = np.asarray(jref.spatial_key(jnp.asarray(c[fin]), curve=curve))
    np.testing.assert_array_equal(want_k, want_r)
    np.testing.assert_array_equal(got[fin], want_r)
    # values whose f32→i32 cast overflows: the clip's ends
    far = tref.spatial_key(_t(np.clip(c[~fin], -2, 2)), curve=curve)
    np.testing.assert_array_equal(got[~fin], far.numpy())
    assert got[1] == got[12]        # (1, 1) clips to (32767, 32767)


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_spatial_key_wrapper_matches_jax(curve):
    """Centre normalization + keys through both wrappers, with the
    batch's own frame, a caller frame and a zero-extent frame."""
    q = rects(np.random.default_rng(6), 300, -3, 3, 0.5)
    for bbox in (None, np.array([-1, -2, 1, 2], np.float32),
                 np.array([0.5, 0.5, 0.5, 0.5], np.float32)):
        jb = None if bbox is None else jnp.asarray(bbox)
        tb = None if bbox is None else _t(bbox)
        want = np.asarray(jops.spatial_key(jnp.asarray(q), bbox=jb,
                                           curve=curve))
        got = tops.spatial_key(_t(q), tb, curve=curve).numpy()
        np.testing.assert_array_equal(got, want)


def test_knn_browse_matches_jax():
    """Distances over named leaves: +inf padding, invalid and clamped
    out-of-range slots, an all-invalid row, an entry exactly at r²."""
    c3, ent, idx, valid = knn_inputs(np.random.default_rng(7))
    got = tops.knn_browse(_t(c3), _t(ent), _t(idx), _t(valid)).numpy()
    safe = np.clip(idx, 0, len(ent) - 1)
    want_r = np.asarray(jref.knn_browse(
        jnp.asarray(c3), jnp.asarray(ent[..., 0]), jnp.asarray(ent[..., 1]),
        jnp.asarray(safe), jnp.asarray(valid)))     # eager: no contraction
    np.testing.assert_array_equal(got, want_r)
    want_k = np.asarray(jops.knn_browse(jnp.asarray(c3), jnp.asarray(ent),
                                        jnp.asarray(idx), jnp.asarray(valid)))
    fin = np.isfinite(got) & np.isfinite(want_k)
    np.testing.assert_array_max_ulp(got[fin], want_k[fin], maxulp=1)
    differ = np.isfinite(got) != np.isfinite(want_k)
    assert not differ[:, :, 1:].any() and not differ[[0] + list(
        range(2, len(got)))].any(), "only the on-radius entry may flip"
    assert got[1, 0, 0] == c3[1, 2] and np.isinf(got[3]).all()
    assert np.isinf(got[:, :, 12:]).all() and np.isfinite(got).any()
