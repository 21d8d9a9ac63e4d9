"""Parity of the port's four serving kernels with the JAX package's.

Inputs are made with numpy from a seed and go through the JAX kernel
wrapper (``repro.kernels.ops``, Pallas in interpret mode here), the JAX
plain reference (``repro.kernels.ref``) and the port's dispatch
(``repro_torch.kernels.ops``), which on CPU tensors runs the plain
PyTorch version that the CUDA kernels are held against on the card.
Integer and bool outputs must be bit-equal; the forest's float votes
too (both sum trees in ascending order). MLP scores agree within 1e-5;
a predicted-leaf row whose score lies within 1e-5 of the threshold is
reported, not failed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
# pytest puts tests/ on sys.path (it has no __init__.py); the card's
# environment may carry another top-level ``tests`` package
from helpers.torch_inputs import (  # noqa: E402
    edge_bank, edge_queries, levels, rects)

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
