"""Seeded numpy inputs with edge rows for the PyTorch port's kernel tests.

Shared by ``tests/test_torch_kernels.py`` (plain versions against the JAX
package, on the CPU) and ``tests/test_torch_cuda.py`` (CUDA kernels
against the plain versions, on the card, where JAX is not installed), so
this module imports only numpy.
"""
import numpy as np


def rects(rng, n, lo=0.0, hi=1.0, size=0.1):
    a = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    return np.concatenate(
        [a, a + rng.uniform(0, size, (n, 2)).astype(np.float32)], 1)


def levels(rng, L=300, n1=12):
    """A three-level tree: root, n1 internal nodes, L leaves, with
    contiguous children and tight MBRs (as ``flatten`` lays them out)."""
    leaf = rects(rng, L, size=0.08)
    lp = np.sort(rng.integers(0, n1, L)).astype(np.int32)
    mid = np.array([[2, 2, -2, -2]] * n1, np.float32)
    for i in range(n1):
        s = leaf[lp == i]
        if len(s):
            mid[i] = [s[:, 0].min(), s[:, 1].min(), s[:, 2].max(),
                      s[:, 3].max()]
    root = np.array([[mid[:, 0].min(), mid[:, 1].min(), mid[:, 2].max(),
                      mid[:, 3].max()]], np.float32)
    return ([root, mid, leaf],
            [np.zeros(1, np.int32), np.zeros(n1, np.int32), lp])


def edge_queries(rng, leaf):
    """Random rects plus the edge rows: empty (far away), a degenerate
    rect exactly on a leaf's corner, one touching an MBR edge."""
    q = rects(rng, 40, -0.1, 1.0, 0.15)
    q[0] = [5, 5, 6, 6]                                  # empty
    q[1] = [leaf[3, 0], leaf[3, 1], leaf[3, 0], leaf[3, 1]]
    q[2] = [leaf[7, 2], leaf[7, 1], leaf[7, 2] + 0.01, leaf[7, 3]]
    return q


def edge_bank(rng, L=200, k=6):
    """A bank whose predictions are set by the biases alone (w = 0), so
    rows can be pinned to 0, exactly k, and k + 1 predicted leaves.

    Cell 0 predicts k distinct leaves, cell 1 one more leaf, cell 2 the
    same leaves as cell 0 (a duplicate across cells counts once), cell 3
    nothing. Cells 4.. are random.
    """
    C, F, H, Cl = 8, 4, 8, k + 2
    w1 = rng.normal(0, 1, (C, F, H)).astype(np.float32)
    w2 = rng.normal(0, 1, (C, H, Cl)).astype(np.float32)
    b1 = rng.normal(0, 1, (C, H)).astype(np.float32)
    b2 = rng.normal(0, 1, (C, Cl)).astype(np.float32)
    lm = rng.integers(0, L, (C, Cl)).astype(np.int32)
    lmask = rng.uniform(size=(C, Cl)) < 0.8
    pinned = np.arange(10, 10 + k + 1, dtype=np.int32)
    for c in range(4):
        w1[c] = 0
        w2[c] = 0
        b2[c] = -9.0
        lmask[c] = True
    lm[0, :k], b2[0, :k] = pinned[:k], 9.0
    lm[1, 0], b2[1, 0] = pinned[k], 9.0
    lm[2, :k], b2[2, :k] = pinned[:k], 9.0
    lm[3] = pinned[0]
    lm[~lmask] = -1
    return dict(w1=w1, b1=b1, w2=w2, b2=b2, mu=np.zeros(F, np.float32),
                sd=np.ones(F, np.float32), label_map=lm, lmask=lmask)


def key_centres(rng, n=200, order=15):
    """Normalized centres for the curve keys: random ones plus the edge
    rows — the frame's corners (1.0 clips to 2^order - 1), points
    outside it, exact quantization steps and the floats just below."""
    c = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    steps = (np.array([1, 2, 3, 1000, 2 ** order - 1], np.float32)
             / np.float32(2 ** order))
    edge = [[0, 0], [1, 1], [0, 1], [1, 0], [-0.5, 1.5], [1.5, -0.25],
            [-1e10, 1e10], [np.inf, -np.inf]]
    edge += [[s, s] for s in steps]
    edge += [[np.nextafter(s, np.float32(0)), s] for s in steps]
    return np.concatenate([np.asarray(edge, np.float32), c])


def knn_inputs(rng, L=50, M=16, B=24, K=8, fill=12):
    """Browse inputs: leaves of ``fill`` entries (+inf padded to M),
    centres with r², random slots with invalid and out-of-range ones, an
    all-invalid row 3, and row 1's first entry exactly on its radius."""
    ent = rng.uniform(0, 1, (L, M, 2)).astype(np.float32)
    ent[:, fill:] = np.inf
    c = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    r2 = rng.uniform(0.01, 0.2, (B, 1)).astype(np.float32)
    idx = rng.integers(0, L, (B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) < 0.75
    idx[2, :3] = [-1, L, L + 7]
    valid[2, :3] = False
    valid[3] = False                                     # empty row
    idx[1, 0], valid[1, 0] = 4, True
    dx = ent[4, 0, 0] - c[1, 0]
    dy = ent[4, 0, 1] - c[1, 1]
    r2[1, 0] = np.float32(dx * dx) + np.float32(dy * dy)  # d2 == r2
    return np.concatenate([c, r2], axis=1), ent, idx, valid


def knn_tie_inputs(rng, L=40, M=16, B=24, K=8, fill=12, grid=16):
    """Tie-heavy browse inputs ``(c3 [B, 3], entries [L, M, 2], entry_ids
    [L, M], leaf_idx [B, K], valid [B, K])`` for the selecting form.

    Entries and centres lie on a ``1/grid`` lattice, so every squared
    distance is exact (no rounding, hence no FMA contraction either) and
    equal distances abound; leaf 1 repeats leaf 0, entry 3 of every leaf
    repeats entry 2, and rows name the same leaf in several slots (row 5
    names leaves 0 and 1 alternately). Entries past ``fill`` are +inf
    padding with id -1. Edge rows: 0 has r² < 0 (nothing in radius), 1 an
    entry exactly at d2 == r², 2 out-of-range ids on invalid slots, 3 all
    invalid, 4 out-of-range ids on valid slots (clamped into [0, L)), 6 a
    radius below the lattice step (only coincident points), 7 r² = +inf
    (every finite entry, never the padding)."""
    g = np.float32(grid)
    ent = (rng.integers(0, grid, (L, M, 2)) / g).astype(np.float32)
    ent[:, 3] = ent[:, 2]
    ent[1] = ent[0]
    ent[:, fill:] = np.inf
    ids = np.arange(L * M, dtype=np.int32).reshape(L, M)
    ids[:, fill:] = -1
    c = (rng.integers(0, grid, (B, 2)) / g).astype(np.float32)
    r2 = rng.choice(np.array([1, 4, 16, 64], np.float32) / g ** 2, (B, 1))
    idx = rng.integers(0, L, (B, K)).astype(np.int32)
    idx[:, 1::3] = idx[:, 0:1]
    valid = rng.uniform(size=(B, K)) < 0.8
    r2[0, 0] = -1
    idx[1, 0], valid[1, 0] = 4, True
    dx, dy = ent[4, 0] - c[1]
    r2[1, 0] = np.float32(dx * dx) + np.float32(dy * dy)  # d2 == r2
    idx[2, :3] = [-1, L, L + 7][:K]
    valid[2, :3] = False
    valid[3] = False                                     # empty row
    idx[4, :2] = [-3, L + 2][:K]
    valid[4, :2] = True
    idx[5] = np.arange(K) % 2
    valid[5] = True
    r2[6, 0] = 0.25 / g ** 2
    r2[7, 0] = np.inf
    return np.concatenate([c, r2], axis=1), ent, ids, idx, valid


def delta_inputs(rng, B, cap, fill, k):
    """Delta-probe inputs: a [cap, 2] buffer with ``fill`` staged points
    (+inf past them) and [B, 4] query rects with the edge rows.

    When ``fill > k`` the first ``k + 1`` points lie on the line y = 5 at
    x = 5 + i/1024 (exact in f32, away from the random points in
    [-1, 1]²), and rows 1–3 are degenerate-in-y rects whose edges pass
    through them: row 1 holds exactly k hits, row 2 k + 1, row 3 has its
    lower-left corner on point 2 (k - 1 hits). Row 0 hits nothing.
    """
    pts = np.full((cap, 2), np.inf, np.float32)
    pts[:fill] = rng.uniform(-1, 1, (fill, 2))
    lo = rng.uniform(-1, 1, (B, 2))
    q = np.concatenate([lo, lo + rng.uniform(0, 0.5, (B, 2))],
                       1).astype(np.float32)
    q[0] = [7, 7, 8, 8]
    if fill > k and B >= 4:
        step = np.float32(1 / 1024)
        pts[:k + 1, 0] = 5 + np.arange(k + 1, dtype=np.float32) * step
        pts[:k + 1, 1] = 5
        q[1] = [5, 5, 5 + (k - 1) * step, 5]
        q[2] = [5, 5, 5 + k * step, 5]
        q[3] = [5 + 2 * step, 5, 6, 6]
    return q, pts


def near_radius_rows(pts, q, radii):
    """Rows with any point whose f32 d2 lies within 1 ulp of a probe
    radius² (either rounding of d2 may put it on either side)."""
    c = q[:, :2].astype(np.float32)
    p = np.asarray(pts, np.float32)
    dx = p[None, :, 0] - c[:, None, 0]
    dy = p[None, :, 1] - c[:, None, 1]
    d2 = dx * dx + dy * dy
    rows = set()
    for r in radii:
        r2 = np.float32(r) * np.float32(r)
        near = np.abs(d2 - r2) <= 2 * np.spacing(r2)
        rows |= set(np.flatnonzero(near.any(axis=1)).tolist())
    if rows:
        print(f"rows within 1 ulp of r² (reported, not compared): "
              f"{sorted(rows)}")
    return sorted(rows)


def forest_cells_inputs(rng, B, C, T, D, Cl, F=6):
    """Celled-forest inputs ``(features [B, F], feat_idx [C·T, D],
    thresh [C·T, D], tables [C·T, 2^D, Cl])``: feature ids at both ends
    of [0, F), cell 1 empty (``thresh = +inf``: every query takes leaf
    0), and query 0 exactly on its first threshold (not greater)."""
    feats = rng.uniform(-1, 1, (B, F)).astype(np.float32)
    fi = rng.integers(0, F, (C * T, D)).astype(np.int32)
    fi[0, 0], fi[-1, -1] = 0, F - 1
    th = rng.uniform(-1, 1, (C * T, D)).astype(np.float32)
    th[T:2 * T] = np.inf
    if B:
        feats[0, fi[0, 0]] = th[0, 0]
    tb = rng.uniform(0, 1, (C * T, 2 ** D, Cl)).astype(np.float32)
    return feats, fi, th, tb
