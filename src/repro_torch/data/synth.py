"""Synthetic stand-ins for the paper's UCR-STAR datasets + query synthesis.

The paper evaluates on Tweet locations (2M points) and Chicago Crimes
(872K points). UCR-STAR is not reachable offline, so we generate datasets
with the same statistical character:

* ``tweets_like``  — heavy multi-scale clustering (cities over continents):
  a hierarchical Gaussian mixture (clusters of clusters) + uniform noise.
* ``crimes_like``  — a single metro area: anisotropic street-grid-aligned
  density with hot blocks + uniform urban background.

Query synthesis follows §V-B2: rectangles of fixed *selectivity* (fraction
of the dataset returned), centered on data points (so results are non-empty),
with jittered aspect ratios. A summed-area table gives O(1) approximate
counts for calibrating rectangle sizes; exact counts/α come from executing
the queries on the R-tree afterwards (exactly how the paper categorizes its
workloads).
"""
from __future__ import annotations

import numpy as np


def tweets_like(n: int = 200_000, seed: int = 0) -> np.ndarray:
    """Hierarchical clustered point cloud in [0, 360] × [-90, 90]-ish."""
    rng = np.random.default_rng(seed)
    n_super = 12                       # continents / regions
    n_sub = 40                         # cities per region
    sup = rng.uniform([0, -60], [360, 70], size=(n_super, 2))
    sub = (sup[rng.integers(0, n_super, n_sub)]
           + rng.normal(0, 8.0, (n_sub, 2)))
    frac_noise = 0.05
    n_noise = int(n * frac_noise)
    n_clustered = n - n_noise
    which = rng.integers(0, n_sub, n_clustered)
    scale = rng.gamma(2.0, 0.35, n_sub)[which][:, None]
    pts = sub[which] + rng.normal(0, 1.0, (n_clustered, 2)) * scale
    noise = rng.uniform([0, -90], [360, 90], size=(n_noise, 2))
    out = np.concatenate([pts, noise]).astype(np.float64)
    rng.shuffle(out)
    return _dedup(out)


def crimes_like(n: int = 87_000, seed: int = 1) -> np.ndarray:
    """Single-metro anisotropic density with hot blocks (Chicago-ish)."""
    rng = np.random.default_rng(seed)
    n_hot = 60
    hot = rng.uniform([0, 0], [40, 60], size=(n_hot, 2))
    weights = rng.gamma(1.5, 1.0, n_hot)
    weights /= weights.sum()
    n_bg = int(n * 0.25)
    which = rng.choice(n_hot, size=n - n_bg, p=weights)
    pts = hot[which] + rng.normal(0, 0.8, (n - n_bg, 2)) * \
        np.array([1.0, 2.5])           # N-S elongated city
    # snap a fraction to a street grid (crime records geocode to blocks)
    snap = rng.uniform(size=n - n_bg) < 0.5
    pts[snap] = np.round(pts[snap] * 20) / 20 + rng.normal(
        0, 0.004, (int(snap.sum()), 2))
    bg = rng.uniform([0, 0], [40, 60], size=(n_bg, 2))
    out = np.concatenate([pts, bg]).astype(np.float64)
    rng.shuffle(out)
    return _dedup(out)


def _dedup(pts: np.ndarray) -> np.ndarray:
    """Paper preprocessing: drop exact duplicates."""
    return np.unique(pts, axis=0)


class SummedAreaTable:
    """O(1) approximate rectangle counts over a point set."""

    def __init__(self, points: np.ndarray, bins: int = 1024):
        self.lo = points.min(axis=0)
        self.hi = points.max(axis=0)
        span = np.maximum(self.hi - self.lo, 1e-12)
        self.scale = bins / span
        self.bins = bins
        ix = np.clip(((points[:, 0] - self.lo[0]) * self.scale[0]).astype(int),
                     0, bins - 1)
        iy = np.clip(((points[:, 1] - self.lo[1]) * self.scale[1]).astype(int),
                     0, bins - 1)
        hist = np.zeros((bins, bins), np.float64)
        np.add.at(hist, (ix, iy), 1.0)
        self.sat = hist.cumsum(0).cumsum(1)

    def count(self, rect: np.ndarray) -> float:
        x0, y0, x1, y1 = rect
        ix0 = int(np.clip((x0 - self.lo[0]) * self.scale[0], 0, self.bins - 1))
        iy0 = int(np.clip((y0 - self.lo[1]) * self.scale[1], 0, self.bins - 1))
        ix1 = int(np.clip((x1 - self.lo[0]) * self.scale[0], 0, self.bins - 1))
        iy1 = int(np.clip((y1 - self.lo[1]) * self.scale[1], 0, self.bins - 1))
        s = self.sat
        tot = s[ix1, iy1]
        if ix0 > 0:
            tot -= s[ix0 - 1, iy1]
        if iy0 > 0:
            tot -= s[ix1, iy0 - 1]
        if ix0 > 0 and iy0 > 0:
            tot += s[ix0 - 1, iy0 - 1]
        return float(tot)


class _GridBuckets:
    """Point buckets on a uniform grid for fast local neighbourhood queries."""

    def __init__(self, points: np.ndarray, bins: int = 256):
        self.pts = points
        self.lo = points.min(axis=0)
        span = np.maximum(points.max(axis=0) - self.lo, 1e-12)
        self.scale = bins / span
        self.bins = bins
        ij = np.clip(((points - self.lo) * self.scale).astype(int),
                     0, bins - 1)
        key = ij[:, 0] * bins + ij[:, 1]
        order = np.argsort(key, kind="stable")
        self.sorted_idx = order
        self.key_sorted = key[order]
        self.starts = np.searchsorted(self.key_sorted,
                                      np.arange(bins * bins))
        self.ends = np.searchsorted(self.key_sorted,
                                    np.arange(bins * bins) + 1)

    def ring(self, cx: int, cy: int, r: int) -> np.ndarray:
        """Point indices in the square ring of cell-radius r around (cx,cy)."""
        b = self.bins
        cells = []
        x0, x1 = max(cx - r, 0), min(cx + r, b - 1)
        y0, y1 = max(cy - r, 0), min(cy + r, b - 1)
        for x in range(x0, x1 + 1):
            for y in range(y0, y1 + 1):
                if r == 0 or x in (cx - r, cx + r) or y in (cy - r, cy + r):
                    k = x * b + y
                    s, e = self.starts[k], self.ends[k]
                    if e > s:
                        cells.append(self.sorted_idx[s:e])
        return np.concatenate(cells) if cells else np.empty(0, np.int64)


def synth_queries(points: np.ndarray, selectivity: float, n_queries: int,
                  seed: int = 0, aspect_jitter: float = 2.0) -> np.ndarray:
    """Fixed-selectivity rectangles centered on random data points.

    Exact calibration: the rectangle half-width is set to the k-th smallest
    anisotropic L∞ distance from the center, so each query returns exactly
    ≈ ``selectivity · N`` points (paper §V-B2: 0.00001 → ~20 of 2M, etc.).
    """
    rng = np.random.default_rng(seed)
    n = points.shape[0]
    k = max(1, int(round(selectivity * n)))
    gb = _GridBuckets(points)
    out = np.empty((n_queries, 4), np.float64)
    centers = points[rng.integers(0, n, n_queries)]
    aspects = np.exp(rng.uniform(-np.log(aspect_jitter),
                                 np.log(aspect_jitter), n_queries))
    span = (points.max(axis=0) - points.min(axis=0))
    ar_base = span[1] / span[0]
    for i, c in enumerate(centers):
        ar = aspects[i] * ar_base
        cx = int(np.clip((c[0] - gb.lo[0]) * gb.scale[0], 0, gb.bins - 1))
        cy = int(np.clip((c[1] - gb.lo[1]) * gb.scale[1], 0, gb.bins - 1))
        got: list[np.ndarray] = []
        total = 0
        r = 0
        # expand rings until we certainly contain the k-th neighbour
        while r < gb.bins:
            ring = gb.ring(cx, cy, r)
            if ring.size:
                got.append(ring)
                total += ring.size
            if total >= k + 1 and r >= 1:
                break
            r += 1
        idx = np.concatenate(got) if got else np.arange(n)
        p = points[idx]
        m = np.maximum(np.abs(p[:, 0] - c[0]), np.abs(p[:, 1] - c[1]) / ar)
        m.sort()
        w = m[min(k - 1, m.size - 1)] * 1.0000001 + 1e-12
        out[i] = (c[0] - w, c[1] - ar * w, c[0] + w, c[1] + ar * w)
    return out.astype(np.float32)


def strip_queries(leaf_mbrs: np.ndarray, counts) -> np.ndarray:
    """Full-width horizontal strips that visit exactly ``c`` leaves for
    each ``c`` in ``counts`` — edge rows for the compacting walk: every
    ancestor MBR contains its leaves', so a strip from below the tree to
    height Y visits exactly the leaves whose bottom edge is at most Y.
    A count the leaves' bottom edges cannot give exactly (ties) raises."""
    leaf = np.asarray(leaf_mbrs, np.float32)
    lo = np.sort(leaf[:, 1])
    x0, x1 = leaf[:, 0].min() - 1, leaf[:, 2].max() + 1
    rows = []
    for c in counts:
        if c and c < len(lo) and lo[c] == lo[c - 1]:
            raise ValueError(f"no strip visits exactly {c} leaves")
        y = lo[c - 1] if c else lo[0] - 1
        rows.append([x0, lo[0] - 2, x1, y])
    return np.asarray(rows, np.float32)
