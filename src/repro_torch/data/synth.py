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
    # the reference shuffles the rows here; _dedup sorts them, so the
    # shuffle cannot change the result and is left out (it costs more
    # than the rest of the generator)
    return _dedup(np.concatenate([pts, noise]).astype(np.float64))


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
    # no shuffle: _dedup sorts (see tweets_like)
    return _dedup(np.concatenate([pts, bg]).astype(np.float64))


def _dedup(pts: np.ndarray) -> np.ndarray:
    """Paper preprocessing: drop exact duplicates. The rows come back
    sorted by (x, y), as ``np.unique(pts, axis=0)`` returns them; a
    lexsort of the two columns gets there in half the time."""
    s = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    return s[np.r_[True, np.any(s[1:] != s[:-1], axis=1)]]


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
    """Point buckets on a uniform grid for fast local neighbourhood queries.

    Points are kept sorted by cell (x-major), so the cells ``y0..y1`` of
    one grid column are one contiguous run of ``sorted_pts``."""

    def __init__(self, points: np.ndarray, bins: int = 256):
        self.lo = points.min(axis=0)
        span = np.maximum(points.max(axis=0) - self.lo, 1e-12)
        self.scale = bins / span
        self.bins = bins
        ij = np.clip(((points - self.lo) * self.scale).astype(int),
                     0, bins - 1)
        key = ij[:, 0] * bins + ij[:, 1]
        order = np.argsort(key, kind="stable")
        self.sorted_pts = points[order]
        key_sorted = key[order]
        self.starts = np.searchsorted(key_sorted, np.arange(bins * bins))
        self.ends = np.searchsorted(key_sorted, np.arange(bins * bins) + 1)
        # cnt[x, y]: points in the cells (< x, < y)
        cnt = np.zeros((bins + 1, bins + 1), np.int64)
        cnt[1:, 1:] = (self.ends - self.starts).reshape(bins, bins) \
            .cumsum(0).cumsum(1)
        self.cum = cnt

    def square(self, cx: int, cy: int, r: int) -> list[tuple[int, int]]:
        """The runs of ``sorted_pts`` in the cells within cell-radius r of
        (cx, cy), one per grid column, clipped to the grid."""
        b = self.bins
        y0, y1 = max(cy - r, 0), min(cy + r, b - 1)
        return [(int(self.starts[x * b + y0]), int(self.ends[x * b + y1]))
                for x in range(max(cx - r, 0), min(cx + r, b - 1) + 1)]

    def search_square(self, cx: int, cy: int, k: int
                      ) -> list[tuple[int, int]]:
        """The runs of the square the ring search stops at: the first
        cell-radius r >= 1 whose square holds at least k + 1 points, else
        the whole grid."""
        b, c = self.bins, self.cum
        for r in range(1, b):
            x0, x1 = max(cx - r, 0), min(cx + r, b - 1) + 1
            y0, y1 = max(cy - r, 0), min(cy + r, b - 1) + 1
            if c[x1, y1] - c[x0, y1] - c[x1, y0] + c[x0, y0] >= k + 1:
                return self.square(cx, cy, r)
        return self.square(cx, cy, b - 1)


def synth_queries(points: np.ndarray, selectivity: float, n_queries: int,
                  seed: int = 0, aspect_jitter: float = 2.0,
                  device=None) -> np.ndarray:
    """Fixed-selectivity rectangles centered on random data points.

    Exact calibration: the rectangle half-width is set to the k-th smallest
    anisotropic L∞ distance from the center, so each query returns exactly
    ≈ ``selectivity · N`` points (paper §V-B2: 0.00001 → ~20 of 2M, etc.).

    The k-th distance is taken over the points of the grid cells around
    the center (the first square of cell-radius ≥ 1 that holds k + 1 of
    them), in float64: with numpy on the host, or with torch on
    ``device`` (a dense city's square holds millions of points at tens of
    millions of points); both give the reference's widths exactly.
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
    if device is not None:
        import torch
        sp = torch.from_numpy(np.ascontiguousarray(gb.sorted_pts)).to(device)
    for i, c in enumerate(centers):
        ar = aspects[i] * ar_base
        cx = int(np.clip((c[0] - gb.lo[0]) * gb.scale[0], 0, gb.bins - 1))
        cy = int(np.clip((c[1] - gb.lo[1]) * gb.scale[1], 0, gb.bins - 1))
        runs = gb.search_square(cx, cy, k)
        if device is None:
            p = np.concatenate([gb.sorted_pts[s:e] for s, e in runs])
            m = np.maximum(np.abs(p[:, 0] - c[0]),
                           np.abs(p[:, 1] - c[1]) / ar)
            kk = min(k - 1, m.size - 1)
            mk = np.partition(m, kk)[kk]
        else:
            p = torch.cat([sp[s:e] for s, e in runs])
            # numpy's promotion: |p - c| in the points' type, the
            # division by the float64 aspect in float64
            m = torch.maximum(torch.abs(p[:, 0] - float(c[0])).double(),
                              torch.abs(p[:, 1] - float(c[1])).double()
                              / float(ar))
            mk = np.float64(torch.kthvalue(m, min(k, m.numel())).values)
        w = mk * 1.0000001 + 1e-12
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
