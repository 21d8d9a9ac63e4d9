"""Streaming-stats primitives for the serving side (host numpy).

A copy of the JAX package's ``core/telemetry.py``, which imports no JAX
but sits inside that package:

* ``core.monitor.FreshnessMonitor`` aggregates per-cell serve counters
  over a bounded window of serve segments and summarizes them with
  rolling medians — the maintenance policy's signals
  (``SegmentWindow``);
* ``QuantileReservoir`` and ``Ewma`` track latency distributions and an
  online serve-cost estimate for the open-loop runtime (not ported yet).

Everything here is host-side numpy — it runs between serve steps, never
inside one — and deterministic: the reservoir's eviction RNG is seeded,
so two runs over the same stream report the same quantiles.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np


class Ewma:
    """Bias-corrected exponential moving average.

    ``update`` folds one observation in and returns the corrected mean;
    ``value`` is the current estimate (``default`` until the first
    observation — callers that gate on the estimate, like the runtime's
    dispatch rule, pick their own conservative bootstrap).
    """

    def __init__(self, alpha: float = 0.25, default: float = 0.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.default = float(default)
        self._acc = 0.0
        self._norm = 0.0    # 1 - (1-alpha)^n — the bias correction term
        self.n = 0

    def update(self, x: float) -> float:
        self._acc = (1.0 - self.alpha) * self._acc + self.alpha * float(x)
        self._norm = (1.0 - self.alpha) * self._norm + self.alpha
        self.n += 1
        return self.value

    @property
    def value(self) -> float:
        if self.n == 0:
            return self.default
        return self._acc / self._norm


class QuantileReservoir:
    """Fixed-size uniform reservoir for streaming quantiles.

    Classic reservoir sampling (Vitter's algorithm R) with a seeded
    generator: the first ``size`` observations are kept verbatim, later
    ones evict uniformly at random, so ``quantile`` is exact until the
    reservoir fills and an unbiased estimate after. Memory is O(size)
    no matter how long the stream runs — the property that lets the
    runtime keep per-query latency percentiles over an unbounded
    open-loop stream.
    """

    def __init__(self, size: int = 4096, seed: int = 0):
        if size <= 0:
            raise ValueError(f"size must be positive, got {size}")
        self.size = int(size)
        self._rng = np.random.default_rng(seed)
        self._buf = np.empty((self.size,), np.float64)
        self.n = 0          # observations seen (≥ len(self))

    def __len__(self) -> int:
        return min(self.n, self.size)

    def add(self, x: float) -> None:
        if self.n < self.size:
            self._buf[self.n] = x
        else:
            j = int(self._rng.integers(0, self.n + 1))
            if j < self.size:
                self._buf[j] = x
        self.n += 1

    def extend(self, xs) -> None:
        for x in np.asarray(xs, np.float64).ravel():
            self.add(float(x))

    def quantile(self, q) -> np.ndarray:
        """Quantile(s) of the sample (NaN while empty)."""
        if len(self) == 0:
            return np.full(np.shape(q), np.nan) if np.ndim(q) else np.nan
        return np.quantile(self._buf[:len(self)], q)

    def summary(self) -> dict:
        """The standard latency triple + extremes, as plain floats."""
        if len(self) == 0:
            return {"n": 0, "p50": np.nan, "p95": np.nan, "p99": np.nan,
                    "max": np.nan, "mean": np.nan}
        s = self._buf[:len(self)]
        p50, p95, p99 = np.quantile(s, [0.5, 0.95, 0.99])
        return {"n": self.n, "p50": float(p50), "p95": float(p95),
                "p99": float(p99), "max": float(s.max()),
                "mean": float(s.mean())}


class SegmentWindow:
    """Bounded window of per-key counter segments with rolling-median
    rates — the ``FreshnessMonitor`` aggregation idiom, extracted so the
    maintenance policy and the streaming runtime share it.

    One *segment* accumulates integer counters per key (grid cell, tier,
    ...) for a set of named fields; ``roll`` closes it into a deque of
    at most ``window`` segments. ``rate(field)`` is the per-key rolling
    *median* of per-segment rates (count / ``fields[0]``): robust to a
    single anomalous segment, and segments where a key saw no traffic
    don't vote (all-quiet keys rate 0). ``count_median`` is the rolling
    median of the count field itself.
    """

    def __init__(self, n_keys: int, fields: Sequence[str], *,
                 window: int = 8):
        if len(fields) < 1:
            raise ValueError("need at least the count field")
        self.fields = tuple(fields)
        self.n_keys = int(n_keys)
        self._window = deque(maxlen=int(window))
        self._reset_segment()

    def __len__(self) -> int:
        return len(self._window)

    def __getitem__(self, i: int) -> dict:
        """The i-th closed segment's field->counts dict (read-only use)."""
        return self._window[i]

    def _reset_segment(self) -> None:
        self._seg = {f: np.zeros((self.n_keys,), np.int64)
                     for f in self.fields}

    def add(self, keys: np.ndarray, values: dict) -> None:
        """Accumulate one batch: ``keys`` [M] i64 indexes the count
        field once per row; ``values`` maps the remaining field names to
        [M] addends (missing fields simply don't accumulate)."""
        keys = np.asarray(keys, np.int64).ravel()
        np.add.at(self._seg[self.fields[0]], keys, 1)
        for f, v in values.items():
            if f == self.fields[0]:
                raise ValueError(f"count field {f!r} is implicit")
            np.add.at(self._seg[f], keys,
                      np.asarray(v).ravel().astype(np.int64))

    def roll(self) -> None:
        """Close the current segment into the rolling window."""
        self._window.append(self._seg)
        self._reset_segment()

    def clear(self, n_keys: Optional[int] = None) -> None:
        """Drop all window state (e.g. the key space changed size)."""
        if n_keys is not None:
            self.n_keys = int(n_keys)
        self._window.clear()
        self._reset_segment()

    def rate(self, field: str) -> np.ndarray:
        """[n_keys] f64 rolling-median per-key rate of ``field``."""
        if field not in self.fields[1:]:
            raise ValueError(f"unknown field {field!r}")
        if not self._window:
            return np.zeros((self.n_keys,), np.float64)
        n = np.stack([s[self.fields[0]] for s in self._window]
                     ).astype(np.float64)
        v = np.stack([s[field] for s in self._window]).astype(np.float64)
        rates = np.where(n > 0, v / np.maximum(n, 1), np.nan)
        voters = (n > 0).any(axis=0)
        med = np.zeros((self.n_keys,), np.float64)
        if voters.any():
            med[voters] = np.nanmedian(rates[:, voters], axis=0)
        return med

    def count_median(self) -> np.ndarray:
        """[n_keys] f64 rolling-median per-key count per segment."""
        if not self._window:
            return np.zeros((self.n_keys,), np.float64)
        n = np.stack([s[self.fields[0]] for s in self._window]
                     ).astype(np.float64)
        return np.median(n, axis=0)
