"""Arrival processes for open-loop serving.

The closed-loop harness (``core.schedule.serve_workload``) feeds the
engine a pre-materialized workload as fast as it drains; an open-loop
stream instead *stamps every query with an arrival time* and the runtime
(``core.runtime``) must answer each one under a deadline measured from
that stamp. This module generates the stamps:

* ``poisson_arrivals`` — homogeneous Poisson at a target rate (iid
  exponential gaps), the standard open-loop benchmark process;
* ``bursty_arrivals`` — a two-state MMPP (quiet/burst), for tail-latency
  stress: the mean rate matches ``rate`` but bursts arrive at
  ``burst_factor``× it;
* ``load_trace``/``save_trace`` — replay recorded timestamps (``.npy``
  or one-float-per-line text), rebased to t=0 and sorted, optionally
  resampled to ``n`` queries and rescaled to a target mean rate.

All generators are deterministic under ``seed`` and return cumulative
arrival times in seconds as [n] f64, starting at the first gap (not 0 —
an arrival at exactly t=0 would be special-cased by any queue).

Host numpy only, a copy of the JAX package's module (the port imports
nothing of that package), so the same seed gives the same stamps.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def poisson_arrivals(n: int, rate: float, seed: int = 0) -> np.ndarray:
    """[n] f64 cumulative arrival times of a Poisson process.

    ``rate`` is in queries/second; gaps are iid Exp(rate).
    """
    if n <= 0:
        return np.zeros((0,), np.float64)
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate: float, *, burst_factor: float = 16.0,
                    burst_frac: float = 0.5, switch_every: float = 50.0,
                    seed: int = 0) -> np.ndarray:
    """[n] f64 arrivals of a two-state MMPP with mean rate ``rate``.

    The process alternates between a quiet state and a burst state whose
    instantaneous rate is ``burst_factor``× the quiet one; it spends
    ``burst_frac`` of its arrivals in bursts and switches states every
    ~``switch_every`` arrivals (geometric dwell). The mean rate is
    normalized back to ``rate``, so sweeps compare like with like and
    only the *variance* changes vs ``poisson_arrivals``.
    """
    if n <= 0:
        return np.zeros((0,), np.float64)
    if rate <= 0 or burst_factor < 1.0 or not 0.0 < burst_frac < 1.0:
        raise ValueError(f"bad MMPP parameters: rate={rate}, "
                         f"burst_factor={burst_factor}, "
                         f"burst_frac={burst_frac}")
    rng = np.random.default_rng(seed)
    # state sequence: geometric dwells, burst_frac of arrivals bursty
    state = np.zeros((n,), bool)
    i, in_burst = 0, False
    while i < n:
        dwell_mean = switch_every * (burst_frac if in_burst
                                     else 1.0 - burst_frac) * 2.0
        d = 1 + int(rng.geometric(1.0 / max(dwell_mean, 1.0)))
        state[i:i + d] = in_burst
        i += d
        in_burst = not in_burst
    # per-arrival instantaneous rates, normalized to the target mean gap
    rel = np.where(state, 1.0 / burst_factor, 1.0)   # relative gap sizes
    gaps = rng.exponential(1.0, size=n) * rel
    gaps *= (1.0 / rate) / gaps.mean()
    return np.cumsum(gaps)


def save_trace(path: str, arrivals: np.ndarray) -> None:
    """Persist arrival stamps (``.npy``, or text: one float per line)."""
    a = np.asarray(arrivals, np.float64)
    if path.endswith(".npy"):
        np.save(path, a)
    else:
        np.savetxt(path, a)


def load_trace(path: str, n: Optional[int] = None,
               rate: Optional[float] = None) -> np.ndarray:
    """[n] f64 arrivals replayed from a recorded trace.

    The trace is sorted and rebased so the first gap matches the trace's
    own lead-in. With ``n`` the trace is truncated or tiled (tiling
    shifts each repetition by the trace's span, preserving its rhythm);
    with ``rate`` the stamps are rescaled to that mean arrival rate.

    Edge cases round-trip instead of crashing or emitting NaN gaps: an
    empty trace loads as an empty stream (unless ``n`` demands arrivals
    it cannot supply — that raises), ``n <= 0`` truncates any trace to
    empty, a single-arrival trace tiles on its own lead-in gap, and a
    trace of duplicate stamps tiles with a floor gap so repetitions
    never overlap.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npy"):
        a = np.load(path)
    else:
        import warnings
        with warnings.catch_warnings():
            # np.loadtxt warns (and returns shape (0,)) on an empty
            # file — an empty trace is a valid stream here
            warnings.simplefilter("ignore", UserWarning)
            a = np.loadtxt(path)
    a = a.astype(np.float64).ravel()
    if n is not None and n <= 0:
        return np.zeros((0,), np.float64)
    if a.size == 0:
        if n is None:
            return np.zeros((0,), np.float64)
        raise ValueError(f"empty trace cannot supply n={n} arrivals: "
                         f"{path}")
    a = np.sort(a)
    a -= a[0]
    span = a[-1] if a[-1] > 0 else 1.0
    gap0 = a[1] - a[0] if a.size > 1 else span
    a += max(gap0, span / max(a.size, 1), 1e-9)    # lead-in: no t=0 arrival
    if n is not None and n != a.size:
        reps = -(-n // a.size)
        # floor the per-rep shift: duplicate-stamp traces have gap0 == 0
        # and would otherwise tile every repetition onto the same instant
        shift = a[-1] + max(gap0, 1e-9)
        a = np.concatenate([a + r * shift for r in range(reps)])[:n]
    if rate is not None:
        if rate <= 0:
            raise ValueError(f"rate must be positive, got {rate}")
        mean_rate = a.size / a[-1]
        a *= mean_rate / rate
    return a


def make_arrivals(kind: str, n: int, rate: float, *, seed: int = 0,
                  trace: Optional[str] = None, **kw) -> np.ndarray:
    """Dispatcher used by the launch driver and the bench harness."""
    if kind == "poisson":
        return poisson_arrivals(n, rate, seed=seed)
    if kind == "bursty":
        return bursty_arrivals(n, rate, seed=seed, **kw)
    if kind == "trace":
        if trace is None:
            raise ValueError("kind='trace' needs a trace path")
        return load_trace(trace, n=n, rate=rate if rate > 0 else None)
    raise ValueError(f"unknown arrival kind {kind!r} "
                     "(expected poisson | bursty | trace)")
