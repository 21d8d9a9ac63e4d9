"""Open-loop streaming runtime: deadline-bound serving over the scheduler.

``core.schedule.serve_workload`` is closed-loop: the whole workload is
known upfront, pre-sorted on the Hilbert curve, and cut into always-full
batches — the right harness for throughput, the wrong one for latency.
Real traffic is open-loop: queries *arrive* (``data.arrivals`` stamps
them), each carries a deadline measured from its arrival, and waiting to
fill a 256-query batch is exactly the wrong call when the oldest
enqueued query's slack is about to run out.

This runtime layers the open loop over the same serving contracts:

* **Admission queue** — arrivals enter a pending set keyed *incrementally*
  onto the same Hilbert/Morton curve the offline scheduler sorts by
  (one key per query against a fixed workload bbox, inserted in key
  order as it arrives) — every dispatched batch still covers a compact
  curve window, so the fused kernel's tile early-exit keeps paying.
* **Continuous batch formation** — a batch dispatches when it is full,
  OR when the most urgent pending query's deadline slack drops below
  the EWMA-estimated serve-step cost (``telemetry.Ewma`` over measured
  step walltimes): a partially-full batch on time instead of a full
  batch too late. ``formation="full"`` keeps the fixed-full-batch
  policy as the closed-loop baseline (dispatch only full batches until
  arrivals run dry) — the bench compares the two.
* **Deadline-aware tier selection** — rows that overflowed the narrow
  R-path bound re-serve on the wide tier *only if their remaining slack
  covers the EWMA wide-step cost*; otherwise the row keeps its
  best-effort narrow result and is **flagged degraded** (its truncation
  flag also stays set) — never silently dropped. ``formation="full"``
  always re-serves wide (the offline-faithful baseline).

Results are **bit-identical** to offline ``serve_workload`` over the
same admitted query set whenever no deadline forces a degraded row: the
serve step is per-query (each stats row depends only on its own query),
batches are padded with the same repeat-last-row idiom, and wide-tier
rows merge through the same slice-to-narrow-width contract
(``schedule._merge_rows`` semantics). Only the *grouping* of rows into
batches differs — which cannot change any row.

The clock is wall time by default: each step's measured duration, from
the call to a synchronize of the stream's device, is the simulated
service time (the card's step on ``cuda``, the plain versions' on the
CPU). An injected ``service_time`` model makes the whole run
deterministic for tests.
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import schedule, telemetry


class RuntimeReport(NamedTuple):
    """Everything one open-loop run produced, submission order."""
    stats: object            # per-query stats tuple (numpy, wide rows
    #                          merged)
    n_queries: int
    n_batches: int           # narrow-tier dispatches
    n_wide_batches: int
    n_degraded: int          # truncated rows whose wide re-serve the
    #                          deadline disallowed — flagged, kept narrow
    n_missed: int            # rows completing after their deadline
    goodput: float           # fraction exact (non-degraded) AND on time
    mean_fill: float         # mean valid rows per narrow batch / batch
    arrival_s: np.ndarray    # [Q] f64 arrival stamps
    done_s: np.ndarray       # [Q] f64 completion stamps
    latency_s: np.ndarray    # [Q] f64 done - arrival
    degraded: np.ndarray     # [Q] bool
    missed: np.ndarray       # [Q] bool
    telemetry: dict          # p50/p95/p99 latency, queue depth, EWMAs
    formation: str
    sort: str


def _np_rows(stats, sel):
    """A leading-axis selection of a stats tuple, copied to numpy."""
    return schedule._rows(schedule._to_host(stats), sel)


def _scatter_rows(out_fields, narrow_shapes, stats, seqs):
    """Scatter one batch's per-row stats into the [Q]-leading outputs,
    slicing wide-tier payload tables down to the narrow tier's static
    width (the ``schedule._merge_rows`` contract)."""
    for o, ns, l in zip(out_fields, narrow_shapes, stats):
        l = np.asarray(l)
        if l.shape[1:] != ns:
            if any(ws < n for ws, n in zip(l.shape[1:], ns)):
                raise ValueError(f"wide tier field narrower than narrow "
                                 f"tier's: {l.shape[1:]} vs {ns}")
            l = l[(slice(None),) + tuple(slice(0, n) for n in ns)]
        o[seqs] = l


def run_stream(serve_fn: Callable, queries: np.ndarray,
               arrivals: np.ndarray, *, batch: int,
               deadline_s: Union[float, np.ndarray],
               sort: str = "hilbert",
               bbox: Optional[np.ndarray] = None,
               wide_fn: Optional[Callable] = None,
               trunc_field: str = "r_truncated",
               formation: str = "deadline",
               service_time: Optional[Callable] = None,
               ewma_alpha: float = 0.25,
               reservoir: int = 4096,
               device: str | torch.device = "cuda") -> RuntimeReport:
    """Drive one open-loop stream through the serving stack.

    ``serve_fn``/``wide_fn``/``trunc_field``/``device`` are exactly
    ``schedule.serve_workload``'s contract (``[batch, 4]`` tensor on
    ``device`` → stats NamedTuple of per-query tensors with a truncation
    flag). ``queries`` [Q, 4] arrive at
    ``arrivals`` [Q] seconds (sorted, from ``data.arrivals``), each with
    deadline ``arrival + deadline_s`` (scalar or per-query [Q]).

    ``formation="deadline"`` is the open-loop policy (partial dispatch
    on slack pressure + deadline-gated wide tier); ``"full"`` is the
    fixed-full-batch baseline (waits to fill, always re-serves wide).

    ``service_time(n_valid, tier) -> seconds`` replaces the measured
    step walltime with a model — the run becomes fully deterministic
    (the serve calls still execute; only the clock is simulated). The
    measured step ends with a synchronize of ``device``, so on the card
    it is the card's time, not the enqueue's.
    """
    if formation not in ("deadline", "full"):
        raise ValueError(f"formation must be deadline|full, "
                         f"got {formation!r}")
    q = np.asarray(queries, np.float32)
    arr = np.asarray(arrivals, np.float64)
    Q = q.shape[0]
    if Q == 0:
        raise ValueError("need at least one query")
    if arr.shape != (Q,):
        raise ValueError(f"arrivals shape {arr.shape} != ({Q},)")
    if np.any(np.diff(arr) < 0):
        raise ValueError("arrivals must be sorted")
    batch = int(batch)
    if batch <= 0:
        raise ValueError(f"batch must be positive, got {batch}")
    deadline_t = arr + np.broadcast_to(
        np.asarray(deadline_s, np.float64), (Q,))
    dev = resolve_device(device)
    if bbox is None:
        bbox = schedule.workload_bbox(q)
    # incremental curve keying: one key per query against the shared
    # bbox — identical values to the offline scheduler's sort keys
    keys = schedule.spatial_keys(q, sort, bbox, device=dev)

    ew_narrow = telemetry.Ewma(ewma_alpha)
    ew_wide = telemetry.Ewma(ewma_alpha)
    lat_q = telemetry.QuantileReservoir(reservoir, seed=0)
    depth_q = telemetry.QuantileReservoir(reservoir, seed=1)

    def _step(fn, chunk, n_valid, tier, ew):
        t0 = time.perf_counter()
        out = fn(torch.from_numpy(chunk).to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) if service_time is None \
            else float(service_time(n_valid, tier))
        ew.update(dt)
        return out, dt

    # warmup: run both tiers off the clock (first-use kernel builds
    # included) and seed the cost EWMAs — without this the first dispatch
    # decision would compare slack against a zero estimate
    warm = np.repeat(q[:1], batch, axis=0)
    _, dt0 = _step(serve_fn, warm, batch, "narrow", ew_narrow)
    if wide_fn is not None:
        _, _ = _step(wide_fn, warm, batch, "wide", ew_wide)

    # pending admission queue, kept key-sorted (incremental Hilbert
    # batch formation): entries are (key, seq) so equal keys fall back
    # to submission order — same tie-break as the offline stable sort
    pending: list = []
    out_fields = narrow_shapes = stats_type = None
    done_s = np.zeros((Q,), np.float64)
    degraded = np.zeros((Q,), bool)
    n_batches = n_wide_batches = 0
    fills: list = []
    now = 0.0
    i = 0           # next arrival index
    n_done = 0

    def _admit(upto: float) -> int:
        nonlocal i
        while i < Q and arr[i] <= upto:
            bisect.insort(pending, (int(keys[i]), i))
            i += 1
        return i

    while n_done < Q:
        if not pending:
            now = max(now, arr[i])      # idle: jump to the next arrival
        _admit(now)
        if not pending:
            continue
        full = len(pending) >= batch
        drained = i == Q
        if not full and not drained:
            if formation == "full":
                now = arr[i]            # baseline waits for a full batch
                continue
            # deadline formation: dispatch a partial batch only when the
            # most urgent pending query's slack no longer covers one
            # EWMA-estimated narrow step; otherwise sleep until either
            # that boundary or the next arrival, whichever is first
            t_urgent = min(deadline_t[s] for _, s in pending)
            boundary = t_urgent - ew_narrow.value
            if now < boundary:
                now = min(arr[i], boundary)
                continue

        # ---- dispatch: contiguous curve window around the most urgent
        depth_q.add(float(len(pending)))
        if len(pending) <= batch:
            j0, k = 0, len(pending)
        else:
            pu = int(np.argmin([deadline_t[s] for _, s in pending]))
            j0 = min(max(pu - batch // 2, 0), len(pending) - batch)
            k = batch
        sel = pending[j0:j0 + k]
        del pending[j0:j0 + k]
        seqs = np.array([s for _, s in sel], np.int64)
        chunk = q[seqs]
        if k < batch:                   # repeat-last-row pad (scheduler
            chunk = np.concatenate(     # idiom; pad stats are dropped)
                [chunk, np.repeat(chunk[-1:], batch - k, axis=0)])
        stats, dt = _step(serve_fn, chunk, k, "narrow", ew_narrow)
        now += dt
        n_batches += 1
        fills.append(k)
        rows = _np_rows(stats, np.s_[:k])
        if out_fields is None:
            stats_type = type(rows)
            narrow_shapes = [l.shape[1:] for l in rows]
            out_fields = [np.zeros((Q,) + l.shape[1:], l.dtype)
                          for l in rows]
        _scatter_rows(out_fields, narrow_shapes, rows, seqs)

        # ---- deadline-aware tier selection over the truncated rows
        re_idx = np.zeros((0,), np.int64)
        if wide_fn is not None and hasattr(rows, trunc_field):
            trunc = np.asarray(getattr(rows, trunc_field)).astype(bool)
            t_idx = seqs[np.flatnonzero(trunc)]
            if t_idx.size:
                if formation == "full":
                    ok = np.ones(t_idx.shape, bool)
                else:
                    slack = deadline_t[t_idx] - now
                    ok = slack >= ew_wide.value
                re_idx = t_idx[ok]
                # rows the wide re-serve would blow the deadline on keep
                # their best-effort narrow result, flagged — their
                # truncation flag stays set too (never silently cleared)
                degraded[t_idx[~ok]] = True
        done_narrow = np.setdiff1d(seqs, re_idx, assume_unique=True)
        done_s[done_narrow] = now
        n_done += done_narrow.size

        for lo in range(0, re_idx.size, batch):
            w_seqs = re_idx[lo:lo + batch]
            kw = w_seqs.size
            wchunk = q[w_seqs]
            if kw < batch:
                wchunk = np.concatenate(
                    [wchunk, np.repeat(wchunk[-1:], batch - kw, axis=0)])
            wstats, dtw = _step(wide_fn, wchunk, kw, "wide", ew_wide)
            now += dtw
            n_wide_batches += 1
            _scatter_rows(out_fields, narrow_shapes,
                          _np_rows(wstats, np.s_[:kw]), w_seqs)
            done_s[w_seqs] = now
            n_done += kw
        _admit(now)     # arrivals that landed while the step(s) ran

    stats = stats_type(*out_fields)
    latency = done_s - arr
    lat_q.extend(latency)
    missed = done_s > deadline_t
    good = ~degraded & ~missed
    tele = {
        "latency_s": lat_q.summary(),
        "queue_depth": depth_q.summary(),
        "ewma_narrow_s": ew_narrow.value,
        "ewma_wide_s": ew_wide.value,
        "warm_narrow_s": dt0,
    }
    return RuntimeReport(
        stats=stats, n_queries=Q, n_batches=n_batches,
        n_wide_batches=n_wide_batches, n_degraded=int(degraded.sum()),
        n_missed=int(missed.sum()), goodput=float(good.mean()),
        mean_fill=float(np.mean(fills) / batch), arrival_s=arr,
        done_s=done_s, latency_s=latency, degraded=degraded,
        missed=missed, telemetry=tele, formation=formation, sort=sort)
