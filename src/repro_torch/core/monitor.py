"""Serving-time freshness/fit monitor + the live serving-state owner.

The guard tier has two inputs, tracked here:

* **fit** — the per-cell exact-fit flags ``build.fit_airtree`` measured
  at training time (a cell whose training queries were not all answered
  exactly can under-predict silently);
* **staleness** — inserts that landed in a cell *since the bank was
  fit*: the cell's model has never seen those points, so its predictions
  there are unfounded even if its fit was perfect.

``FreshnessMonitor`` ANDs the two into the ``cell_ok`` mask the
router-side guard consults (``AITree.cell_ok``): stale or ``fit < 1``
cells are demoted to the exact R path, which closes the under-prediction
blind spot for drifted *and* under-trained banks in one mechanism.

Beyond the guard inputs, the monitor is the serving side's **policy
engine**: every served batch feeds per-cell rolling counters (traffic,
guard rate, mispredict rate, delta-hit rate — aggregated per serve
segment, summarized by the rolling median over a window of segments),
and a pluggable ``MaintenancePolicy`` turns those signals into
between-segment maintenance decisions — which stale cells to refit
next (``build.refit_cells`` chunks), when to repack the delta buffer,
and which cells to force-demote off / promote back onto the AI path.

``FreshServer`` owns the whole live state — hybrid tree, delta store,
monitor — and is what the scheduler drives for a mixed read/write
stream (``EngineFreshServer`` is its shape over the serving engine):
``serve``/``serve_wide`` answer batches (tree paths + delta probe,
merged), ``insert`` stages points and bumps staleness, ``repack`` swaps
in a fresh bulk-loaded tree between batches. Without a
``FitState`` the legacy contract holds: after a repack the *entire*
bank is marked stale (``str_bulk`` renumbers every leaf, so the bank's
label space refers to a tree that no longer exists) and stays guarded
until a full refit. With a ``FitState`` (``BuildReport.fit_state``)
the repack instead runs a span-diff (``core.spans``): surviving leaf
ids are renamed inside the bank, only cells whose leaf span actually
moved go stale, and the policy retrains them incrementally through
``refit_cells`` — the AI path recovers cell by cell with no full
``fit_airtree`` on the serve path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import build as buildlib
from repro_torch.core import delta as deltalib
from repro_torch.core import telemetry
from repro_torch.core.grid import Grid, cell_range
from repro_torch.core.hybrid import HybridResult, HybridTree, hybrid_query


class FreshResult(NamedTuple):
    """``HybridResult`` + the delta-probe count."""
    routed_high: torch.Tensor
    used_ai: torch.Tensor
    n_results: torch.Tensor
    result_ids: torch.Tensor
    leaf_accesses: torch.Tensor
    n_visited_r: torch.Tensor
    n_true: torch.Tensor
    truncated: torch.Tensor
    guarded: torch.Tensor
    mispredict: torch.Tensor
    cell_id: torch.Tensor
    delta_hits: torch.Tensor     # [B] buffer hits (already in n_results)


assert FreshResult._fields[:len(HybridResult._fields)] == \
    HybridResult._fields, "FreshResult must prefix-extend HybridResult"


class FreshnessStats(NamedTuple):
    """Aggregate monitor state, as surfaced per stream by launch/serve."""
    n_cells: int
    fit_cells: int       # cells with exact training fit
    stale_cells: int     # cells with inserts since the bank was fit
    ok_cells: int        # fit AND fresh — serve-eligible on the AI path
    n_inserts: int       # staged since the monitor was (re)fit
    n_repacks: int
    delta_fill: int      # points currently staged in the buffer
    span_stale_cells: int = 0   # cells awaiting an incremental refit
    demoted_cells: int = 0      # cells force-demoted by the policy


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# the per-cell serve counters one segment accumulates before the window
# rolls — the monitor's unit of rolling-rate aggregation
_SERVE_FIELDS = ("n", "guarded", "mispredict", "used_ai", "delta_hits")


class FreshnessMonitor:
    """Host-side per-cell fit/staleness tracking over the model grid,
    plus the rolling serve-signal counters the maintenance policy reads.

    Guard state (ANDed into ``cell_ok``):

    * ``fit_ok`` — certificate flags from the last (re)fit;
    * ``stale`` — insert counters (points staged since the fit — only a
      repack can absorb them into the tree);
    * ``span_stale`` — cells whose leaf span moved under a repack and
      that no refit chunk has retrained yet (span-diff invalidation);
    * ``forced_demote`` — policy demotions (drift evidence the span
      diff cannot see, e.g. a workload shift inside an unchanged span).

    Serve signals: ``note_serve`` accumulates per-cell counters for the
    current segment; ``roll_segment`` closes it into a bounded window,
    and ``rolling``/``traffic`` summarize the window with the rolling
    *median* (robust to one-segment spikes — a single anomalous batch
    cannot trigger a demotion cascade).
    """

    def __init__(self, grid: Grid, fit_ok: np.ndarray, *, window: int = 8):
        self._grid = grid
        self.fit_ok = np.asarray(fit_ok, bool).copy()
        assert self.fit_ok.shape == (grid.n_cells,), \
            (self.fit_ok.shape, grid.g)
        self.stale = np.zeros_like(self.fit_ok, dtype=np.int64)
        self.span_stale = np.zeros_like(self.fit_ok, dtype=bool)
        self.forced_demote = np.zeros_like(self.fit_ok, dtype=bool)
        self.demoted_at = np.zeros_like(self.fit_ok, dtype=np.int64)
        self.n_inserts = 0
        self.n_repacks = 0
        self.seg_counter = 0
        # the rolling-window machinery lives in core.telemetry so the
        # streaming runtime's latency stats share one implementation
        self._window = telemetry.SegmentWindow(
            grid.n_cells, _SERVE_FIELDS, window=window)

    # -- serve-signal accumulation ----------------------------------------

    def note_serve(self, stats) -> None:
        """Accumulate one served batch's per-query signals per cell.

        ``stats`` is any tuple with ``cell_id``/``guarded``/
        ``mispredict``/``used_ai``/``delta_hits`` fields ([B] tensors or
        arrays — ``FreshResult`` qualifies). Rows
        with ``cell_id < 0`` (cell-window overflow) have no anchor cell
        and are dropped; scheduler pad rows are counted (they repeat a
        real query, so they only re-weight that query's own cell).
        """
        cid = _host(stats.cell_id).ravel().astype(np.int64)
        keep = cid >= 0
        cid = cid[keep]
        self._window.add(cid, {
            f: _host(getattr(stats, f)).ravel()[keep]
            for f in _SERVE_FIELDS[1:]})

    def roll_segment(self) -> None:
        """Close the current segment into the rolling window."""
        self._window.roll()
        self.seg_counter += 1

    def rolling(self, field: str) -> np.ndarray:
        """[C] f64 rolling-median per-cell *rate* of ``field`` over the
        window (count / queries, per segment; segments where a cell saw
        no traffic don't vote — all-quiet cells rate 0)."""
        if field not in _SERVE_FIELDS[1:]:
            raise ValueError(f"unknown serve field {field!r}")
        return self._window.rate(field)

    def traffic(self) -> np.ndarray:
        """[C] f64 rolling-median per-cell queries per segment."""
        return self._window.count_median()

    def _cells_of_points(self, points: np.ndarray) -> np.ndarray:
        # map points (rounded to f32, as staged) as degenerate rects
        # through the grid's own ``cell_range`` so the monitor's cell
        # attribution can never drift from the convention serving queries
        # are routed by; out-of-bbox points clamp into the edge cells
        # (conservative — the edge cell's model never trained there)
        p = np.asarray(points, np.float32).reshape(-1, 2)
        rects = torch.from_numpy(np.concatenate([p, p], axis=1)).to(
            self._grid.bbox.device)
        cr = cell_range(self._grid, rects).cpu().numpy()
        return cr[:, 1].astype(np.int64) * self._grid.g + cr[:, 0]

    def note_inserts(self, points: np.ndarray) -> None:
        """Inserts landed: bump the receiving cells' staleness."""
        cells = self._cells_of_points(points)
        np.add.at(self.stale, cells, 1)
        self.n_inserts += int(cells.shape[0])

    def note_repack(self, changed: Optional[np.ndarray] = None) -> None:
        """The tree was rebuilt. Legacy contract (``changed=None``):
        every cell goes stale — bulk load renumbers all leaves, so the
        whole bank's label space refers to a tree that no longer
        exists. Span-diff contract (``changed`` = [C] bool from
        ``build.refit_cells``'s diff): surviving leaves were renamed
        inside the bank, so *only* cells whose leaf span moved are
        stale; the insert counters reset (every staged point is in the
        tree now, and a repack-received cell's span provably changed —
        the receiving leaf intersects that cell — so no insert evidence
        is lost by the fold)."""
        if changed is None:
            self.stale[:] = max(1, int(self.stale.max()))
        else:
            self.stale[:] = 0
            self.span_stale = np.asarray(changed, bool).copy()
        self.n_repacks += 1

    def note_refit_cells(self, cell_ok: np.ndarray,
                         still_stale: np.ndarray) -> None:
        """An incremental ``build.refit_cells`` chunk landed: replace
        the certificate flags wholesale (re-certification can flip
        cells *outside* the chunk — a shared query's verdict changed)
        and narrow ``span_stale`` to the cells the chunk left behind.
        Insert counters are untouched: a refit trains on the tree, not
        the buffer, so points staged since the last repack still guard
        their cells."""
        self.fit_ok = np.asarray(cell_ok, bool).copy()
        self.span_stale = np.asarray(still_stale, bool).copy()

    # -- policy levers ------------------------------------------------------

    def force_demote(self, cells: np.ndarray) -> None:
        """Policy demotion: hold ``cells`` off the AI path regardless of
        their certificates (drift evidence the span diff cannot see)."""
        cells = np.asarray(cells, np.int64)
        self.forced_demote[cells] = True
        self.demoted_at[cells] = self.seg_counter

    def clear_demote(self, cells: np.ndarray) -> None:
        self.forced_demote[np.asarray(cells, np.int64)] = False

    def note_refit(self, fit_ok: np.ndarray,
                   grid: Optional[Grid] = None) -> None:
        """The bank was refit on the current tree: staleness resets and
        the fit flags are replaced by the new evaluation's. Pass ``grid``
        when the refit's hill-climb landed on a different grid size — the
        monitor re-anchors to it (flags and staleness are per-cell, so
        they cannot survive a geometry change anyway)."""
        if grid is not None:
            self._grid = grid
        self.fit_ok = np.asarray(fit_ok, bool).copy()
        assert self.fit_ok.shape == (self._grid.n_cells,), \
            (self.fit_ok.shape, self._grid.g)
        self.stale = np.zeros_like(self.fit_ok, dtype=np.int64)
        self.span_stale = np.zeros_like(self.fit_ok, dtype=bool)
        self.forced_demote = np.zeros_like(self.fit_ok, dtype=bool)
        self.demoted_at = np.zeros_like(self.fit_ok, dtype=np.int64)
        self.n_inserts = 0
        if self.fit_ok.shape[0] != self._window.n_keys:
            self._window.clear(n_keys=self.fit_ok.shape[0])

    def cell_ok(self) -> np.ndarray:
        """[C] bool: serve-eligible = certified fit AND no inserts since
        AND span current AND not policy-demoted."""
        return self.fit_ok & (self.stale == 0) & ~self.span_stale \
            & ~self.forced_demote

    def guard_array(self) -> torch.Tensor:
        """``cell_ok`` as a tensor on the grid's device."""
        return torch.from_numpy(self.cell_ok()).to(self._grid.bbox.device)

    def stats(self, delta_fill: int = 0) -> FreshnessStats:
        ok = self.cell_ok()
        return FreshnessStats(
            n_cells=int(ok.size), fit_cells=int(self.fit_ok.sum()),
            stale_cells=int(((self.stale > 0) | self.span_stale).sum()),
            ok_cells=int(ok.sum()),
            n_inserts=self.n_inserts, n_repacks=self.n_repacks,
            delta_fill=delta_fill,
            span_stale_cells=int(self.span_stale.sum()),
            demoted_cells=int(self.forced_demote.sum()))


class MaintenanceDecision(NamedTuple):
    """One between-segments verdict from a ``MaintenancePolicy``."""
    repack: bool             # merge the delta buffer into a fresh tree
    refit: np.ndarray        # i64 cells to retrain this segment (chunk)
    demote: np.ndarray       # i64 cells to force off the AI path
    promote: np.ndarray      # i64 demoted cells to retrain + readmit
    refit_skipped: int = 0   # cells the server could not refit (no
    #                          FitState — cell-granular refit disabled)


class MaintenancePolicy:
    """Strategy interface: rolling per-cell signals → maintenance."""

    def decide(self, monitor: FreshnessMonitor, *, delta_fill: int,
               delta_capacity: int) -> MaintenanceDecision:
        raise NotImplementedError


@dataclasses.dataclass
class DefaultPolicy(MaintenancePolicy):
    """Stats-driven maintenance defaults.

    * **repack** when the delta buffer passes ``repack_at`` of its
      capacity (ahead of the forced repack-before-overflow, so the
      span diff + chunked refits amortize across quiet segments);
    * **refit** up to ``refit_chunk`` span-stale cells per segment,
      hottest first (rolling-median traffic) — recovery effort follows
      the workload, so the cells that cost the most guarded R-path
      serves come back to the AI path first;
    * **demote** serve-eligible cells whose rolling mispredict rate
      exceeds ``demote_mispredict`` (with at least ``min_traffic``
      queries/segment of evidence) — drift *inside* an unchanged span
      that certificates can't see;
    * **promote** demoted cells after ``promote_after`` segments by
      scheduling a forced refit (retrain + recertify readmits them
      only if the new certificates hold; ``0`` disables).
    """
    refit_chunk: int = 4
    repack_at: float = 0.75
    demote_mispredict: float = 0.25
    min_traffic: float = 4.0
    promote_after: int = 2

    def decide(self, monitor: FreshnessMonitor, *, delta_fill: int,
               delta_capacity: int) -> MaintenanceDecision:
        repack = bool(delta_capacity > 0 and delta_fill
                      >= self.repack_at * delta_capacity)
        traffic = monitor.traffic()
        stale = np.flatnonzero(monitor.span_stale)
        if self.refit_chunk and stale.size > self.refit_chunk:
            hot = np.argsort(-traffic[stale], kind="stable")
            stale = np.sort(stale[hot[:self.refit_chunk]])
        mis = monitor.rolling("mispredict")
        demote = np.flatnonzero(
            monitor.cell_ok() & (traffic >= self.min_traffic)
            & (mis > self.demote_mispredict))
        if self.promote_after:
            age = monitor.seg_counter - monitor.demoted_at
            promote = np.flatnonzero(monitor.forced_demote
                                     & (age >= self.promote_after))
        else:
            promote = np.zeros((0,), np.int64)
        return MaintenanceDecision(
            repack=repack, refit=stale.astype(np.int64),
            demote=demote.astype(np.int64),
            promote=promote.astype(np.int64))


def _note_refit_skipped(server, d: MaintenanceDecision,
                        n_cells: int) -> MaintenanceDecision:
    """Record a policy-decided refit the server couldn't run (no
    ``FitState``). The skip count rides on the decision — visible in the
    ``maintenance`` log and ``MixedReport.maintenance`` — and the
    human-facing notice prints once per server lifetime, not once per
    segment."""
    if not getattr(server, "_refit_skip_noticed", False):
        server._refit_skip_noticed = True
        print("# policy: cell-granular refit disabled (no FitState) — "
              "refit/promote cells stay guarded; skip counts recorded "
              "in the maintenance log")
    return d._replace(refit_skipped=int(n_cells))


class FreshServer:
    """Live serving state for a mixed read/write stream (single-device
    hybrid path).

    A stateful host shell over functional serve steps: every batch
    serves through ``hybrid_query`` over the *current* (hybrid, delta)
    pair; ``insert``/``repack`` swap that pair between batches, never
    under a running step. ``serve``/``serve_wide`` realize the
    scheduler's two-tier contract (``HybridResult.truncated``), with the
    wide tier's bounds — the delta slot bound included — scaled by
    ``wide_factor``. Everything lives on the hybrid tree's device.
    """

    trunc_field = "truncated"

    def __init__(self, points: np.ndarray, hybrid: HybridTree, *,
                 delta_cap: int = 4096, max_visited: int = 64,
                 max_results: int = 512, delta_k: int = 64,
                 wide_factor: int = 8,
                 refit_fn: Optional[Callable] = None,
                 fit_state=None,
                 policy: Optional[MaintenancePolicy] = None):
        self.points = np.asarray(points, np.float64)
        self.max_entries = hybrid.tree.max_entries
        self.device = hybrid.tree.device
        self.monitor = FreshnessMonitor(hybrid.ait.grid,
                                        hybrid.ait.cell_ok.cpu().numpy())
        self.delta = deltalib.make_delta(delta_cap,
                                         base=self.points.shape[0],
                                         device=self.device)
        self.hybrid = hybrid
        self._mv, self._mr = int(max_visited), int(max_results)
        self._dk, self._wf = int(delta_k), int(wide_factor)
        # refit_fn(device_tree) -> (HybridTree, cell_fit [C] bool) — e.g.
        # a relabel + build.fit_airtree closure; None keeps the stale bank
        # guarded (R-path serving) after repacks
        self._refit_fn = refit_fn
        # fit_state: the build.FitState snapshot from BuildReport — turns
        # repacks into span-diffs and unlocks incremental refit_cells;
        # policy: between-segment maintenance (None = manual only)
        self.fit_state = fit_state
        self.policy = policy
        self.maintenance = []   # (segment, MaintenanceDecision) log
        self.refits = []        # build.RefitReport log
        self._sync_guard()

    # -- serving -----------------------------------------------------------

    def _serve(self, q: torch.Tensor, widen: int) -> FreshResult:
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        mv, mr = self._mv * widen, self._mr * widen
        dk = self._dk * widen
        res = hybrid_query(self.hybrid, q, max_visited=mv, max_results=mr)
        hits = deltalib.probe(self.delta.xy, q, k=dk, base=self.delta.base)
        merged = deltalib.merge_hybrid_result(res, hits)
        return FreshResult(*merged, delta_hits=hits.count)

    def serve(self, q) -> FreshResult:
        res = self._serve(q, 1)
        # narrow tier sees every query exactly once (the wide tier only
        # re-serves truncated rows) — the one place signal feeding stays
        # double-count-free
        self.monitor.note_serve(res)
        return res

    def serve_wide(self, q) -> FreshResult:
        return self._serve(q, self._wf)

    # -- writes ------------------------------------------------------------

    @property
    def delta_fill(self) -> int:
        return self.delta.n

    def _sync_guard(self) -> None:
        ait = dataclasses.replace(self.hybrid.ait,
                                  cell_ok=self.monitor.guard_array())
        self.hybrid = dataclasses.replace(self.hybrid, ait=ait)

    def _note_refit(self, rep) -> None:
        self.refits.append(rep)
        self.monitor.note_refit_cells(self.hybrid.ait.cell_ok.cpu().numpy(),
                                      self.fit_state.cell_stale.copy())

    def insert(self, points: np.ndarray) -> None:
        """Stage inserts into the delta buffer (between batches); the
        receiving cells go stale and drop off the AI path. A batch the
        buffer cannot absorb forces a repack first (repack before
        overflow); a single batch larger than the whole capacity still
        raises."""
        m = np.asarray(points, np.float32).reshape(-1, 2).shape[0]
        if self.delta.n + m > self.delta.capacity:
            self.repack()
        self.delta = deltalib.stage_inserts(self.delta, points)
        self.monitor.note_inserts(points)
        self._sync_guard()

    def repack(self) -> None:
        """Online repack: swap in a fresh bulk-loaded tree holding every
        staged point and empty the buffer. With a ``fit_state`` the swap
        runs an *empty-chunk* ``build.refit_cells`` — span diff, leaf-id
        renames inside the live bank, certificate invalidation — so only
        span-changed cells go stale; retraining is left to later chunks.
        Without one: guard the whole bank until ``refit_fn`` (or a manual
        full refit) lands."""
        _, dtree, allp, self.delta = deltalib.repack(
            self.points, self.delta, max_entries=self.max_entries)
        self.points = allp
        if self.fit_state is not None:
            self.hybrid = dataclasses.replace(self.hybrid, tree=dtree)
            rep = self._refit(np.zeros((0,), np.int64))
            self.monitor.note_repack(
                changed=self.fit_state.cell_stale.copy())
            self._note_refit(rep)
        elif self._refit_fn is not None:
            self.monitor.note_repack()
            hybrid, cell_fit = self._refit_fn(dtree)
            self.hybrid = hybrid
            # the refit's grid search may land on a different grid size —
            # re-anchor the monitor to the refit hybrid's own grid
            self.monitor.note_refit(np.asarray(cell_fit, bool),
                                    grid=hybrid.ait.grid)
        else:
            self.monitor.note_repack()
            self.hybrid = dataclasses.replace(self.hybrid, tree=dtree)
        self._sync_guard()

    # -- incremental maintenance -------------------------------------------

    def refit_cells(self, cells: Optional[np.ndarray] = None):
        """Retrain a chunk of stale cells in place (requires
        ``fit_state``); ``None`` = all currently stale. Returns the
        ``build.RefitReport``."""
        if self.fit_state is None:
            raise ValueError("refit_cells needs a FitState "
                             "(build with fit_airtree and pass "
                             "BuildReport.fit_state)")
        rep = self._refit(cells)
        self._note_refit(rep)
        self._sync_guard()
        return rep

    def _refit(self, cells: Optional[np.ndarray]):
        """``build.refit_cells`` of the live hybrid and ``fit_state`` on
        chunk ``cells``: updates both, returns the report."""
        self.hybrid, self.fit_state, rep = buildlib.refit_cells(
            self.hybrid, self.fit_state, cells)
        return rep

    def on_segment(self) -> Optional[MaintenanceDecision]:
        """Between-segments hook the scheduler calls after each serve
        segment: roll the signal window, ask the policy, apply the
        decision (repack / demote / promote / refit chunk)."""
        self.monitor.roll_segment()
        if self.policy is None:
            return None
        d = self.policy.decide(self.monitor, delta_fill=self.delta.n,
                               delta_capacity=self.delta.capacity)
        if d.repack:
            self.repack()
        if d.demote.size:
            self.monitor.force_demote(d.demote)
        if d.promote.size:
            self.monitor.clear_demote(d.promote)
        cells = np.union1d(d.refit, d.promote).astype(np.int64)
        if cells.size and self.fit_state is not None:
            # a repack above may have widened the stale set; the chunk
            # is still sound — refit_cells re-diffs and retrains exactly
            # these cells against the new tree
            self.refit_cells(cells)
        else:
            if cells.size:
                d = _note_refit_skipped(self, d, cells.size)
            self._sync_guard()
        self.maintenance.append((self.monitor.seg_counter, d))
        return d

    def stats(self) -> FreshnessStats:
        return self.monitor.stats(delta_fill=self.delta.n)


class EngineFreshServer(FreshServer):
    """The ``FreshServer`` shape over the serving engine: serves through
    ``engine.make_two_tier_steps`` with the delta buffer as the step's
    ``delta_xy`` argument, so staging inserts changes no step. The steps
    serve a copy of the hybrid padded for the model axis
    (``engine.pad_tree_for_sharding``, ``_repad``): a change of tree
    (repack) or bank (refit chunk) re-pads it, a guard-only change
    (inserts, policy demotions) splices just the padded ``cell_ok``.
    Repacks, refit chunks and the policy loop are ``FreshServer``'s; the
    wide tier's flag is ``ServeStats.r_truncated``.

    With a ``mesh`` (``launch.mesh.Mesh``) every rank of it runs the
    server: each serves its shard of the padded hybrid
    (``engine.shard_for_rank``; ``cell_ok`` spliced as its local slice)
    and its rows of each batch (``Mesh.step``), and every rank runs the
    same maintenance loop on the host. The all-gathered stats feed every
    rank's monitor the same signal and the host's repacks are
    deterministic, so the ranks' trees agree. A refit chunk trains on
    the device, which need not give the same bits in two processes, so
    rank 0 alone runs each ``build.refit_cells`` and broadcasts the
    refitted AI side (bank, grid and ``cell_ok``), the ``FitState`` and
    the report to every rank (``Mesh.broadcast``).
    """

    trunc_field = "r_truncated"

    def __init__(self, points: np.ndarray, hybrid: HybridTree, cfg, *,
                 kind: str, mesh=None, delta_cap: int = 4096,
                 wide_factor: int = 8, fit_state=None,
                 policy: Optional[MaintenancePolicy] = None):
        from repro_torch.core import engine
        self._mesh = mesh
        self._axis = engine.ONE_RANK if mesh is None else mesh.model
        self._h_p, self._padded_from = None, (None, None)
        self._narrow, self._wide = engine.make_two_tier_steps(
            cfg, kind=kind, wide_factor=wide_factor, axis=self._axis)
        if mesh is not None:
            self._narrow = mesh.step(self._narrow)
            self._wide = mesh.step(self._wide)
        super().__init__(points, hybrid, delta_cap=delta_cap,
                         max_visited=cfg.max_visited, delta_k=cfg.delta_k,
                         wide_factor=wide_factor, fit_state=fit_state,
                         policy=policy)

    def _repad(self) -> None:
        """Full re-pad of the served copy (this rank's shard of it) —
        needed when the tree or the bank changed."""
        from repro_torch.core import engine
        h_p = engine.pad_tree_for_sharding(self.hybrid, self._axis.size)
        self._h_p = engine.shard_for_rank(h_p, self._axis)
        self._padded_from = (self.hybrid.tree, self.hybrid.ait.bank)

    def _sync_guard(self) -> None:
        super()._sync_guard()
        tree, bank = self._padded_from
        if tree is not self.hybrid.tree or bank is not self.hybrid.ait.bank:
            self._repad()
            return
        ok = self.hybrid.ait.cell_ok
        n, i = self._axis.size, self._axis.index
        C_loc = self._h_p.ait.cell_ok.shape[0]
        pad = C_loc * n - ok.shape[0]
        if pad:
            ok = torch.cat([ok, torch.zeros((pad,), dtype=ok.dtype,
                                            device=ok.device)])
        self._h_p = dataclasses.replace(self._h_p, ait=dataclasses.replace(
            self._h_p.ait, cell_ok=ok[i * C_loc:(i + 1) * C_loc]))

    def _refit(self, cells: Optional[np.ndarray]):
        if self._mesh is None:
            return super()._refit(cells)
        out = None
        if self._mesh.rank == 0:
            h, state, rep = buildlib.refit_cells(self.hybrid,
                                                 self.fit_state, cells)
            out = (h.ait, state, rep)
        ait, self.fit_state, rep = self._mesh.broadcast(out)
        self.hybrid = dataclasses.replace(self.hybrid, ait=ait)
        return rep

    def _serve(self, q, widen: int):
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        step = self._narrow if widen == 1 else self._wide
        return step(self._h_p, q, self.delta.xy)
