"""Spatial batch scheduler: Hilbert/Morton-ordered serving batches.

Incoming queries are keyed on a space-filling curve
(``kernels.ops.spatial_key``, on the stream's device), stably sorted, cut
into fixed-size batches (the ragged tail padded with its last query),
served, and restored to submission order. The serve step is per-query,
so sorted serving returns the same rows as arrival order
(``sort="none"``). Rows whose truncation flag is set (R-path
``max_visited`` overflow — their ``n_results`` undercounts) are
collected across the whole stream and re-served on a wide-bound tier.

Everything here is host-side orchestration (numpy permutations around the
serve step) except the curve keys; the device-side work stays in the
serve step itself.
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops as kops


SORT_MODES = ("none", "morton", "hilbert")


def workload_bbox(queries: np.ndarray) -> np.ndarray:
    """[Q, 4] rects → [4] bounding box of the rect *centers*.

    Degenerate extents (a single query, or every center coincident along
    an axis) are widened to a unit span around the collapsed value, so a
    key frame always has positive area.
    """
    c = (np.asarray(queries)[:, :2] + np.asarray(queries)[:, 2:]) / 2.0
    lo, hi = c.min(axis=0), c.max(axis=0)
    flat = hi - lo <= 0
    lo = np.where(flat, lo - 0.5, lo)
    hi = np.where(flat, hi + 0.5, hi)
    return np.concatenate([lo, hi]).astype(np.float32)


def point_query_mask(queries: np.ndarray) -> np.ndarray:
    """[Q, 4] → [Q] bool: degenerate rects (zero extent on both axes), the
    host twin of ``hybrid.is_point_query``."""
    q = np.asarray(queries, np.float32)
    return (q[:, 0] == q[:, 2]) & (q[:, 1] == q[:, 3])


def spatial_keys(queries: np.ndarray, sort: str,
                 bbox: Optional[np.ndarray] = None,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """[Q, 4] → [Q] i32 curve keys (zeros for ``sort="none"``), computed
    by ``ops.spatial_key`` on ``device`` and copied back.

    A caller-supplied ``bbox`` gets the same degenerate-extent guard as
    ``workload_bbox``: zero-extent axes are widened to a unit span.
    """
    if sort not in SORT_MODES:
        raise ValueError(f"sort must be one of {SORT_MODES}, got {sort!r}")
    q = np.asarray(queries, np.float32)
    if sort == "none":
        return np.zeros((q.shape[0],), np.int32)
    if bbox is None:
        bbox = workload_bbox(q)
    else:
        bbox = np.asarray(bbox, np.float32).copy()
        flat = bbox[2:] - bbox[:2] <= 0
        bbox[:2] = np.where(flat, bbox[:2] - 0.5, bbox[:2])
        bbox[2:] = np.where(flat, bbox[2:] + 0.5, bbox[2:])
    dev = resolve_device(device)
    keys = kops.spatial_key(torch.from_numpy(q).to(dev),
                            torch.from_numpy(bbox).to(dev), curve=sort)
    return keys.cpu().numpy()


class Schedule(NamedTuple):
    """A batching plan over one query stream."""
    order: np.ndarray    # [Q] i32 — stream position → submission index
    inv: np.ndarray      # [Q] i32 — submission index → stream position
    n_queries: int
    batch: int
    n_batches: int       # ceil(Q / batch); the tail batch is padded
    sort: str


def make_schedule(queries: np.ndarray, batch: int, sort: str = "hilbert",
                  bbox: Optional[np.ndarray] = None,
                  device: str | torch.device = "cuda") -> Schedule:
    """Key-sorted batch formation (stable, so scheduling is always a pure
    permutation). ``sort="none"`` keeps submission order."""
    q = np.asarray(queries, np.float32)
    n = q.shape[0]
    if n == 0 or batch <= 0:
        raise ValueError(f"need n_queries > 0 and batch > 0, got {n}/{batch}")
    keys = spatial_keys(q, sort, bbox, device)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(n, dtype=np.int32)
    return Schedule(order=order, inv=inv, n_queries=n, batch=int(batch),
                    n_batches=-(-n // int(batch)), sort=sort)


def iter_batches(queries: np.ndarray, sched: Schedule
                 ) -> Iterator[tuple[np.ndarray, int]]:
    """Yield ``(q [batch, 4] f32, n_valid)`` per stream batch.

    Every batch has the full static shape; the ragged tail is padded by
    repeating its last valid query, whose stats are simply dropped.
    """
    q = np.asarray(queries, np.float32)[sched.order]
    for b in range(sched.n_batches):
        lo = b * sched.batch
        chunk = q[lo:lo + sched.batch]
        n_valid = chunk.shape[0]
        if n_valid < sched.batch:
            pad = np.repeat(chunk[-1:], sched.batch - n_valid, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
        yield chunk, n_valid


def _to_host(stats):
    """A stats NamedTuple of tensors → the same NamedTuple of numpy."""
    return type(stats)(*(t.cpu().numpy() if torch.is_tensor(t)
                         else np.asarray(t) for t in stats))


def _rows(stats, sel):
    """Apply a leading-axis selection to every array of a stats tuple."""
    return type(stats)(*(np.asarray(a)[sel] for a in stats))


def _merge_rows(narrow, wide, idx: np.ndarray):
    """Replace ``narrow``'s rows at ``idx`` with ``wide``'s, field-wise.

    The wide tier's slot-table fields (result ids, ...) can be wider than
    the narrow tier's; they are rank-prefix tables, so wide rows are
    sliced to the narrow field shape.
    """
    merged = {}
    for f in type(narrow)._fields:
        a = np.asarray(getattr(narrow, f)).copy()
        w = np.asarray(getattr(wide, f))
        if w.shape[1:] != a.shape[1:]:
            if any(ws < ns for ws, ns in zip(w.shape[1:], a.shape[1:])):
                raise ValueError(
                    f"wide tier field {f!r} narrower than narrow tier's: "
                    f"{w.shape} vs {a.shape}")
            w = w[(slice(None),) + tuple(slice(0, n) for n in a.shape[1:])]
        a[idx] = w
        merged[f] = a
    return type(narrow)(**merged)


class ServeReport(NamedTuple):
    """Aggregate result of one scheduled stream."""
    stats: object           # per-query stats (numpy), submission order
    n_queries: int
    n_batches: int
    n_reserved: int         # rows re-served on the wide tier
    wide_batches: int
    sort: str


def serve_workload(serve_fn: Callable, queries: np.ndarray, *, batch: int,
                   sort: str = "hilbert",
                   bbox: Optional[np.ndarray] = None,
                   wide_fn: Optional[Callable] = None,
                   trunc_field: str = "truncated",
                   device: str | torch.device = "cuda") -> ServeReport:
    """Serve a full query stream through the scheduler.

    ``serve_fn``: ``[batch, 4]`` tensor on ``device`` → stats NamedTuple
    of per-query tensors (e.g. a ``hybrid_query`` closure). Every query is
    served exactly once and the returned stats (numpy) are in submission
    order. With ``wide_fn`` (same signature, wider bounds) rows whose
    ``trunc_field`` is set are re-served through it and their rows
    replaced (see ``_merge_rows``).
    """
    dev = resolve_device(device)
    sched = make_schedule(queries, batch, sort, bbox, dev)
    outs = []
    for chunk, n_valid in iter_batches(queries, sched):
        stats = _to_host(serve_fn(torch.from_numpy(chunk).to(dev)))
        outs.append(_rows(stats, np.s_[:n_valid]))
    stream = type(outs[0])(*(np.concatenate(xs, axis=0)
                             for xs in zip(*outs)))
    result = _rows(stream, sched.inv)   # back to submission order

    n_reserved = wide_batches = 0
    if wide_fn is not None and trunc_field is not None \
            and hasattr(result, trunc_field):
        trunc = np.asarray(getattr(result, trunc_field)).astype(bool)
        idx = np.flatnonzero(trunc)
        n_reserved = int(idx.size)
        if n_reserved:
            wide = serve_workload(wide_fn,
                                  np.asarray(queries, np.float32)[idx],
                                  batch=batch, sort=sort, bbox=bbox,
                                  wide_fn=None, trunc_field=None,
                                  device=dev)
            wide_batches = wide.n_batches
            result = _merge_rows(result, wide.stats, idx)
    return ServeReport(stats=result, n_queries=sched.n_queries,
                       n_batches=sched.n_batches, n_reserved=n_reserved,
                       wide_batches=wide_batches, sort=sort)


class MixedReport(NamedTuple):
    """Aggregate result of one mixed read/write stream."""
    stats: object           # per-query stats (numpy), submission order
    n_queries: int
    n_batches: int
    n_reserved: int         # rows re-served on the wide tier
    n_inserts: int          # points staged into the delta store
    n_repacks: int          # online repacks performed mid-stream
    #                         (scheduler-initiated via repack_every;
    #                         policy repacks live in ``maintenance``)
    n_segments: int         # insert-delimited spans of the query stream
    seg_bounds: tuple       # per-segment (start, end) submission indices
    staged: tuple           # per-segment insert chunk ([m, 2] f32 or
    #                         None) ACTUALLY staged before segment s,
    #                         plus one trailing after-stream entry —
    #                         oracles derive each segment's visible point
    #                         set from this, never by re-deriving the
    #                         chunking policy
    sort: str
    maintenance: tuple = ()  # per-segment (segment_index, decision)
    #                         entries from the server's ``on_segment``
    #                         hook (maintenance-policy servers only)


def visible_segments(report: MixedReport, base_points: np.ndarray):
    """Yield ``((lo, hi), visible)`` per segment of a mixed stream:
    ``visible`` is the [N, 2] f32 point set the segment's queries could
    see — ``base_points`` plus every chunk the scheduler reports it
    actually staged before that segment (``report.staged``)."""
    visible = np.asarray(base_points, np.float32)
    for s, (lo, hi) in enumerate(report.seg_bounds):
        if report.staged[s] is not None:
            visible = np.concatenate([visible, report.staged[s]])
        yield (lo, hi), visible


def serve_mixed_workload(server, queries: np.ndarray,
                         inserts: Optional[np.ndarray], *, batch: int,
                         sort: str = "hilbert",
                         bbox: Optional[np.ndarray] = None,
                         insert_every: int = 1,
                         repack_every: int = 0) -> MixedReport:
    """Serve a query stream with insert batches interleaved.

    ``server`` owns the live serving state (``core.monitor.FreshServer``):
    ``serve(q)``/``serve_wide(q)`` answer batches, ``insert(points)``
    stages writes, ``repack()`` swaps in a rebuilt tree, ``delta_fill``
    reports the buffer level, ``trunc_field`` names the wide-tier flag and
    ``device`` the stream's device.

    The stream is cut into *segments* of ``insert_every`` query batches;
    before each segment after the first, the next chunk of ``inserts`` is
    staged (so segment ``s`` sees exactly the first ``s`` chunks), and a
    repack fires whenever the buffer holds ≥ ``repack_every`` points (0 =
    never). Inserts with no later segment to precede — all of them when
    the stream fits in one segment — are staged after the final segment,
    so every insert lands in the server. Within a segment the delta store
    is frozen, so each segment runs through ``serve_workload`` (sorted
    serving equals arrival order within it, and the wide re-serve happens
    per segment). Stats come back in submission order.
    """
    q = np.asarray(queries, np.float32)
    n = q.shape[0]
    ins = None if inserts is None else np.asarray(inserts, np.float32)
    if bbox is None:
        bbox = workload_bbox(q)
    seg = max(1, int(insert_every)) * int(batch)
    n_segments = -(-n // seg)
    chunks = [None] * (n_segments + 1)
    if ins is not None and ins.shape[0]:
        if n_segments > 1:
            chunks[1:-1] = np.array_split(ins, n_segments - 1)
        else:
            chunks[-1] = ins    # no later segment: stage after the stream

    def _stage(chunk):
        count = 0
        if chunk is not None and chunk.shape[0]:
            server.insert(chunk)
            count = int(chunk.shape[0])
            if repack_every and server.delta_fill >= repack_every:
                server.repack()
                return count, 1
        return count, 0

    outs, bounds, maint = [], [], []
    n_batches = n_reserved = n_inserts = n_repacks = 0
    on_segment = getattr(server, "on_segment", None)
    for s in range(n_segments):
        ni, nr = _stage(chunks[s])
        n_inserts += ni
        n_repacks += nr
        lo, hi = s * seg, min((s + 1) * seg, n)
        rep = serve_workload(server.serve, q[lo:hi], batch=batch, sort=sort,
                             bbox=bbox, wide_fn=server.serve_wide,
                             trunc_field=getattr(server, "trunc_field",
                                                 "truncated"),
                             device=server.device)
        outs.append(rep.stats)
        bounds.append((lo, hi))
        n_batches += rep.n_batches
        n_reserved += rep.n_reserved
        # between-segments maintenance window: never under a running
        # segment, so each segment serves against frozen state
        if on_segment is not None:
            decision = on_segment()
            if decision is not None:
                maint.append((s, decision))
    ni, nr = _stage(chunks[n_segments])
    n_inserts += ni
    n_repacks += nr
    # per-segment stats are host numpy already: concatenate on the host,
    # in submission order
    stats = type(outs[0])(*(np.concatenate(xs, axis=0)
                            for xs in zip(*outs)))
    return MixedReport(stats=stats, n_queries=n, n_batches=n_batches,
                       n_reserved=n_reserved, n_inserts=n_inserts,
                       n_repacks=n_repacks, n_segments=n_segments,
                       seg_bounds=tuple(bounds), staged=tuple(chunks),
                       sort=sort, maintenance=tuple(maint))
