#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py                  # the deployment below
    python3 chip_smoke.py --points 100000  # a cut (printed as such)
    python3 chip_smoke.py --large-points 4000000   # a cut of phase 9
    python3 chip_smoke.py --engine-only    # phases 1-3, 7b and 7c alone

Phases, each failing the run (non-zero exit) on its own error:

1. print the card's name and power limit (``nvidia-smi``);
2. build the thirteen CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. build the serving index through ``repro_torch.launch.serve`` at the
   Chicago Crimes scale of the paper (872K points, node capacity 128,
   4096 queries at selectivity 5e-5, MLP bank);
4. hold each kernel against its plain PyTorch version on the card, at the
   shapes the serving paths give it plus edge rows, and time both (the
   ancestor-sliced walks with the deployed tree's own table, also against
   the full-walk kernels; mbr_intersect on every level, plain and folded
   with the level above's mask, each level timed; leaf_refine's
   mask and slot counts at the narrow K 64 and at the join's wide K 512;
   traverse_compact on the batch at k 64 and at the wide k 512;
   forest_infer on the router's features, which it gathers itself;
   spatial_key through its contract (rects and frame in) on the stream's
   rects, the edge centres as degenerate rects under the unit frame, a
   zero-extent frame and ``bbox=None``, a call with a frame one device
   activity (CUPTI);
   knn_browse in both forms, the [B, K, M] distances and the selecting
   form ``knn_query`` calls (the k smallest, their ids and the in-radius
   count), on edge rows, then the selecting form timed on the kNN
   stream's first narrow and wide batches; delta_probe at every fill of
   the mixed stream's buffer);
5. stream the range workload through ``hybrid_query`` in Hilbert order
   (batch 512, narrow ``max_visited`` 64, wide tier x8) with every launch
   count reset just before and read just after; check the ``# oracle``
   against the workload labels and 512 sampled queries against f32
   brute-force containment; serve the same stream in arrival order as a
   comparison (reported, not gated) and profile both (device busy, idle,
   device activities a batch);
6. on the same index, serve a kNN, a spatial-join and a point stream
   (4096 queries each, one timed repetition), each with its launch
   counts reset and read around it and its oracle at 0 mismatches; the
   kNN stream's profile must hold no sort kernel (its device busy time
   printed beside the one before the selecting form);
7. serve the mixed read/write stream (``--insert-rate``'s path): the
   range workload in Hilbert order, batch 512, one batch per segment,
   with 8,192 new records of the same synthetic city
   (``crimes_like(8192, seed=1)``, shuffled) staged between segments
   into a ``FreshServer`` (delta capacity 8,192, delta slots 64 narrow
   and 512 wide) under ``DefaultPolicy(refit_chunk=4, repack_at=0.75)``
   with the build's ``FitState``; gates: probe launches equal to the
   batches served, every insert staged, at least one repack, one refit
   chunk and one delta hit, 0 ``n_results`` mismatches against
   brute-force containment of each segment's visible points and 0
   id-set mismatches on 512 sampled rows; then the wall split (serving,
   repack, refit) and a profile of one ``FreshServer.serve`` pass over
   the 4096 queries at a delta fill of 6,144;
7b. the serving engine at one rank (``core.engine``) with the settings
   of ``src/repro/launch/serve.py --distributed`` (``EngineConfig(max_visited=64)``:
   max_pred 16, max_cells 4, topk union, guard on, delta slots 64; wide
   x8): the range stream through ``make_two_tier_steps`` and the point
   stream through ``make_point_serve_step`` (Hilbert order, batch 512,
   launch counts reset just before and read just after 4 streams each,
   one profiled stream), then the mixed stream through
   ``EngineFreshServer`` with phase 7's inserts, policy and fit state;
   gates: ``n_results`` equal row for row to the hybrid range and point
   streams and to ``FreshServer``'s mixed stream, no ``r_truncated``
   left, and per served batch exactly one ``traverse_compact``, two
   ``leaf_refine``, one ``mlp_predict_compact`` and one ``forest_infer``
   (plus one ``delta_probe`` in the mixed stream), no ``traverse_fused``;
7c. the same three streams through the engine over a 1x2 mesh
   (``launch.mesh``, data 1 x model 2: the reference driver's mesh at
   two devices), two ranks of this script sharing ``cuda:0`` over
   ``gloo`` (``--engine-mesh-rank``, the environment
   ``torch.distributed.run`` gives its workers, a free port on
   127.0.0.1), each serving its shard of the index saved once by this
   process, the mixed stream through ``EngineFreshServer`` over the
   mesh; gates: both ranks exit 0 within ``MESH_TIMEOUT_S``,
   ``n_results`` equal row for row to phase 7b's on every stream and
   rank, no ``r_truncated`` left, the launches a step of phase 7b on
   each rank, the ranks' hybrids (tree, bank, ``cell_ok``) equal after
   each maintenance step of the mixed stream; per-rank launches and rates printed beside the card (their
   collectives cross the host: no multi-GPU deployment's rate); the ranks
   serve while this process fits phase 8's forest bank on the host (one
   timed repetition of each stream, cut from 7b's 3, for the smoke's time
   limit);
8. the forest bank (``--classifier forest``) at the deployment:
   ``fit_airtree(kind="forest")`` on the same tree and labelled workload,
   the range stream in Hilbert order through it (gates: 0 mismatches
   against the labels and against brute force on 512 sampled queries,
   ``mlp_predict_compact`` never launched); then the bank's dense form
   (``forest.cell_probs_dense``, the path of forest_infer_cells) over the
   4096 queries in batches of 512, launch counts reset and read around
   it, each batch bit-equal to the gathered form over every cell; and
   forest_infer_cells against its plain version, bit-equal, on one such
   batch and on a synthetic bank (4 trees of depth 8 a cell, 37 labels,
   empty cells);
9. the open loop (``--arrival poisson``): the MLP range stream under
   Poisson arrivals at 1.5x the capacity measured on the card, with the
   driver's automatic deadline (both from one measurement, so the two
   runs see the same arrivals), for ``--formation deadline`` and
   ``full``; gates:
   0 mismatches on the rows not degraded, the main path's kernels
   launched; p50/p95/p99 latency, goodput and degraded rows printed;
10. drive every rung of the walk ladder through ``ops.traverse_fused`` /
   ``ops.traverse_compact``: a synthetic 1.5M-leaf STR hierarchy whose
   full walks pass one CTA's shared memory takes both sliced kernels;
   with a degenerate table the dense walk takes the per-level
   mbr_intersect loop (its device activities, CUPTI: one mbr_intersect a
   level and nothing else; the step timed, and mbr_intersect on the two
   widest levels, plain and folded); a single-level tree is one
   mbr_intersect; launch counts per step, each result bit-equal to its
   plain version; then traverse_fused_sliced timed on the 1.5M-leaf tree
   with its built table (512 x 1.5M, against the mask write's bound);
11. build the large index (``tweets_like`` 40M points, 20x the paper's
   Tweets set, ``str_bulk`` at capacity 128, flattened onto the card),
   whose compact walk needs the ancestor-sliced kernel, and serve the
   kNN and join streams on it (serve.py's defaults; join selectivity
   1e-6); gates: traverse_compact_sliced launched, no full walk, oracles
   at 0 mismatches, at least 200 of 256 sampled join rows not truncated;
   traverse_compact_sliced bit-equal to its plain version and timed
   (each of its count, scan and write kernels, CUPTI) on the kNN
   stream's first narrow batch (k 64) and first wide batch (the rows the
   narrow tier flags, at twice the radius, k 512); on the same batches,
   for information, the full compact walk (off this index's rung),
   bit-equal to it and timed; knn_browse's selecting form bit-equal and
   timed on the same two batches; the kNN stream's profile without a
   sort;
12. the rwkv6-3b serving path at the published width (32 layers, d_model
   2560, 40 heads of 64, d_ff 8960, vocab 65536; ``init_params`` in bf16
   from ``torch.Generator`` seed 0, on the card): ``forward`` at [1, 32768]
   and [8, 4096] (cut from prefill_32k's batch 32: the full logits would
   take 137 GB), each with its launch counts reset and read around one
   forward (gates: 32 wkv6 launches, finite logits), tokens/s, device ms
   and wkv6 ms a call (its three kernels, each printed) beside its bound;
   wkv6 against its plain version (rtol = atol = 5e-4) on layer 0's real
   inputs and on T 33 and 4097, decay in [1e-8, 0.1], w = 0 rows, w = 0
   at sub-chunk and chunk bounds and bf16 inputs; decode against
   forward with f32 weights on a [4, 256] prompt (rel < 2e-2); greedy
   decode at batch 128 (16 prompt + 32 tokens; gates: finite logits, 0
   wkv6 launches);
13. rwkv6-3b training (``train_phase``): ``ops.wkv6`` under autograd
   (the kernel forward, the plain scan recomputed for the backward)
   against the plain scan under autograd at a full-width layer's
   [320, 128, 64] and at T 37 (5e-4); one train step on the card
   against the same step on the CPU, at ``reduced(rwkv6_3b)`` and at
   the published width cut to one layer (loss and grad norm within
   1e-4 relative); then ``launch/train.py``'s defaults at
   the published width (batch 8 x seq 128, float32, AdamW, remat
   "dots") for 3 steps through its ``setup`` and step (gates: finite
   loss and grad norm, 64 wkv6 launches a step, params changed), with
   step ms, tokens/s, peak memory, a CUPTI profile of one more step,
   and the forward kernel's and the plain backward's device ms a call;
13b. the nine other LM families' training (``lm_train_phase``): one
   driver step on the card against the same step on the CPU from the
   same float32 weights at each config's ``reduced(...)`` and at
   h2o-danube3-4b's published width cut to one layer (loss and grad
   norm within 1e-4 relative); then each config at its published width
   (``LM_TRAIN``: whisper-small at its published depth through
   ``launch/train.py``'s ``setup``, hymba-1.5b cut to 8 of 32 layers for
   the smoke's time limit, the others cut to the
   deepest depth whose params, grads, m and v fit 60 GB, llama3-405b
   and deepseek-v2-236b with bf16 params and AdamW state), 3 steps of
   the driver's defaults (batch 8 x seq 128, AdamW, remat "dots", seed
   0): gates: finite loss and grad norm, params changed in every stack
   (``embed``, each stack's ``attn/wo``, the MoE router, the
   cross-attention), no kernel of the thirteen launched; step ms,
   tokens/s, peak memory, a CUPTI profile of one more step;
13c. rwkv6-3b training over a mesh (``train_mesh_phase``): two ranks of
   this script (``--train-mesh-rank``) sharing ``cuda:0`` over ``gloo``,
   at the published width cut to ``TRAIN_MESH_LAYERS`` layer (printed
   with the reckoned memory and the reason: the phase's time), 3 steps
   of ``launch/train.py``'s defaults on a 1x2 and then a 2x1 mesh
   (``launch/sharding.py``'s rules: params, m and v sharded at rest, the
   params gathered and the gradients summed over ``data`` each step),
   then the one-rank steps from the same seed, plain and at ``--accum
   2`` (the 2x1 mesh's float order); gates: each mesh's loss and grad
   norm within 1e-4 relative of the plain step's, its params, m and v
   within 4e-3 / 1e-3 / 2e-3 of each leaf's largest value (the plain
   float32 step's own distance from float64,
   ``launch/float_witness.py``), each mesh bit-equal to the one-rank
   steps in its float order, both ranks' gathered params bit-equal, 2 x
   depth ``wkv6`` launches a step on every rank, a checkpoint written at
   2x1 restored at 1x2 and on one rank giving the 2x1 mesh's next loss;
   ms a step and tokens/s, collectives a step and ms each (host clock,
   one more step), peak memory a rank and a profiled step's idle share;
14. the seven configs served with plain GQA attention (``lm_phase``),
   each from ``init_params`` in bf16 (``torch.Generator`` seed 0, on the
   card) at its published width: whisper-small at its published depth;
   gemma2-9b cut to 14 of 42 layers (7 local/global pairs),
   h2o-danube3-4b and hymba-1.5b to 8 of 24 and 32 (all three for the
   smoke's time limit); llama3-405b, qwen2-72b and qwen2-vl-72b
   (``embeds`` input) cut to 2 layers (their bf16 weights do not fit
   one card).
   Prefill ``forward`` at the longest listed shape whose reckoned peak
   fits (gemma2 [1, 32768], else [1, 16384]; h2o [1, 32768]; hymba
   [1, 2048]; whisper [8, 448] with ``frames [8, 1500, 768]``; the cut
   ones [1, 4096]): tokens/s, device ms (CUPTI; hymba's per-token Mamba
   loop is not profiled), peak memory. Greedy decode against 32768
   slots (O(window) for swa) at the batch wanted (gemma2 8, h2o and
   hymba 128, the rest 8), halved until the weights and two caches fit
   (a step returns a new cache): 16 prompt + 32 tokens, tokens/s, a
   profiled step's wall against device busy, the cache copy's share,
   peak memory; whisper's cross cache filled from the encoder as the
   reference's test helper does. Gates: no kernel of the thirteen
   launched on any of these paths, finite logits, the logits' shape,
   the cache's ``pos``; decode against forward in f32 at 2 layers (one
   gemma2 pair) on a prompt 64 tokens past the window (the rings wrap),
   rel < 2e-2, argmax equal; then the moe pair the same way:
   deepseek-moe-16b cut to 6 of 28 layers for the time limit (1 dense,
   5 MoE; prefill [1, 32768] if its reckoned peak, the MoE
   block's transients included, fits, else [1, 16384]; decode wanted at
   batch 8, cut to what fits) and deepseek-v2-236b at its published
   width cut to 2 layers (1 dense, 1 MoE; MLA's latent cache; prefill
   [1, 4096], decode at batch 8), each MoE layer's dropped pairs and
   expert load at the published capacity factor 1.25, decode's
   per-row gather of the experts' weights timed alone beside the step,
   decode against forward at the drop-free capacity;
15. print the ``kernels:`` line, the serving and training rates beside
   the card, the per-kernel JSON line, and the contract's last line.

It imports neither JAX nor the JAX package, and refuses to run without a
CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Deployment: the paper's Chicago Crimes dataset size (872K points).
POINTS = 872_000
QUERIES = 4096
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
TF32_OPS_PER_S = 495e12          # H100 SXM TF32 tensor cores, dense
NEAR = 1e-5                      # MLP scores this close to the threshold
#                                  may flip between kernel and plain
TIMING_REPS = 30
INSERTS = 8192                   # the mixed stream's new records
LARGE_POINTS = 40_000_000        # the large index: 20x the paper's Tweets
DELTA_CAP = 8192                 # repro.launch.serve's --delta-cap
# The kNN streams' device busy ms before knn_browse picked the k smallest
# on chip (a full stable sort did): PERF.md section 5, NVIDIA H100 80GB
# HBM3 at 700 W
KNN_BUSY_BEFORE = {"knn": 14.286, "knn (large index)": 30.283}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median time of ``fn()`` between two CUDA events around each call
    (after two warm-up calls). For a call shorter than its own launch
    this measures the launch: the card waits for the host in between."""
    import torch
    fn()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_events(prof, match: str | None = None) -> list:
    """The profile's device-side events (kernels, copies, sets), those
    whose name contains ``match`` when given."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and (match is None or match in e.name)]


def kernel_means(events) -> dict:
    """Mean duration (ms) of ``events`` by kernel: a name's first
    identifier before its argument list, so the launches of one kernel
    share a key."""
    by: dict = {}
    for e in events:
        m = re.search(r"\w+(?=\()", e.name)
        by.setdefault(m.group(0) if m else e.name, []).append(
            e.time_range.elapsed_us() / 1e3)
    return {n: sum(t) / len(t) for n, t in by.items()}


def profiled_events(fn, match: str | None = None,
                    reps: int = TIMING_REPS) -> list:
    """The device events (``cuda_events``) of ``reps`` calls of ``fn()``
    under ``torch.profiler`` (CUPTI), after two warm-up calls. A profile
    that recorded no matching activity is taken once more; after two
    empty ones the list is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = cuda_events(prof, match)
        if ev:
            return ev
    return []


def device_ms(fn, match: str | None = None,
              reps: int = TIMING_REPS) -> tuple[float, str]:
    """Device time per call of ``fn()``: the summed CUPTI durations of
    the device work it issues over ``reps`` calls (``profiled_events``).
    With ``match``, ``fn`` launches one kernel whose name contains it,
    and the time is the mean over the launches the profile recorded (it
    can miss some of a run of long launches; the source then says how
    many it kept). After two empty profiles it falls back to
    ``event_ms``. The second value names the source."""
    ev = profiled_events(fn, match, reps)
    if ev:
        n = reps if match is None else len(ev)
        src = "cupti" if n == reps else \
            f"cupti, {n} of {reps} launches recorded"
        return sum(e.time_range.elapsed_us() for e in ev) / n / 1e3, src
    return event_ms(fn, reps), "cuda-events"


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_row(name, mism, launch, plain, n_bytes, n_ops,
               max_abs_err=0.0, plain_reps=TIMING_REPS, label="") -> dict:
    """Time ``launch`` (the kernel alone: the mean CUPTI time of each
    kernel whose name contains ``<name>_kernel``, summed over the kernels
    one launch issues) and ``plain`` on the card (``plain_reps`` calls
    for a plain version of thousands of launches), print them beside the
    bound, and return the kernel's JSON row (launch count filled in
    later), with each kernel's time under ``pass_ms`` when a launch
    issues several."""
    b, by = bound_ms(n_bytes, n_ops)
    passes = kernel_means(profiled_events(launch, f"{name}_kernel"))
    ms = sum(passes.values()) if passes else event_ms(launch)
    src = "cupti" if passes else "cuda-events"
    if len(passes) > 1:
        src += ", mean a launch: " + ", ".join(
            f"{n} {v:.4f}" for n, v in passes.items())
    plain_ms, psrc = device_ms(plain, reps=plain_reps)
    print(f"  {name}{label}: {mism} mismatches, kernel {ms:.4f} ms ({src}; "
          f"{event_ms(launch):.4f} ms between events), plain "
          f"{plain_ms:.4f} ms ({psrc}; {event_ms(plain, plain_reps):.4f} "
          f"ms between events), bound {b:.4f} ms ({by})")
    row = json_row(name, ms, plain_ms, b, by, max_abs_err)
    if len(passes) > 1:
        row["pass_ms"] = passes
    return row


def json_row(name, ms, plain_ms, b, by, max_abs_err) -> dict:
    """A kernel's row of the JSON line (launch count filled in later)."""
    from repro_torch.kernels import cuda as kcuda
    k = kcuda.KERNELS[name]
    return {"name": name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)),
            "replaces": k.replaces, "launches": 0,
            "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": None}


def kernel_checks(idx, args, base_argv, dev, inserts) -> list:
    """Phase 4: each kernel against its plain version at the serving
    path's shapes (one narrow batch), with edge rows; returns the JSON
    rows (launch counts filled in later)."""
    import torch
    from repro_torch.core import traversal
    from repro_torch.core.classifiers.router import router_features
    from repro_torch.core.grid import cells_of_queries
    from repro_torch.kernels import cuda as kcuda, ops, ref

    tree, hyb = idx.dtree, idx.hybrid
    B = args.batch
    q = torch.from_numpy(idx.workload.queries[:B].copy()).to(dev)
    leaf = tree.levels[-1].mbrs
    corner = tree.leaf_entries[0, 0]
    q[0] = torch.tensor([1e9, 1e9, 1e9 + 1, 1e9 + 1], device=dev)  # empty
    q[1] = torch.stack([corner[0], corner[1], corner[0], corner[1]])
    q[2] = torch.stack([leaf[5, 2], leaf[5, 1], leaf[5, 2] + 1e-3,
                        leaf[5, 3]])                  # touches an edge
    rows = []

    def row(name, mism, launch, plain, n_bytes, n_ops, max_abs_err=0.0):
        rows.append(kernel_row(name, mism, launch, plain, n_bytes, n_ops,
                               max_abs_err))

    # -- traverse_fused: dense visited mask of one batch
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    launch, vis = ops.prepare("traverse_fused", q, mb, pa)
    launch()
    want = ref.traverse_fused(q, mb, pa)
    mism = int((vis != want).sum())
    check(mism == 0, f"traverse_fused: {mism} mismatches")
    check(not bool(vis[0].any()), "traverse_fused: empty row visits leaves")
    L = tree.n_leaves
    tests, nodes = walk_work(q, mb, pa)
    row("traverse_fused", mism, launch,
        lambda: ref.traverse_fused(q, mb, pa),
        B * 16 + nodes * 20 + B * L, tests * 4)

    # -- leaf_refine, mask and slot counts: the narrow R path's slot table
    #    with edge rows, then the batch at the join's wide tier (K 512:
    #    the join re-serves every row wide)
    K = args.max_visited
    li, valid, _ = traversal.compact_mask_counted(want, K)
    li, valid = li.clone(), valid.clone()
    li[3, :6] = torch.tensor([-1, L, L + 9, 0, -3, L + 2], device=dev)
    valid[3, :4] = False                                 # padded slots
    valid[3, 4:6] = True               # out of range, clamped by the kernel
    valid[4] = False                                     # empty row
    wi, wv, _ = ops.traverse_compact(q, mb, pa, K * args.wide_factor)
    M = tree.leaf_entries.shape[1]
    ex, ey = tree.leaf_entries[..., 0], tree.leaf_entries[..., 1]
    tiers = []
    for tier, (ids, ok) in enumerate(((li, valid), (wi, wv))):
        Kt = ids.shape[1]
        launch, (inside, cnt) = ops.prepare("leaf_refine", q,
                                            tree.leaf_entries, ids, ok)
        launch()
        want_in, want_cnt = ref.leaf_refine_counted(q, ex, ey, ids, ok)
        mism = int((inside != want_in).sum()) + int((cnt != want_cnt).sum())
        check(mism == 0, f"leaf_refine (K {Kt}): {mism} mismatches (mask "
              "and counts, bit-exact)")
        check(tier or not bool(inside[4].any()),
              "leaf_refine: empty row matched")
        n_leaves = int(torch.unique(torch.clamp(ids, 0, L - 1)[ok]).numel())
        tiers.append(kernel_row(
            "leaf_refine", mism, launch,
            lambda ids=ids, ok=ok: ref.leaf_refine_counted(q, ex, ey, ids,
                                                           ok),
            B * 16 + B * Kt * 5 + n_leaves * M * 8 + B * Kt * M + B * Kt * 4,
            int(ok.sum()) * M * 4, label=f" (K {Kt}, {n_leaves} leaves)"))
    rows.append(tiers[0])
    rows[-1]["wide"] = {key: tiers[1][key] for key in
                        ("ms", "plain_ms", "bound_ms", "bound_by")}

    # -- mlp_predict_compact: the deployed bank on this batch
    ait = hyb.ait
    bank = ait.bank
    ids, ok, _ = cells_of_queries(ait.grid, q, ait.max_cells)
    x, cid = ops.mlp_inputs(q, bank, ids)
    kp = ait.max_pred
    launch, (kidx, kcnt) = ops.prepare("mlp_predict_compact", x, cid, ok,
                                       bank, L, kp, ait.threshold)
    launch()
    plain = lambda: ref.mlp_predict_compact(  # noqa: E731
        x, cid, ok, bank.w1, bank.b1, bank.w2, bank.b2, bank.label_map,
        bank.lmask, n_leaves=L, k=kp, threshold=ait.threshold)
    pidx, _, pcnt = plain()
    scores = ref.mlp_predict_scores(x, cid, ok, bank.w1, bank.b1, bank.w2,
                                    bank.b2, bank.label_map, bank.lmask, L)
    near = torch.nonzero(((scores - ait.threshold).abs() < NEAR).any(1))
    near = set(near.flatten().tolist())
    bad = torch.nonzero((kidx != pidx).any(1) | (kcnt != pcnt)).flatten()
    bad = [int(r) for r in bad.tolist()]
    if near:
        print(f"  mlp_predict_compact: near-threshold rows {sorted(near)} "
              f"(reported, differing: {[r for r in bad if r in near]})")
    mism = sum(1 for r in bad if r not in near)
    check(mism == 0, f"mlp_predict_compact: rows {bad} differ")
    keep = [r for r in range(B) if r not in near]
    max_err = float((kcnt[keep] - pcnt[keep]).abs().max())
    mlp_edge_rows(bank, L, kp, dev)
    C, F, H = bank.w1.shape
    Cl = bank.w2.shape[-1]
    n_slots = int(ok.sum())
    cells = int(torch.unique(cid[ok]).numel())
    row("mlp_predict_compact", mism, launch, plain,
        B * F * 4 + B * ids.shape[1] * 5
        + cells * (F * H + H + H * Cl + Cl * 2 + Cl / 4) * 4
        + B * kp * 4 + B * 4,
        n_slots * 2 * (F * H + H * Cl), max_abs_err=max_err)

    # -- forest_infer: the router on this batch's features (the kernel
    #    gathers them), some exactly on their thresholds
    rt = hyb.router
    feats = router_features(q)
    feats[5, rt.feat_idx[0, 0]] = rt.thresh[0, 0]
    feats[6, rt.feat_idx[1, 3]] = rt.thresh[1, 3]
    launch, votes = ops.prepare("forest_infer", feats, rt.feat_idx,
                                rt.thresh, rt.tables)
    launch()
    plain = lambda: ref.forest_infer(  # noqa: E731
        ref.forest_select(feats, rt.feat_idx), rt.thresh, rt.tables)
    want_v = plain()
    mism = int((votes != want_v).sum())
    check(mism == 0, f"forest_infer: {mism} mismatches (bit-exact)")
    T, D = rt.feat_idx.shape
    Cr = rt.tables.shape[-1]
    row("forest_infer", mism, launch, plain,
        feats.numel() * 4 + T * D * 8 + rt.tables.numel() * 4 + B * Cr * 4,
        B * T * (D + Cr),
        max_abs_err=float((votes - want_v).abs().max()))
    rows.append(spatial_key_check(idx, dev))
    rows.append(traverse_compact_check(idx, q, dev))
    rows.append(knn_browse_check(idx, args, base_argv, dev))
    rows.append(delta_probe_check(idx, args, dev, inserts))
    rows += sliced_checks(idx, q, dev)
    return rows


def sliced_checks(idx, q, dev) -> list:
    """mbr_intersect on the batch against every level of the deployed
    tree, plain and folded, each level timed; both ancestor-sliced
    kernels with the tree's own table, bit-equal to their plain versions
    and to the full-walk kernels (compact at k 64 and 512 with strip rows
    visiting 0, k and k + 1 leaves). Returns the
    mbr_intersect and traverse_fused_sliced rows (the compact one is
    timed on the 40M-point index, where the serving path runs it)."""
    import torch
    from repro_torch.data import synth
    from repro_torch.kernels import ops, ref
    tree = idx.dtree
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    sl = tree.aslices
    B, L = q.shape[0], tree.n_leaves
    print(f"  ancestor table of the deployed tree: levels "
          f"{[int(m.shape[0]) for m in mb]}, windows {sl.widths}, "
          f"{sl.n_tiles} tiles of {sl.tl} leaves")
    mask = None
    for m, p in zip(mb, pa):
        for fold in ((), (mask, p)) if mask is not None else ((),):
            launch, hit = ops.prepare("mbr_intersect", q, m, *fold)
            launch()
            mism = int((hit != ref.mbr_intersect(q, m, *fold)).sum())
            check(mism == 0, f"mbr_intersect ({m.shape[0]} MBRs"
                  f"{', folded' if fold else ''}): {mism} mismatches")
        mask = hit
    check(torch.equal(mask, ref.traverse_fused(q, mb, pa)),
          "mbr_intersect folded level by level differs from the walk")
    print("  mbr_intersect: bit-equal to its plain version at every level "
          "of the deployed tree, plain and folded (the parent's mask "
          "through its parents); folded level by level it is the walk")
    launch, vis = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    launch()
    want = ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths, sl.tl)
    flaunch, full = ops.prepare("traverse_fused", q, mb, pa)
    flaunch()
    mism = int((vis != want).sum())
    check(mism == 0, f"traverse_fused_sliced: {mism} mismatches")
    check(torch.equal(vis, full), "traverse_fused_sliced differs from the "
          "full walk's kernel")
    for k in (64, 512):
        qk = q.clone()
        qk[-3:] = torch.from_numpy(synth.strip_queries(
            mb[-1].cpu().numpy(), [0, k, k + 1])).to(dev)
        launch, (kidx, kcnt) = ops.prepare("traverse_compact_sliced", qk, mb,
                                           pa, sl, k)
        launch()
        pidx, _, pcnt = ref.traverse_compact_sliced(
            qk, mb, pa, sl.starts, sl.widths, sl.tl, k)
        flaunch, (fidx, fcnt) = ops.prepare("traverse_compact", qk, mb, pa,
                                            k)
        flaunch()
        mism = int((kidx != pidx).sum()) + int((kcnt != pcnt).sum())
        check(mism == 0, f"traverse_compact_sliced (k={k}): {mism} "
              "mismatches")
        check(torch.equal(kidx, fidx) and torch.equal(kcnt, fcnt),
              f"traverse_compact_sliced (k={k}) differs from the full walk")
        check(kcnt[-3:].tolist() == [0, k, k + 1],
              f"traverse_compact_sliced: strip rows visit "
              f"{kcnt[-3:].tolist()}")
    print(f"  traverse_fused_sliced and traverse_compact_sliced: bit-equal "
          f"to their plain versions and to the full-walk kernels (k 64 and "
          f"512, strip rows visiting 0, k, k + 1)")
    tests, nodes = walk_work(q, mb, pa)
    launch, _ = ops.prepare("traverse_compact_sliced", q, mb, pa, sl, 64)
    kernel_row("traverse_compact_sliced", 0, launch,
               lambda: ref.traverse_compact_sliced(q, mb, pa, sl.starts,
                                                   sl.widths, sl.tl, 64),
               B * 16 + nodes * 20 + sl.starts.numel() * 4 + B * 65 * 4,
               tests * 4, label=" (deployment, k 64)")
    for m in mb:    # every level; the leaf level's row is the JSON row
        n = int(m.shape[0])
        launch, _ = ops.prepare("mbr_intersect", q, m)
        row = kernel_row("mbr_intersect", 0, launch,
                         lambda m=m: ref.mbr_intersect(q, m),
                         (B + n) * 16 + B * n, B * n * 4,
                         label=f" ({B} x {n})")
    rows = [row]
    launch, _ = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    rows.append(kernel_row(
        "traverse_fused_sliced", 0, launch,
        lambda: ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths,
                                          sl.tl),
        B * 16 + nodes * 20 + sl.starts.numel() * 4 + B * L, tests * 4))
    return rows


def routing_phase(idx, dev) -> dict:
    """Every rung of the walk ladder through the normal wrappers. A
    synthetic 1.5M-leaf STR hierarchy (fanout 89: levels 1, 3, 190,
    16,854, 1.5M) passes one CTA's shared memory on both full walks:
    with its table both walks take the sliced kernels; with a degenerate
    table (every window the whole lane-padded level) the dense walk takes
    the per-level mbr_intersect loop and the compact walk stays sliced;
    a single-level tree is one mbr_intersect. Each result is bit-equal
    to the plain version. Returns the phase's launch counts,
    ``per_level_timing``'s rows and ``sliced_timing``'s row (both timed
    after the counts are read)."""
    import numpy as np
    import torch
    from repro_torch.core import device_tree as dt, traversal
    from repro_torch.core.rtree import RTree
    from repro_torch.data.synth_tree import synth_levels
    from repro_torch.kernels import cuda as kcuda, ops, ref
    t0 = time.time()
    rng = np.random.default_rng(0)
    mbrs, parents = synth_levels(1_500_000, 89, rng, str_pack=True)
    mb = [torch.from_numpy(m).to(dev) for m in mbrs]
    pa = [torch.from_numpy(p).to(dev) for p in parents]
    sl = dt.build_ancestor_table(pa, device=dev)
    sizes = [len(p) for p in parents]
    degen = dt.AncestorTable(
        starts=torch.zeros_like(sl.starts),
        widths=tuple(-(-n // dt.LANE) * dt.LANE for n in sizes[:-1]),
        tl=sl.tl)
    c = rng.uniform(-1, 1, (512, 2)).astype(np.float32)
    wd = rng.uniform(0, 0.004, (512, 2)).astype(np.float32)
    q = torch.from_numpy(np.concatenate([c - wd, c + wd], 1)).to(dev)
    q[0] = torch.tensor([5.0, 5.0, 6.0, 6.0], device=dev)      # empty
    print(f"# routing tree: levels {sizes}, full walks need "
          f"{ops.walk_smem('fused', 'full', sizes)} / "
          f"{ops.walk_smem('compact', 'full', sizes)} bytes of shared "
          f"memory (limit {ops.MAX_DYNAMIC_SMEM}); table windows "
          f"{sl.widths}, degenerate windows {degen.widths} "
          f"(built in {time.time()-t0:.1f}s)")
    want = ref.traverse_fused(q, mb, pa)
    wc = ref.traverse_compact(q, mb, pa, 64)
    kcuda.reset_launch_counts()
    steps = []

    def step(label, kind, table, fn, expect):
        route = ops.walk_route(kind, sizes, table.widths, table.tl)
        before = kcuda.launch_counts()
        got = fn()
        torch.cuda.synchronize()
        diff = {n: c - before[n] for n, c in kcuda.launch_counts().items()
                if c != before[n]}
        print(f"  {label}: rung {route}, launches {diff}")
        check(diff == expect, f"{label}: launches {diff}, want {expect}")
        steps.append(route)
        return got
    got = step("traverse_fused, built table", "fused", sl,
               lambda: ops.traverse_fused(q, mb, pa, slices=sl),
               {"traverse_fused_sliced": 1})
    plain = ref.traverse_fused_sliced(q, mb, pa, sl.starts, sl.widths,
                                      sl.tl)
    check(torch.equal(got, want) and torch.equal(got, plain),
          "routing: the sliced dense walk differs from plain")
    got = step("traverse_compact, built table", "compact", sl,
               lambda: ops.traverse_compact(q, mb, pa, 64, slices=sl),
               {"traverse_compact_sliced": 1})
    check(all(torch.equal(a, b) for a, b in zip(got, wc)),
          "routing: the sliced compact walk differs from plain")
    got = step("traverse_fused, degenerate table", "fused", degen,
               lambda: ops.traverse_fused(q, mb, pa, slices=degen),
               {"mbr_intersect": len(sizes)})
    check(torch.equal(got, want), "routing: the per-level walk differs")
    got = step("traverse_compact, degenerate table", "compact", degen,
               lambda: ops.traverse_compact(q, mb, pa, 64, slices=degen),
               {"traverse_compact_sliced": 1})
    check(all(torch.equal(a, b) for a, b in zip(got, wc)),
          "routing: the degenerate sliced compact walk differs")
    check(steps == ["sliced", "sliced", "per_level", "sliced"],
          f"routing: rungs {steps}")
    one = dt.flatten(RTree.str_bulk(idx.points[:64], max_entries=128),
                     device=dev)
    q1 = torch.from_numpy(idx.workload.queries[:512].copy()).to(dev)
    q1[-1] = one.levels[0].mbrs[0]
    before = kcuda.launch_counts()["mbr_intersect"]
    res = traversal.range_query_compact(one, q1, max_visited=64,
                                        max_results=512)
    cpu = traversal.range_query_compact(dt.flatten(
        RTree.str_bulk(idx.points[:64], max_entries=128), device="cpu"),
        q1.cpu(), max_visited=64, max_results=512)
    check(kcuda.launch_counts()["mbr_intersect"] == before + 1,
          "routing: the single-level tree did not launch mbr_intersect")
    check(all(torch.equal(a.cpu(), b) for a, b in zip(res, cpu)),
          "routing: the single-level range query differs from the CPU's")
    check(int(res.n_visited[-1]) == 1, "routing: the leaf's own MBR missed")
    counts = kcuda.launch_counts()
    print(f"# launches over the routing phase: "
          f"{ {n: c for n, c in counts.items() if c} } "
          f"({time.time()-t0:.1f}s)")
    return counts, per_level_timing(q, mb, pa, degen, sizes), \
        sliced_timing(q, mb, pa, sl)


def sliced_timing(q, mb, pa, sl) -> dict:
    """traverse_fused_sliced on the routing tree with its built table
    (the dense walk's rung there): bit-equal to the full walk's kernel
    (off its rung: launched directly), then timed on the device (CUPTI),
    its plain version (thousands of launches a call) once between
    events, against the [B, L] mask write's bound. Returns the row's
    numbers for the JSON line."""
    import torch
    from repro_torch.kernels import ops, ref
    B, L = q.shape[0], int(mb[-1].shape[0])
    tests, nodes = walk_work(q, mb, pa)
    b, by = bound_ms(B * 16 + nodes * 20 + sl.starts.numel() * 4 + B * L,
                     tests * 4)
    launch, vis = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
    flaunch, full = ops.prepare("traverse_fused", q, mb, pa)
    launch()
    flaunch()
    check(torch.equal(vis, full), "routing: the sliced dense walk differs "
          "from the full walk's kernel")
    del flaunch, full
    passes = kernel_means(profiled_events(launch,
                                          "traverse_fused_sliced_kernel"))
    ms = sum(passes.values()) if passes else event_ms(launch)
    plain_ms = event_ms(lambda: ref.traverse_fused_sliced(
        q, mb, pa, sl.starts, sl.widths, sl.tl), reps=1)
    print(f"  traverse_fused_sliced (routing tree, {B} x {L}): bit-equal "
          f"to the full walk's kernel; kernel "
          f"{ms:.4f} ms ({'cupti' if passes else 'cuda-events'}; "
          f"{event_ms(launch):.4f} ms between events), plain {plain_ms:.4f} "
          f"ms (one call between events), bound {b:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}


def per_level_timing(q, mb, pa, degen, sizes) -> dict:
    """The per-level step of the routing tree (the dense walk with the
    degenerate table): its device activities (CUPTI) must be one
    mbr_intersect launch a level and nothing else; timed between events
    and on the device. Then mbr_intersect alone on the two widest levels,
    plain and folded (the level above's mask through the parents).
    Returns the widest levels' rows for the JSON line."""
    from repro_torch.kernels import ops, ref

    def step():
        return ops.traverse_fused(q, mb, pa, slices=degen)
    ev = profiled_events(step)
    check(bool(ev), "routing: CUPTI recorded no activity of the per-level "
          "step")
    only = all("mbr_intersect_kernel" in n for n in kernel_means(ev))
    # CUPTI can drop a few records of a run: a step's activities are the
    # recorded ones a step, rounded up, and its time their mean times that
    acts = -(-len(ev) // TIMING_REPS)
    busy = sum(e.time_range.elapsed_us() for e in ev) / len(ev) / 1e3 * acts
    print(f"  per-level step (degenerate table): {acts} device activities "
          f"a step, all mbr_intersect: {only} ({len(ev)} recorded over "
          f"{TIMING_REPS} steps); device {busy:.4f} ms, "
          f"{event_ms(step):.4f} ms between events")
    check(only and acts == len(sizes),
          f"routing: the per-level step ran {acts} activities a step, all "
          f"mbr_intersect: {only}; want {len(sizes)} mbr_intersect launches")
    B, rows = q.shape[0], {}
    for lvl in (len(sizes) - 2, len(sizes) - 1):
        n, n_prev = sizes[lvl], sizes[lvl - 1]
        launch, _ = ops.prepare("mbr_intersect", q, mb[lvl])
        r = kernel_row("mbr_intersect", 0, launch,
                       lambda lvl=lvl: ref.mbr_intersect(q, mb[lvl]),
                       (B + n) * 16 + B * n, B * n * 4,
                       label=f" (routing level, {B} x {n})")
        parent = ref.traverse_fused(q, mb[:lvl], pa[:lvl])
        launch, _ = ops.prepare("mbr_intersect", q, mb[lvl], parent,
                                pa[lvl])
        f = kernel_row("mbr_intersect", 0, launch,
                       lambda lvl=lvl, parent=parent: ref.mbr_intersect(
                           q, mb[lvl], parent, pa[lvl]),
                       (B + n) * 16 + B * n + n * 4 + B * n_prev,
                       B * n * 4,
                       label=f" (routing level folded, {B} x {n})")
        rows[str(n)] = {side: {key: x[key] for key in
                               ("ms", "plain_ms", "bound_ms", "bound_by")}
                        for side, x in (("plain", r), ("folded", f))}
    return rows


def large_index(dev, card, points: int):
    """The 40M-point index: ``tweets_like`` (20x the paper's Tweets set),
    ``RTree.str_bulk`` at capacity 128, flattened onto the card. Its
    compact walk passes one CTA's shared memory, so the kNN and join
    streams (serve.py's defaults) must run on traverse_compact_sliced
    and never on a full walk; both oracles at 0 mismatches. Returns
    ``(launch counts by stream, rates, the traverse_compact_sliced row)``.
    """
    import torch
    from repro_torch.core import device_tree as dt
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    from repro_torch.kernels import cuda as kcuda, ops, ref
    from repro_torch.launch import serve
    t_all = time.time()
    t0 = time.time()
    pts = synth.tweets_like(points, seed=0)
    t_gen = time.time() - t0
    t0 = time.time()
    host = RTree.str_bulk(pts, max_entries=128)
    t_str = time.time() - t0
    t0 = time.time()
    tree = dt.flatten(host, device=dev)
    torch.cuda.synchronize()
    t_flat = time.time() - t0
    del host
    sizes = [lv.mbrs.shape[0] for lv in tree.levels]
    sl = tree.aslices
    routes = {k: ops.walk_route(k, sizes, sl.widths, sl.tl)
              for k in ("fused", "compact")}
    print(f"# large index: tweets_like {pts.shape[0]} points in "
          f"{t_gen:.1f}s, str_bulk (capacity 128) {t_str:.1f}s, flatten "
          f"{t_flat:.1f}s; {tree.n_leaves} leaves, levels {sizes}, table "
          f"windows {sl.widths} over {sl.n_tiles} tiles of {sl.tl}, "
          f"{tree.byte_size() / 1e6:.1f} MB on the card (+ "
          f"{sl.starts.numel() * 4 / 1e3:.1f} KB of window starts); compact "
          f"walk {ops.walk_smem('compact', 'full', sizes)} bytes full, "
          f"{ops.walk_smem('compact', 'sliced', sizes, sl.widths, sl.tl)} "
          f"sliced; rungs {routes}")
    walk = "traverse_compact_sliced"
    if points == LARGE_POINTS:
        check(ops.walk_route("compact", sizes) != "full"
              and routes["compact"] == "sliced",
              f"the large index's compact walk takes {routes['compact']}")
    elif routes["compact"] == "full":
        walk = "traverse_compact"
        print(f"# CUT: at {points} points the compact walk fits one CTA; "
              "the streams are held to the full walk instead")
    base = ["--dataset", "tweets", "--points", str(points), "--queries",
            str(QUERIES), "--batch", "512", "--sort", "hilbert", "--reps",
            "1", "--max-visited", "64", "--wide-factor", "8", "--device",
            "cuda"]
    counts, rates = {}, {}
    for qt, extra in (("knn", ["--knn-k", "8", "--knn-margin", "2.0"]),
                      ("join", ["--selectivity", "1e-6", "--join-pairs",
                                "16"])):
        args = serve.parse_args(base + extra + ["--query-type", qt])
        kcuda.reset_launch_counts()
        fn = serve.serve_knn if qt == "knn" else serve.serve_join
        out, mism, n_checked = fn(tree, pts, args)
        torch.cuda.synchronize()
        counts[qt] = kcuda.launch_counts()
        print(f"# launches over 2 {qt} streams on the large index: "
              f"{ {n: c for n, c in counts[qt].items() if c} }")
        other = ({"traverse_compact", "traverse_compact_sliced"}
                 - {walk}).pop()
        check(counts[qt][walk] > 0, f"large {qt}: {walk} never launched")
        check(counts[qt][other] == 0 and counts[qt]["traverse_fused"] == 0,
              f"large {qt}: {other} or traverse_fused was launched")
        check(mism == 0, f"large {qt} oracle: {mism} mismatches")
        if qt == "join":
            check(n_checked >= 200, f"large join: only {n_checked} of 256 "
                  "sampled outer rows not truncated")
        make = serve.knn_stream if qt == "knn" else serve.join_stream
        _, busy, by_name = profile_stream(f"{qt} (large index)",
                                          make(tree, pts, args)[-1])
        if qt == "knn":
            knn_stream_sortless("knn (large index)", busy, by_name)
        rates[qt] = ", ".join(f"{v:.0f} {k}" for k, v in out.items())
        print(f"# large {qt} on {card}: {rates[qt]}")

    # traverse_compact_sliced at the serving shapes: the kNN stream's first
    # narrow batch (k 64) and its first wide batch (the overflow rows at
    # twice the radius, k 512)
    kargs = serve.parse_args(base + ["--query-type", "knn"])
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    rows = []
    batches = knn_batches(tree, pts, kargs, dev)
    for tier, (qb, _), k in zip(("kNN batch", "kNN wide batch"), batches,
                                (64, 512)):
        launch, (kidx, kcnt) = ops.prepare("traverse_compact_sliced", qb, mb,
                                           pa, sl, k)
        launch()
        pidx, _, pcnt = ref.traverse_compact_sliced(qb, mb, pa, sl.starts,
                                                    sl.widths, sl.tl, k)
        mism = int((kidx != pidx).sum()) + int((kcnt != pcnt).sum())
        check(mism == 0, f"traverse_compact_sliced (large index, {tier}): "
              f"{mism} mismatches")
        tests, nodes = walk_work(qb, mb, pa)
        B = qb.shape[0]
        rows.append(kernel_row(
            "traverse_compact_sliced", mism, launch,
            lambda: ref.traverse_compact_sliced(qb, mb, pa, sl.starts,
                                                sl.widths, sl.tl, k),
            B * 16 + nodes * 20 + sl.starts.numel() * 4 + B * (k + 1) * 4,
            tests * 4, plain_reps=3,
            label=f" (large index, {tier}: B {B}, k {k}, "
                  f"{ops.compact_sliced_segments(B, sl.n_tiles)} segments, "
                  f"mean {float(kcnt.float().mean()):.1f} visited)"))
        # for information (ROADMAP: the open question of this index's
        # rung): the full compact walk on the same batch, bit-equal too
        flaunch, (fidx, fcnt) = ops.prepare("traverse_compact", qb, mb, pa,
                                            k, tree.wpack)
        flaunch()
        check(torch.equal(fidx, pidx) and torch.equal(fcnt, pcnt),
              f"traverse_compact (large index, {tier}) differs from the "
              "sliced walk")
        full = kernel_means(profiled_events(flaunch,
                                            "traverse_compact_kernel"))
        print(f"  traverse_compact (the full walk, off this index's rung; "
              f"large index, {tier}, k {k}): {sum(full.values()):.4f} ms "
              f"(cupti; {event_ms(flaunch):.4f} ms between events; "
              f"{ops.walk_smem('compact', 'full', sizes)} bytes of shared "
              f"memory, {ops.compact_warps(max(sizes[:-1]))} warps a CTA)")
    row, wide = rows
    row["wide"] = {key: wide[key] for key in
                   ("ms", "plain_ms", "bound_ms", "bound_by", "pass_ms")
                   if key in wide}
    # knn_browse's selecting form on the same two batches
    select = {tier: knn_select_case(tree, qb, c3, k, f"large index, {tier}")
              for tier, (qb, c3), k in zip(("narrow", "wide"), batches,
                                           (64, 512))}
    print(f"# large-index phase: {time.time()-t_all:.1f}s")
    return counts, rates, row, select


def knn_batches(tree, pts, kargs, dev):
    """The kNN stream's first narrow batch of probe boxes (centre ± r, in
    the stream's Hilbert order) and its first wide batch: the rows the
    narrow tier flags, at centre ± 2r, in the wide tier's order (padded
    to the batch as the scheduler pads it). Each as ``(boxes [batch, 4],
    c3 [batch, 3])`` on ``dev``, c3 the centres and r² as ``knn_query``
    forms them."""
    import numpy as np
    import torch
    from repro_torch.core import knn, schedule
    from repro_torch.launch import serve
    centers, r, _ = serve.knn_stream(tree, pts, kargs)
    q = np.concatenate([centers, centers], 1)
    bbox = schedule.workload_bbox(q)
    narrow, _ = knn.make_knn_steps(tree, k=kargs.knn_k, radius=r,
                                   max_visited=kargs.max_visited,
                                   wide_factor=kargs.wide_factor)
    flagged = np.flatnonzero(schedule.serve_workload(
        narrow, q, batch=kargs.batch, sort=kargs.sort, bbox=bbox,
        device=dev).stats.truncated)
    out = []
    for rows, radius in ((q, r), (q[flagged], 2.0 * r)):
        sched = schedule.make_schedule(rows, kargs.batch, kargs.sort, bbox,
                                       dev)
        c = next(schedule.iter_batches(rows, sched))[0][:, :2]
        rt = torch.tensor(radius, dtype=torch.float32, device=dev)
        ct = torch.from_numpy(np.ascontiguousarray(c)).to(dev)
        out.append((torch.from_numpy(np.concatenate(
            [c - np.float32(radius), c + np.float32(radius)], 1)).to(dev),
            torch.cat([ct, (rt * rt).expand(len(c), 1)], 1)))
    return out


def spatial_key_check(idx, dev) -> dict:
    """spatial_key through its contract (rects and frame in, keys out, one
    launch), both curves: the stream's 4096 rects in the workload's
    frame; the edge centres (the frame's corners — 1.0 clips to 32767 —
    centres outside it, exact quantization steps and the floats just
    below, ±inf) as degenerate rects (c, c, c, c) under the unit frame,
    which normalizes each to exactly c; a zero-extent frame; and
    ``bbox=None``. Bit-equal to ``ref.spatial_key(ops.spatial_key_inputs
    (...))``. A wrapper call with the workload's frame must be one device
    activity, the key kernel (CUPTI)."""
    import numpy as np
    import torch
    from repro_torch.core import schedule
    from repro_torch.kernels import ops, ref
    wq = idx.workload.queries
    q = torch.from_numpy(wq).to(dev)
    bbox = torch.from_numpy(schedule.workload_bbox(wq)).to(dev)
    steps = np.array([1, 2, 3, 1000, 32767], np.float32) / np.float32(32768)
    edge = np.asarray(
        [[0, 0], [1, 1], [0, 1], [1, 0], [-0.5, 1.5], [1.5, -0.25],
         [-1e10, 1e10], [np.inf, -np.inf]] + [[v, v] for v in steps]
        + [[np.nextafter(v, np.float32(0)), v] for v in steps], np.float32)
    e = torch.from_numpy(edge).to(dev)
    rect_e = torch.cat([e, e], 1)
    unit = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)
    check(torch.equal(ops.spatial_key_inputs(rect_e, unit), e),
          "spatial_key: a degenerate rect under the unit frame does not "
          "normalize to its centre")
    flat = torch.cat([q[0, :2], q[0, :2]])           # zero-extent frame
    for curve in ("morton", "hilbert"):
        mism = 0
        for rects, frame in ((q, bbox), (rect_e, unit), (q, flat), (q, None)):
            launch, keys = ops.prepare("spatial_key", rects, frame, curve)
            launch()
            mism += int((keys != ref.spatial_key(
                ops.spatial_key_inputs(rects, frame), curve=curve)).sum())
            if rects is rect_e:
                check(int(keys[1]) == int(keys[12]),
                      f"spatial_key ({curve}): 1.0 does not clip to 32767")
        check(mism == 0, f"spatial_key ({curve}): {mism} mismatches")
    ev = profiled_events(lambda: ops.spatial_key(q, bbox, "hilbert"))
    acts = -(-len(ev) // TIMING_REPS)
    names = sorted(kernel_means(ev))
    print(f"  spatial_key: both curves bit-equal on {len(wq)} rects, "
          f"{len(edge)} edge centres as degenerate rects, a zero-extent "
          f"frame and bbox=None; ops.spatial_key with the workload's frame: "
          f"{acts} device activity a call ({names})")
    check(acts == 1 and all("spatial_key_kernel" in n for n in names),
          f"spatial_key: a call with a frame ran {acts} device activities "
          f"({names}), want the key kernel alone")
    launch, _ = ops.prepare("spatial_key", q, bbox, "hilbert")
    n = q.shape[0]
    return kernel_row("spatial_key", 0, launch,
                      lambda: ref.spatial_key(
                          ops.spatial_key_inputs(q, bbox), curve="hilbert"),
                      n * 16 + 16 + n * 4, n * (8 + 15 * 16))


def walk_work(q, mb, pa) -> tuple[int, int]:
    """What a root-to-leaf walk of this batch must do: ``(tests, nodes)``,
    the (query, node) MBR tests — every node of the top level, and below
    it the children of the query's visited nodes — and the distinct
    nodes any query tests, each of which is read once."""
    import torch
    from repro_torch.kernels import ref
    tests = nodes = 0
    vis = None
    for m, p in zip(mb, pa):
        hit = ref.mbr_intersect(q, m)
        live = torch.ones_like(hit) if vis is None else vis[:, p.long()]
        tests += int(live.sum())
        nodes += int(live.any(0).sum())
        vis = live & hit
    return tests, nodes


def traverse_compact_check(idx, q, dev) -> dict:
    """traverse_compact at k = 64 (narrow) and 512 (wide) on one batch
    whose last rows visit 0, exactly k and k + 1 leaves, and on a
    single-level tree; bit-equal to ``compact_mask_counted`` of the
    walk."""
    import torch
    from repro_torch.core import device_tree as dt
    from repro_torch.core.rtree import RTree
    from repro_torch.data import synth
    from repro_torch.kernels import ops, ref
    tree = idx.dtree
    mb = [lv.mbrs for lv in tree.levels]
    pa = [lv.parent for lv in tree.levels]
    ks = [k for k in (64, 512) if k + 1 < tree.n_leaves]
    if ks != [64, 512]:
        print(f"# CUT: traverse_compact strip rows at k in {ks} only "
              f"({tree.n_leaves} leaves)")
    for k in ks:
        qk = q.clone()
        qk[-3:] = torch.from_numpy(synth.strip_queries(
            mb[-1].cpu().numpy(), [0, k, k + 1])).to(dev)
        launch, (kidx, kcnt) = ops.prepare("traverse_compact", qk, mb, pa, k)
        launch()
        pidx, _, pcnt = ref.traverse_compact(qk, mb, pa, k)
        mism = int((kidx != pidx).sum()) + int((kcnt != pcnt).sum())
        check(mism == 0, f"traverse_compact (k={k}): {mism} mismatches")
        check(kcnt[-3:].tolist() == [0, k, k + 1],
              f"traverse_compact: strip rows visit {kcnt[-3:].tolist()}")
    one = dt.flatten(RTree.str_bulk(idx.points[:64], max_entries=128),
                     device=dev)
    check(one.height == 1, "str_bulk of 64 points is not a single leaf")
    m1 = [lv.mbrs for lv in one.levels]
    p1 = [lv.parent for lv in one.levels]
    q1 = q.clone()
    q1[-2] = m1[0][0]                                # the leaf's own MBR
    p0 = one.leaf_entries[0, 0]
    q1[-1] = torch.cat([p0, p0])                     # one of its points
    launch, (kidx, kcnt) = ops.prepare("traverse_compact", q1, m1, p1, 64)
    launch()
    pidx, _, pcnt = ref.traverse_compact(q1, m1, p1, 64)
    check(torch.equal(kidx, pidx) and torch.equal(kcnt, pcnt),
          "traverse_compact: single-level tree differs")
    check(kcnt[-2:].tolist() == [1, 1],
          "traverse_compact: single-level tree missed its leaf")
    print(f"  traverse_compact: bit-equal at k in {ks} (strip rows "
          f"visit 0, k, k + 1) and on a single-level tree "
          f"({int(kcnt.sum())} of {q.shape[0]} rows hit its leaf)")
    # timed on the batch at the narrow k 64 and at the wide k 512 (the
    # join's wide tier re-serves these rows at k 512)
    tests, nodes = walk_work(q, mb, pa)
    B = q.shape[0]
    tiers = []
    for k in (64, 512):
        launch, _ = ops.prepare("traverse_compact", q, mb, pa, k, tree.wpack)
        tiers.append(kernel_row(
            "traverse_compact", 0, launch,
            lambda k=k: ref.traverse_compact(q, mb, pa, k),
            B * 16 + nodes * 20 + B * (k + 1) * 4, tests * 4,
            label=f" (k {k})"))
    row, wide = tiers
    row["wide"] = {key: wide[key] for key in
                   ("ms", "plain_ms", "bound_ms", "bound_by")}
    return row


def knn_browse_check(idx, args, base_argv, dev) -> dict:
    """knn_browse in both forms on probe boxes at the default radius (k =
    8, slots from traverse_compact), with invalid slots, an all-invalid
    row and an entry exactly at d2 == r2; the deployment's leaves hold
    fewer than 128 entries (+inf padding). Bit-equal. Then the selecting
    form on the kNN stream's first narrow and wide batches, bit-equal and
    timed (the row: narrow, ``wide``, and the d2 form's time)."""
    import numpy as np
    import torch
    from repro_torch.core import knn
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    tree = idx.dtree
    rng = np.random.default_rng(0)
    pts = idx.points
    c = torch.from_numpy(pts[rng.integers(0, len(pts), args.batch)]
                         .astype(np.float32)).to(dev)
    r = torch.tensor(knn.default_radius(tree, 8), device=dev)
    li, valid, _ = ref.traverse_compact(
        torch.cat([c - r, c + r], 1), [lv.mbrs for lv in tree.levels],
        [lv.parent for lv in tree.levels], args.max_visited)
    c3 = torch.cat([c, (r * r).expand(len(c), 1)], 1)
    li, valid = li.clone(), valid.clone()
    valid[3, :4] = False                                   # padded slots
    valid[4] = False                                       # empty row
    leaf = int(li[1, 0])
    e = tree.leaf_entries[leaf, 0]
    dx, dy = e[0] - c3[1, 0], e[1] - c3[1, 1]
    c3[1, 2] = dx * dx + dy * dy                           # d2 == r2
    valid[1, 0] = True
    n_pad = int((tree.leaf_counts < tree.leaf_entries.shape[1]).sum())
    check(n_pad > 0, "no leaf with +inf padding")
    launch, d2 = ops.prepare("knn_browse", c3, tree.leaf_entries, li, valid)
    launch()
    ex, ey = tree.leaf_entries[..., 0], tree.leaf_entries[..., 1]
    want = ref.knn_browse(c3, ex, ey, li, valid)
    mism = int((d2 != want).sum())   # +inf == +inf
    check(mism == 0, f"knn_browse: {mism} mismatches (bit-exact)")
    check(float(d2[1, 0, 0]) == float(c3[1, 2]),
          "knn_browse: the entry at d2 == r2 was dropped")
    check(bool(torch.isinf(d2[4]).all()), "knn_browse: empty row hit")
    # the selecting form on the same edge rows: its n_within is the d2
    # form's finite count, and row 4 selects nothing
    _, (d2k, _, nw) = knn_select_case(tree, None, c3, args.max_visited,
                                      "edge rows", slots=(li, valid))
    check(torch.equal(nw, torch.isfinite(d2).sum((1, 2)).to(torch.int32)),
          "knn_browse: the selecting form's counts differ from the d2 "
          "form's")
    check(int(nw[4]) == 0 and bool(torch.isinf(d2k[4]).all()),
          "knn_browse (selecting form): empty row hit")
    print(f"  knn_browse: bit-equal in both forms, the d2 == r2 entry "
          f"kept, {int(torch.isfinite(d2).sum())} in-radius entries, "
          f"{n_pad} of {tree.n_leaves} leaves padded")
    B, K = li.shape
    M = tree.leaf_entries.shape[1]
    n_valid = int(valid.sum())
    n_leaves = int(torch.unique(li[valid]).numel())
    d2_row = kernel_row("knn_browse", 0, launch,
                        lambda: ref.knn_browse(c3, ex, ey, li, valid),
                        B * 12 + B * K * 5 + n_leaves * M * 8
                        + B * K * M * 4, n_valid * M * 6,
                        label=" (the d2 form, [B, K, M] out)")
    # timed: the selecting form on the kNN stream's first narrow and wide
    # batches (the row), the d2 form beside it
    kargs = serve.parse_args(base_argv + ["--query-type", "knn"])
    tiers = [knn_select_case(tree, qb, c3b, k, tier)[0] for tier, (qb, c3b), k
             in zip(("narrow batch", "wide batch"),
                    knn_batches(tree, idx.points, kargs, dev),
                    (args.max_visited, args.max_visited * args.wide_factor))]
    row, wide = tiers
    row["wide"] = {key: wide[key] for key in
                   ("ms", "plain_ms", "bound_ms", "bound_by")}
    row["d2_form"] = {key: d2_row[key] for key in
                      ("ms", "plain_ms", "bound_ms", "bound_by")}
    return row


def knn_select_case(tree, qb, c3, K, label, k=8, slots=None):
    """knn_browse's selecting form (``ops.knn_browse_topk``, k 8) on one
    batch: the slot table of the probe boxes ``qb`` at K slots (the walk
    ``knn_query`` runs), or ``slots`` given, against the plain version,
    bit-equal on distances, ids and counts; then timed. Returns the
    kernel row and the outputs."""
    import torch
    from repro_torch.core import traversal
    from repro_torch.kernels import ops, ref
    if slots is None:
        cv = traversal.visited_leaves_compact(tree, qb, K)
        slots = (cv.leaf_idx, cv.valid)
    li, valid = slots
    ent, eids = tree.leaf_entries, tree.leaf_entry_ids
    ex, ey = ent[..., 0], ent[..., 1]
    safe = torch.clamp(li, 0, tree.n_leaves - 1)
    launch, got = ops.prepare("knn_browse_topk", c3, ent, eids, li, valid, k)
    launch()

    def plain():
        return ref.knn_browse_topk(c3, ex, ey, eids, safe, valid, k)
    want = plain()
    mism = int((got[0].view(torch.int32) != want[0].view(torch.int32))
               .sum()) + int((got[1] != want[1]).sum()) \
        + int((got[2] != want[2]).sum())
    check(mism == 0, f"knn_browse_topk ({label}): {mism} mismatches "
          "(bit-exact)")
    B, Kt = li.shape
    M = ent.shape[1]
    n_valid = int(valid.sum())
    n_leaves = int(torch.unique(safe[valid]).numel())
    row = kernel_row(
        "knn_browse", mism, launch, plain,
        B * 12 + B * Kt * 5 + n_leaves * M * 8 + B * (2 * k + 1) * 4,
        n_valid * M * 6,
        label=f" (selecting form, {label}: B {B}, K {Kt}, k {k}, "
              f"{n_valid / B:.1f} valid slots a row, {n_leaves} leaves, "
              f"mean {float(got[2].float().mean()):.1f} in radius)")
    return row, got


def make_inserts():
    """The mixed stream's inserts: ``INSERTS`` new records of the same
    synthetic city (the generator draws its hot blocks before anything
    that depends on n), shuffled so they arrive in no spatial order."""
    import numpy as np
    from repro_torch.data import synth
    ins = synth.crimes_like(INSERTS, seed=1)
    return ins[np.random.default_rng(0).permutation(ins.shape[0])]


def delta_probe_case(q, buf, k, dev, edge: bool) -> list:
    """One delta_probe check: kernel against plain version, bit-equal on
    slot table, validity and count. With ``edge`` the first k + 1 buffer
    points move onto the line y = 0 at x = 100 + i/1024 (exact in f32,
    outside the city) and rows 1-3 get rects whose edges pass through
    them (k, k + 1 and, from a corner, k - 1 hits). Returns the counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    q, buf = q.copy(), buf.copy()
    q[0] = [1e9, 1e9, 1e9 + 1, 1e9 + 1]                     # empty row
    if edge:
        step = np.float32(1 / 1024)
        buf[:k + 1, 0] = 100 + np.arange(k + 1, dtype=np.float32) * step
        buf[:k + 1, 1] = 0
        q[1] = [100, 0, 100 + (k - 1) * step, 0]
        q[2] = [100, 0, 100 + k * step, 0]
        q[3] = [100 + 2 * step, 0, 101, 1]
    qt, bt = torch.from_numpy(q).to(dev), torch.from_numpy(buf).to(dev)
    launch, (kidx, kcnt) = ops.prepare("delta_probe", qt, bt, k)
    launch()
    pidx, pvalid, pcnt = ref.delta_probe(qt, bt, k)
    kvalid = torch.arange(k, device=dev)[None, :] < kcnt[:, None]
    mism = int((kidx != pidx).sum() + (kcnt != pcnt).sum()
               + (kvalid != pvalid).sum())
    check(mism == 0, f"delta_probe (cap {len(buf)}, k {k}): {mism} "
          "mismatches")
    counts = kcnt.tolist()
    check(counts[0] == 0, "delta_probe: the empty row hit")
    if edge:
        check(counts[1:4] == [k, k + 1, k - 1],
              f"delta_probe edge rows count {counts[1:4]}")
    return counts


def delta_probe_check(idx, args, dev, inserts) -> dict:
    """delta_probe on one narrow batch of the range workload against the
    mixed stream's buffer (cap 8192) filled to 0, 1,170, 6,144 and 8,192
    inserts, at k 64 (narrow) and 512 (wide), with edge rows; then a cap
    that is not a multiple of the block and a one-point store. Bit-equal.
    Timed at fill 6,144, k 64."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    B, cap = args.batch, DELTA_CAP
    q = idx.workload.queries[:B].astype(np.float32)
    for fill in (0, 1170, 6144, 8192):
        buf = np.full((cap, 2), np.inf, np.float32)
        buf[:fill] = inserts[:fill]
        for k in (64, 512):
            delta_probe_case(q, buf, k, dev, edge=fill > k)
    odd = np.full((777, 2), np.inf, np.float32)
    odd[:600] = inserts[:600]
    delta_probe_case(q[:37], odd, 8, dev, edge=True)
    one = inserts[:1].astype(np.float32)
    got = delta_probe_case(np.concatenate([q[:4], [np.r_[one[0], one[0]]]])
                           .astype(np.float32), one, 4, dev, edge=False)
    check(got[-1] == 1, "delta_probe: a one-point store missed its point")
    print(f"  delta_probe: bit-equal at cap {cap} (fills 0, 1170, 6144, "
          f"8192; k 64 and 512; edge rows with k, k + 1 and k - 1 hits), "
          f"at cap 777 and on a one-point store")
    fill, k = 6144, 64
    buf = np.full((cap, 2), np.inf, np.float32)
    buf[:fill] = inserts[:fill]
    qt, bt = torch.from_numpy(q).to(dev), torch.from_numpy(buf).to(dev)
    launch, _ = ops.prepare("delta_probe", qt, bt, k)
    return kernel_row("delta_probe", 0, launch,
                      lambda: ref.delta_probe(qt, bt, k),
                      B * 16 + cap * 8 + B * (k + 1) * 4, B * fill * 4)


def mlp_edge_rows(bank, L: int, k: int, dev) -> None:
    """The fused prediction kernel on the edge rows, with a bank of the
    deployed bank's F, H and Cl whose cells are pinned by their biases
    (w = 0): cells 0..2 predict three runs of leaves 0..k-1, cell 3 leaf
    k, cell 4 nothing. Rows: 0, exactly k, k + 1, duplicates across
    cells, all-padded and partly padded slots."""
    import torch
    from repro_torch.core.classifiers.mlp import MLPBank
    from repro_torch.kernels import ops, ref
    _, F, H = bank.w1.shape
    run = -(-k // 3)
    Cl = max(bank.w2.shape[-1], run)
    C = 5
    check(L >= k + 1, "too few leaves for the edge rows")
    b2 = torch.full((C, Cl), -9.0, device=dev)
    lm = torch.full((C, Cl), -1, dtype=torch.int32, device=dev)
    lmk = torch.zeros((C, Cl), dtype=torch.bool, device=dev)
    sizes = []
    for c in range(3):
        ids = torch.arange(c * run, min((c + 1) * run, k), device=dev,
                           dtype=torch.int32)
        n = ids.numel()
        lm[c, :n], b2[c, :n], lmk[c, :n] = ids, 9.0, True
        sizes.append(n)
    lm[3, 0], b2[3, 0], lmk[3, 0] = k, 9.0, True
    lmk[4] = True
    lm[4] = 0                                      # masked by b2 = -9
    eb = MLPBank(w1=torch.zeros((C, F, H), device=dev),
                 b1=torch.zeros((C, H), device=dev),
                 w2=torch.zeros((C, H, Cl), device=dev), b2=b2,
                 mu=bank.mu, sd=bank.sd, label_map=lm, lmask=lmk)
    T = True
    edge = [([4, 4, 4, 4], [T] * 4, 0),                       # nothing
            ([0, 1, 2, 4], [T] * 4, k),                       # exactly k
            ([0, 1, 2, 3], [T] * 4, k + 1),                   # k + 1
            ([0, 0, 1, 1], [T] * 4, sizes[0] + sizes[1]),     # duplicates
            ([0, 1, 2, 3], [False] * 4, 0),                   # padded
            ([0, 1, 2, 3], [T, False, T, False], sizes[0] + sizes[2])]
    cid = torch.tensor([e[0] for e in edge], dtype=torch.int32, device=dev)
    ok = torch.tensor([e[1] for e in edge], device=dev)
    x = torch.zeros((len(edge), F), device=dev)
    launch, (kidx, kcnt) = ops.prepare("mlp_predict_compact", x, cid, ok,
                                       eb, L, k, 0.5)
    launch()
    pidx, _, pcnt = ref.mlp_predict_compact(
        x, cid, ok, eb.w1, eb.b1, eb.w2, eb.b2, eb.label_map, eb.lmask,
        n_leaves=L, k=k, threshold=0.5)
    for r, (_, _, want) in enumerate(edge):
        check(int(kcnt[r]) == want == int(pcnt[r]),
              f"mlp edge row {r}: count {int(kcnt[r])}, want {want}")
        check(bool(torch.equal(kidx[r], pidx[r])), f"mlp edge row {r} ids")
    print(f"  mlp_predict_compact edge rows: counts "
          f"{[int(c) for c in kcnt]} (k={k}) equal the plain version's")


def brute_force_check(idx, report, dev, n_sample: int, max_results: int):
    """Phase 5b: sampled queries against f32 brute-force containment of
    every point: n_results exactly, and the id set where it fits."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    rng = np.random.default_rng(0)
    Q = idx.workload.n_queries
    sample = rng.choice(Q, min(n_sample, Q), replace=False)
    st = report.stats
    mism_n = mism_ids = 0
    for o, inside in serve._inside_chunks(
            idx.points, idx.workload.queries[sample], dev, chunk=64):
        s = sample[o:o + 64]
        n = inside.sum(1).cpu().numpy()
        mism_n += int((n != st.n_results[s]).sum())
        for j, qi in enumerate(s):
            if n[j] <= max_results:
                want = set(torch.nonzero(inside[j]).flatten().tolist())
                got = st.result_ids[qi]
                mism_ids += int(set(got[got >= 0].tolist()) != want)
    print(f"# brute force: {mism_n} / {sample.size} sampled n_results and "
          f"{mism_ids} id-set mismatches vs f32 containment of all "
          f"{idx.points.shape[0]} points")
    check(mism_n == 0 and mism_ids == 0, "brute-force containment mismatch")


def schedule_cost(queries, batch: int, dev) -> None:
    """Host-clock cost of batch formation alone (``make_schedule``:
    curve keys on the card, copy back, stable argsort) per stream,
    median of 20, for each sort mode."""
    import torch
    from repro_torch.core import schedule
    ms = {}
    for sort in ("hilbert", "morton", "none"):
        times = []
        for _ in range(22):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            schedule.make_schedule(queries, batch, sort, device=dev)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[sort] = statistics.median(times[2:])
    print("# batch formation per stream (host clock, median of 20): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))


def profile_stream(label: str, run, batches: int | None = None):
    """One more full stream (``run()``) under ``torch.profiler`` (device
    activity only): wall time, device busy share, the device activities
    (and their number a batch, given the stream's ``batches``) and the
    device time by kernel, the port's CUDA kernels' share among it.
    Returns ``(run()'s result, busy ms, {kernel name: ms})``, busy None
    without device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import cuda as kcuda
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in cuda_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    if not by_name:
        print(f"# profile of one {label} stream: the profiler recorded no "
              "device activity (device busy share not measured)")
        return out, None, by_name
    busy = sum(by_name.values())
    ours = sum(v for n, v in by_name.items()
               if any(f"{k}_kernel" in n for k in kcuda.KERNELS))
    n_act = len(cuda_events(prof))
    per = f" ({n_act / batches:.1f} a batch over {batches} batches)" \
        if batches else ""
    print(f"# profile of one {label} stream (CUPTI): wall {wall:.2f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%, idle "
          f"{100 - 100 * busy / wall:.1f}%), the port's CUDA kernels "
          f"{ours:.3f} ms ({100 * ours / max(busy, 1e-9):.1f}% of busy), "
          f"{n_act} device activities{per}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {name[:100]}")
    return out, busy, by_name


def knn_stream_sortless(label: str, busy, by_name: dict) -> None:
    """A kNN stream's profile holds no sort (the k smallest are picked in
    knn_browse's selecting form); its busy time beside the parent's."""
    check(busy is not None, f"{label}: the profiler recorded no device "
          "activity")
    sorts = [n for n in by_name if "sort" in n.lower()]
    check(not sorts, f"{label} stream sorted on the card: {sorts[:3]}")
    print(f"# {label} stream: no sort on the card; device busy {busy:.3f} "
          f"ms against {KNN_BUSY_BEFORE[label]} ms before the selecting "
          "form (PERF.md section 5)")


def mixed_stream(idx, base_argv, inserts, dev):
    """Phase 7: the mixed read/write stream through ``serve.serve_mixed``
    with the maintenance policy, its gates, the wall split and the
    profile of one serve pass at fill 6,144. Returns ``(launch counts,
    rate)``."""
    import numpy as np
    import torch
    from repro_torch.core import delta, schedule
    from repro_torch.core.hybrid import hybrid_query
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    margs = serve.parse_args(base_argv + [
        "--sort", "hilbert", "--reps", "1", "--insert-every", "1",
        "--delta-cap", str(DELTA_CAP), "--policy", "default",
        "--refit-chunk", "4", "--repack-at", "0.75"])
    server = serve.make_fresh_server(idx, margs)
    calls = {"serve": 0, "serve_wide": 0}
    secs = {"repack": 0.0, "refit_cells": 0.0}

    def counted(name):
        fn = getattr(server, name)

        def call(q):
            calls[name] += 1
            return fn(q)
        setattr(server, name, call)

    def clocked(name):
        fn = getattr(server, name)

        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            return out
        setattr(server, name, call)
    for name in calls:
        counted(name)
    for name in secs:
        clocked(name)

    kcuda.reset_launch_counts()
    mixed, server, dt_s, mism = serve.serve_mixed(idx, inserts, margs,
                                                  server=server)
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    print(f"# launches over the mixed stream ({calls['serve']} narrow + "
          f"{calls['serve_wide']} wide batches): {counts}")
    n_probe = calls["serve"] + calls["serve_wide"]
    check(counts["delta_probe"] == n_probe,
          f"delta_probe launched {counts['delta_probe']} times for "
          f"{n_probe} served batches")
    check(calls["serve"] == mixed.n_batches, "narrow batch count differs")
    for name in ("spatial_key", "traverse_fused", "leaf_refine",
                 "mlp_predict_compact", "forest_infer"):
        check(counts[name] > 0, f"{name} never launched on the mixed stream")
    n_repacks = mixed.n_repacks + sum(d.repack for _, d in mixed.maintenance)
    n_refit = sum(r.cells_refit for r in server.refits)
    hits = int(mixed.stats.delta_hits.sum())
    check(mixed.n_inserts == INSERTS, f"{mixed.n_inserts} inserts staged")
    check(n_repacks >= 1, "the mixed stream never repacked")
    check(n_refit > 0, "the mixed stream refit no cell")
    check(hits > 0, "no query hit the delta buffer")
    check(mism == 0, f"mixed oracle: {mism} n_results mismatches")
    trunc = mixed.stats.truncated.astype(bool)
    rows = np.random.default_rng(0).choice(np.flatnonzero(~trunc),
                                           min(512, int((~trunc).sum())),
                                           replace=False)
    _, id_mism, n_rows = serve.mixed_oracle(
        mixed, idx.points, idx.workload.queries, dev, id_rows=rows)
    print(f"# mixed oracle: {mism} / {mixed.n_queries} n_results and "
          f"{id_mism} / {n_rows} sampled id-set mismatches vs f32 "
          f"brute force over each segment's visible points; {n_repacks} "
          f"repacks, {n_refit} cells refit in {len(server.refits)} "
          f"refit_cells calls, {hits} delta hits")
    check(id_mism == 0, f"mixed oracle: {id_mism} id-set mismatches")
    check(n_rows >= 500, f"only {n_rows} rows compared by id set")
    serving = dt_s - secs["repack"] - secs["refit_cells"]
    print(f"# mixed wall {dt_s:.3f} s: serving {serving:.3f} s, repack "
          f"{secs['repack']:.3f} s (incl. the span diff), refit chunks "
          f"{secs['refit_cells']:.3f} s; {mixed.n_queries / dt_s:.0f} "
          f"queries/s end to end, {mixed.n_queries / serving:.0f} "
          f"queries/s serving alone")

    # one FreshServer.serve pass over the stream at fill 6,144
    nargs = serve.parse_args(base_argv + ["--delta-cap", str(DELTA_CAP)])
    pserver = serve.make_fresh_server(idx, nargs)
    pserver.insert(inserts[:6144])
    q = idx.workload.queries
    bbox = schedule.workload_bbox(q)

    def run():
        return schedule.serve_workload(
            pserver.serve, q, batch=margs.batch, sort="hilbert", bbox=bbox,
            wide_fn=pserver.serve_wide, device=dev)
    run()
    rep, busy, by_name = profile_stream("FreshServer.serve (fill 6144)",
                                        run)
    if busy:
        probe = sum(v for n, v in by_name.items() if "delta_probe" in n)
        ms = {}
        for tier, widen in (("narrow", 1), ("wide", margs.wide_factor)):
            qb = torch.from_numpy(q[:margs.batch]).to(dev)
            res = hybrid_query(pserver.hybrid, qb,
                               max_visited=margs.max_visited * widen,
                               max_results=512 * widen)
            hit = delta.probe(pserver.delta.xy, qb, k=64 * widen,
                              base=pserver.delta.base)
            ms[tier] = device_ms(
                lambda: delta.merge_hybrid_result(res, hit))[0]
        merge = rep.n_batches * ms["narrow"] + rep.wide_batches * ms["wide"]
        print(f"# fill 6144: delta_probe {probe:.3f} ms "
              f"({100 * probe / busy:.1f}% of busy), merge "
              f"{ms['narrow']:.4f} ms per narrow and {ms['wide']:.4f} ms "
              f"per wide batch, {merge:.3f} ms over the pass "
              f"({100 * merge / busy:.1f}% of busy; {rep.n_batches} narrow "
              f"+ {rep.wide_batches} wide batches)")
    return counts, f"{mixed.n_queries / dt_s:.0f} queries/s", mixed


# the engine's launches a batch (``engine_phase``): the compact walk, the
# R and AI refines, the MLP bank's prediction and the router
ENGINE_LAUNCHES = {"traverse_compact": 1, "leaf_refine": 2,
                   "mlp_predict_compact": 1, "forest_infer": 1}


def engine_launch_check(label: str, counts: dict, batches: int,
                        need: dict) -> str:
    """Gate a stream's launch counts at ``need`` a batch (``batches``
    batches, narrow and wide) and no dense walk; returns the per-batch
    text."""
    for name, per in need.items():
        check(counts[name] == per * batches,
              f"{label}: {name} launched {counts[name]} times over "
              f"{batches} batches ({per} a batch expected)")
    check(counts["traverse_fused"] == 0,
          f"{label}: the engine built a dense [B, L] visited mask")
    return ", ".join(f"{n} {c / batches:g}" for n, c in counts.items() if c)


def engine_phase(idx, base_argv, inserts, dev, range_report, mixed_report):
    """Phase 7b: the serving engine at one rank (``core.engine``) on the
    deployment with ``src/repro/launch/serve.py --distributed``'s settings
    (``EngineConfig(max_visited=64)``: max_pred 16, max_cells 4, topk
    union, guard on, delta slots 64; wide x8). The range stream through
    ``make_two_tier_steps`` + ``serve_workload`` (Hilbert, batch 512) and
    the point stream through ``make_point_serve_step``, each with ``n_results``
    equal row for row to the hybrid stream's and no ``r_truncated`` left;
    the mixed stream through ``EngineFreshServer`` with ``mixed_stream``'s
    inserts, policy and fit state, ``n_results`` equal to
    ``FreshServer``'s. Returns ``(launch counts by path, rates,
    n_results by stream)``."""
    import numpy as np
    import torch
    from repro_torch.core import engine, monitor, schedule
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    args = serve.parse_args(base_argv + ["--sort", "hilbert", "--reps", "3"])
    cfg = engine.EngineConfig(max_visited=args.max_visited)
    h = engine.pad_tree_for_sharding(idx.hybrid, 1)
    narrow, wide = engine.make_two_tier_steps(
        cfg, kind="mlp", wide_factor=args.wide_factor)
    point = engine.make_point_serve_step(cfg, kind="mlp")
    n_steps = [0]

    def on_tree(step):
        def fn(qb):
            n_steps[0] += 1
            return step(h, qb)
        return fn
    counts, rates = {}, {}

    def stream(label, fn, q, wide_fn=None):
        """Serve ``q`` through ``fn`` (and the wide tier): a warm-up and
        ``args.reps`` timed streams (``serve.timed``) with launch counts
        reset just before and read just after; then one profiled
        stream."""
        bbox = schedule.workload_bbox(q)

        def run():
            return schedule.serve_workload(
                fn, q, batch=args.batch, sort="hilbert", bbox=bbox,
                wide_fn=wide_fn, trunc_field="r_truncated", device=dev)
        kcuda.reset_launch_counts()
        n_steps[0] = 0
        rep, dt_s = serve.timed(run, args.reps)
        torch.cuda.synchronize()
        counts[label] = kcuda.launch_counts()
        per = engine_launch_check(label, counts[label], n_steps[0],
                                  ENGINE_LAUNCHES)
        check(not rep.stats.r_truncated.any(),
              f"{label}: {int(rep.stats.r_truncated.sum())} rows still "
              "r_truncated")
        rates[label] = f"{rep.n_queries / dt_s:.0f} queries/s"
        print(f"# {label}: {rep.n_queries} queries in {rep.n_batches} "
              f"batches + {rep.wide_batches} wide ({rep.n_reserved} rows "
              f"re-served), {rates[label]}, "
              f"{100 * float(rep.stats.used_ai.mean()):.1f}% AI path, "
              f"{float(rep.stats.leaf_accesses.mean()):.2f} leaf "
              f"accesses/query; launches a batch: {per}")
        profile_stream(label, run, rep.n_batches + rep.wide_batches)
        return rep

    rep = stream("engine range", on_tree(narrow), idx.workload.queries,
                 on_tree(wide))
    results = {"range": rep.stats.n_results}
    mism = int((rep.stats.n_results != range_report.stats.n_results).sum())
    print(f"# engine range: {mism} / {rep.n_queries} n_results mismatches "
          "vs the hybrid range stream")
    check(mism == 0, f"engine range: {mism} n_results mismatches")

    pargs = serve.parse_args(base_argv + ["--query-type", "point"])
    q_pt, hybrid_point = serve.point_stream(idx.hybrid, idx.points, pargs)
    want = hybrid_point().stats.n_results
    rep = stream("engine point", on_tree(point), q_pt)
    results["point"] = rep.stats.n_results
    mism = int((rep.stats.n_results != want).sum())
    print(f"# engine point: {mism} / {rep.n_queries} n_results mismatches "
          "vs the hybrid point stream")
    check(mism == 0, f"engine point: {mism} n_results mismatches")

    margs = serve.parse_args(base_argv + [
        "--sort", "hilbert", "--insert-every", "1", "--delta-cap",
        str(DELTA_CAP), "--policy", "default", "--refit-chunk", "4",
        "--repack-at", "0.75"])
    server = monitor.EngineFreshServer(
        idx.points, idx.hybrid, cfg, kind="mlp", delta_cap=margs.delta_cap,
        wide_factor=margs.wide_factor, fit_state=idx.report.fit_state,
        policy=monitor.DefaultPolicy(refit_chunk=margs.refit_chunk,
                                     repack_at=margs.repack_at))
    # the serve calls' own launches (repacks and refit chunks launch the
    # labelling walk too)
    calls, served = [0], dict.fromkeys(kcuda.KERNELS, 0)
    for name in ("serve", "serve_wide"):
        def call(q, fn=getattr(server, name)):
            calls[0] += 1
            before = kcuda.launch_counts()
            out = fn(q)
            for n, c in kcuda.launch_counts().items():
                served[n] += c - before[n]
            return out
        setattr(server, name, call)
    kcuda.reset_launch_counts()
    t0 = time.time()
    mixed = schedule.serve_mixed_workload(
        server, idx.workload.queries, inserts, batch=margs.batch,
        sort="hilbert", bbox=schedule.workload_bbox(idx.workload.queries),
        insert_every=margs.insert_every, repack_every=margs.repack_every)
    torch.cuda.synchronize()
    dt_s = time.time() - t0
    counts["engine mixed"] = kcuda.launch_counts()
    per = engine_launch_check("engine mixed", served, calls[0],
                              dict(ENGINE_LAUNCHES, delta_probe=1))
    mism = int((mixed.stats.n_results
                != mixed_report.stats.n_results).sum())
    n_repacks = sum(d.repack for _, d in mixed.maintenance)
    n_refit = sum(r.cells_refit for r in server.refits)
    rates["engine mixed"] = f"{mixed.n_queries / dt_s:.0f} queries/s"
    print(f"# engine mixed: {mixed.n_queries} queries / {mixed.n_inserts} "
          f"inserts in {mixed.n_segments} segments ({calls[0]} steps), "
          f"{n_repacks} repacks, {n_refit} cells refit, "
          f"{int(mixed.stats.delta_hits.sum())} delta hits, "
          f"{rates['engine mixed']} end to end; {mism} / {mixed.n_queries} "
          f"n_results mismatches vs FreshServer; launches a batch: {per}")
    check(mixed.n_inserts == INSERTS, f"{mixed.n_inserts} inserts staged")
    check(n_repacks >= 1 and n_refit > 0,
          "the engine's mixed stream never repacked or refit")
    check(not mixed.stats.r_truncated.any(), "engine mixed: rows still "
          "r_truncated")
    check(mism == 0, f"engine mixed: {mism} n_results mismatches")
    results["mixed"] = mixed.stats.n_results
    return counts, rates, results


# phase 7c: the engine over a mesh of ranks sharing the card
MESH_SHAPE = (1, 2)              # repro.launch.serve's mesh at 2 devices
MESH_REPS = 1                    # timed streams a rank (engine_phase: 3)
MESH_TIMEOUT_S = 600             # the ranks' join
COLLECTIVE_REPS = 50             # timed collectives of each kind a rank


def hybrid_digest(h) -> str:
    """SHA-1 of the hybrid's tree (levels, leaf arrays), bank and
    ``cell_ok``: what every rank of a mesh must hold alike."""
    import hashlib
    import torch
    t, ait = h.tree, h.ait
    parts = [x for lv in t.levels for x in (lv.mbrs, lv.parent)] + [
        t.leaf_entries, t.leaf_entry_ids, t.leaf_counts, ait.cell_ok] + [
        getattr(ait.bank, f.name) for f in dataclasses.fields(ait.bank)
        if torch.is_tensor(getattr(ait.bank, f.name))]
    d = hashlib.sha1()
    for x in parts:
        d.update(x.detach().contiguous().cpu().numpy().tobytes())
    return d.hexdigest()


def engine_mesh_rank(workdir: Path) -> int:
    """One rank of phase 7c, started by ``engine_mesh_phase`` with the
    environment ``torch.distributed.run`` gives its workers (``env://``):
    join the world (``launch.mesh.init_from_env``: ``cuda:0`` for both
    ranks, ``gloo``), build the ``MESH_SHAPE`` mesh, load the index the
    smoke built and serve the range stream (the driver's
    ``make_serve_fns``: the two-tier steps), the point stream
    (``point_stream``) and the mixed stream (``EngineFreshServer`` over
    the mesh), each with the launch counts reset just before and read
    just after; save the results under ``workdir``. Prints ``# rank r``
    lines and a profile of one more range stream."""
    import torch
    from repro_torch.core import monitor, schedule
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import mesh as meshlib, serve
    w = meshlib.init_from_env("cuda", timeout_s=120)
    try:
        mesh = meshlib.make_debug_mesh(*MESH_SHAPE, device=w.device)
        job = torch.load(workdir / "job.pt", weights_only=False)
        hyb = meshlib.to_device(job["hybrid"], w.device)
        argv = job["argv"] + ["--sort", "hilbert", "--reps", str(MESH_REPS),
                              "--distributed"]
        args = serve.parse_args(argv)
        out = dict(rank=w.rank, device=str(w.device), backend=w.backend,
                   ranks_per_card=w.ranks_per_card)

        def timed_stream(label, run):
            kcuda.reset_launch_counts()
            rep, dt_s = serve.timed(run, args.reps)
            torch.cuda.synchronize()
            out[label] = dict(
                n_results=rep.stats.n_results,
                r_truncated=int(rep.stats.r_truncated.sum()),
                queries_per_s=rep.n_queries / dt_s,
                launches=kcuda.launch_counts(),
                steps=(1 + args.reps) * (rep.n_batches + rep.wide_batches))
            print(f"# rank {w.rank}: mesh {label}: {rep.n_queries} queries "
                  f"in {rep.n_batches} batches + {rep.wide_batches} wide "
                  f"({rep.n_reserved} rows re-served), "
                  f"{rep.n_queries / dt_s:.0f} queries/s", flush=True)

        q = job["queries"]
        bbox = schedule.workload_bbox(q)
        narrow, wide, trunc = serve.make_serve_fns(hyb, args, mesh)

        def range_run():
            return schedule.serve_workload(
                narrow, q, batch=args.batch, sort="hilbert", bbox=bbox,
                wide_fn=wide, trunc_field=trunc, device=w.device)
        timed_stream("range", range_run)
        # every rank serves the profiled stream: a stream one rank alone
        # served would pair its collectives with the other's next stream
        profile_stream(f"mesh range (rank {w.rank})", range_run,
                       out["range"]["steps"] // (1 + args.reps))
        pargs = serve.parse_args(argv + ["--query-type", "point"])
        timed_stream("point", serve.point_stream(hyb, job["points"], pargs,
                                                 mesh)[1])

        margs = serve.parse_args(argv + [
            "--insert-every", "1", "--delta-cap", str(DELTA_CAP),
            "--policy", "default", "--refit-chunk", "4",
            "--repack-at", "0.75"])
        server = monitor.EngineFreshServer(
            job["points"], hyb, serve.engine_config(margs), kind="mlp",
            mesh=mesh, delta_cap=margs.delta_cap,
            wide_factor=margs.wide_factor, fit_state=job["fit_state"],
            policy=monitor.DefaultPolicy(refit_chunk=margs.refit_chunk,
                                         repack_at=margs.repack_at))
        # the serve calls' own launches (rank 0's refit chunks launch the
        # labelling walk too)
        calls, served = [0], dict.fromkeys(kcuda.KERNELS, 0)
        for name in ("serve", "serve_wide"):
            def call(qb, fn=getattr(server, name)):
                calls[0] += 1
                before = kcuda.launch_counts()
                res = fn(qb)
                for n, c in kcuda.launch_counts().items():
                    served[n] += c - before[n]
                return res
            setattr(server, name, call)
        digests, on_segment = [], server.on_segment

        def noted():
            d = on_segment()
            digests.append(hybrid_digest(server.hybrid))
            return d
        server.on_segment = noted
        kcuda.reset_launch_counts()
        t0 = time.time()
        mixed = schedule.serve_mixed_workload(
            server, q, job["inserts"], batch=margs.batch, sort="hilbert",
            bbox=bbox, insert_every=margs.insert_every,
            repack_every=margs.repack_every)
        torch.cuda.synchronize()
        dt_s = time.time() - t0
        out["mixed"] = dict(
            n_results=mixed.stats.n_results,
            r_truncated=int(mixed.stats.r_truncated.sum()),
            queries_per_s=mixed.n_queries / dt_s,
            launches=kcuda.launch_counts(), served=served, steps=calls[0],
            digests=digests,
            repacks=sum(d.repack for _, d in mixed.maintenance),
            refit=sum(r.cells_refit for r in server.refits),
            inserts=mixed.n_inserts)
        print(f"# rank {w.rank}: mesh mixed: {mixed.n_queries} queries / "
              f"{mixed.n_inserts} inserts in {mixed.n_segments} segments "
              f"({calls[0]} steps), {out['mixed']['repacks']} repacks, "
              f"{out['mixed']['refit']} cells refit, "
              f"{mixed.n_queries / dt_s:.0f} queries/s end to end",
              flush=True)
        # the collectives alone, at a step's shapes (both ranks in turn)
        ids = torch.zeros((args.batch, 16), dtype=torch.int32,
                          device=w.device)
        for name, fn in (("psum [B] i32", lambda: mesh.model.psum(ids[:, 0])),
                         ("all_gather [B, 16] i32",
                          lambda: mesh.model.all_gather(ids, 1))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(COLLECTIVE_REPS):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3 / COLLECTIVE_REPS
            print(f"# rank {w.rank}: one {name} over the model group: "
                  f"{out[name]:.3f} ms (host clock, mean of "
                  f"{COLLECTIVE_REPS}; gloo through the host)", flush=True)
        torch.save(out, workdir / f"rank{w.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


class MeshRun:
    """Ranks of this script started on ``job`` (a dict saved once
    with ``torch.save`` into a temporary directory): ``n`` processes of
    ``chip_smoke.py <flag> <dir>`` (phase 7c: ``--engine-mesh-rank``;
    phase 13c: ``--train-mesh-rank``) with the environment
    ``torch.distributed.run`` gives its workers (a free port on
    127.0.0.1), each in a session of its own. ``join`` waits for them: a
    rank that fails or outlives ``timeout_s`` stops them all."""

    def __init__(self, job: dict, flag: str, n: int = 2,
                 timeout_s: float = MESH_TIMEOUT_S):
        import socket
        import tempfile
        import torch
        self.tmp = tempfile.TemporaryDirectory()
        tmp = Path(self.tmp.name)
        torch.save(job, tmp / "job.pt")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        self.timeout_s = timeout_s
        self.logs = [tmp / f"rank{r}.log" for r in range(n)]
        self.procs = []
        self.t0 = time.time()
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), flag,
                     str(tmp)], env=env, cwd=ROOT,
                    stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True))

    @classmethod
    def engine(cls, idx, base_argv, inserts) -> "MeshRun":
        """Phase 7c's ranks on the index ``idx`` (moved to the host)."""
        from repro_torch.launch import mesh as meshlib
        n = MESH_SHAPE[0] * MESH_SHAPE[1]
        return cls(dict(argv=base_argv, points=idx.points,
                        hybrid=meshlib.to_device(idx.hybrid, "cpu"),
                        fit_state=idx.report.fit_state,
                        queries=idx.workload.queries, inserts=inserts),
                   "--engine-mesh-rank", n)

    def join(self):
        """``(failure or None, [(exit code, log text)], seconds, [each
        rank's results])``; the temporary directory is removed."""
        import torch
        failed = None
        try:
            while failed is None and any(p.poll() is None
                                         for p in self.procs):
                if time.time() - self.t0 > self.timeout_s:
                    failed = f"ranks still running after {self.timeout_s} s"
                elif any(p.returncode for p in self.procs
                         if p.poll() is not None):
                    failed = "a rank failed"
                else:
                    time.sleep(0.2)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        if failed is None and any(p.returncode for p in self.procs):
            failed = "a rank exited non-zero"
        wall = time.time() - self.t0
        logs = [(p.returncode, log.read_text())
                for p, log in zip(self.procs, self.logs)]
        outs = [] if failed else [
            torch.load(Path(self.tmp.name) / f"rank{r}.pt",
                       weights_only=False) for r in range(len(self.procs))]
        self.tmp.cleanup()
        return failed, logs, wall, outs


def engine_mesh_phase(run: MeshRun, card, one_rank, beside: str = ""):
    """Phase 7c: the serving engine over ``MESH_SHAPE`` (data 1 x model
    2, the reference driver's mesh at two devices), both ranks on
    ``cuda:0`` over ``gloo`` (NCCL refuses two ranks on one device),
    each (``engine_mesh_rank``) serving its shard of the index ``run``
    saved. Joins ``run``; ``beside`` names what this process did
    meanwhile. Gates: both ranks exit 0 within ``MESH_TIMEOUT_S``; on
    both, ``n_results`` of the range, point and mixed streams equal row
    for row to the one-rank engine's (``one_rank``, from
    ``engine_phase``), no ``r_truncated`` left, the engine's launches a
    step (``ENGINE_LAUNCHES``, plus one ``delta_probe`` in the mixed
    stream), ``spatial_key`` launched, the mixed stream repacked and
    refit, and the ranks' hybrids equal after each maintenance step
    (``hybrid_digest``). Returns ``(launch counts by path, summed over the ranks; the
    rates' text)``."""
    failed, logs, wall, outs = run.join()
    for r, (rc, text) in enumerate(logs):
        print("\n".join(ln for ln in text.splitlines()
                        if ln.startswith(("#", "    "))))
        if failed:
            print(f"# rank {r} exited {rc}; its log's end:\n{text[-4000:]}")
    check(failed is None, f"engine mesh: {failed}")
    n = len(outs)
    print(f"# engine mesh: {n} ranks ran {wall:.1f} s (start, load, "
          f"serve{beside})")
    counts, rates = {}, []
    for o in outs:
        r = o["rank"]
        check(o["backend"] == "gloo" and o["device"] == "cuda:0",
              f"rank {r} on {o['device']} over {o['backend']}")
        for label in ("range", "point", "mixed"):
            got = o[label]
            mism = int((got["n_results"] != one_rank[label]).sum())
            check(mism == 0, f"engine mesh rank {r} {label}: {mism} "
                  "n_results mismatches vs the one-rank engine")
            check(got["r_truncated"] == 0,
                  f"engine mesh rank {r} {label}: rows still r_truncated")
            need = dict(ENGINE_LAUNCHES)
            if label == "mixed":
                need["delta_probe"] = 1
            per = engine_launch_check(f"engine mesh rank {r} {label}",
                                      got.get("served", got["launches"]),
                                      got["steps"], need)
            check(got["launches"]["spatial_key"] > 0,
                  f"engine mesh rank {r} {label}: spatial_key never "
                  "launched")
            print(f"# engine mesh rank {r} {label}: 0 / "
                  f"{got['n_results'].shape[0]} n_results mismatches vs "
                  f"the one-rank engine, 0 rows r_truncated; launches "
                  f"{ {k: v for k, v in got['launches'].items() if v} } "
                  f"({got['steps']} steps; a step: {per})")
            path = f"engine mesh {label}"
            counts[path] = {k: counts.get(path, {}).get(k, 0) + v
                            for k, v in got["launches"].items()}
        m = o["mixed"]
        check(m["inserts"] == INSERTS and m["repacks"] >= 1 and m["refit"],
              f"engine mesh rank {r}: the mixed stream staged "
              f"{m['inserts']} inserts, {m['repacks']} repacks, "
              f"{m['refit']} cells refit")
        rates.append(f"rank {r}: " + ", ".join(
            f"{label} {o[label]['queries_per_s']:.0f} queries/s"
            for label in ("range", "point", "mixed")))
    digests = [o["mixed"]["digests"] for o in outs]
    check(digests[0] and all(d == digests[0] for d in digests),
          "engine mesh mixed: the ranks' hybrids differ after a "
          "maintenance step")
    print(f"# engine mesh mixed: the {n} ranks' hybrids (tree, bank, "
          f"cell_ok) equal after each of {len(digests[0])} maintenance "
          "steps (rank 0's refit chunks broadcast)")
    text = "; ".join(rates)
    print(f"# engine mesh on {card}: a {MESH_SHAPE[0]}x{MESH_SHAPE[1]} mesh "
          f"of {n} ranks sharing one card over gloo, every collective "
          f"through the host (no multi-GPU deployment's rate{beside}): "
          f"{text}")
    return counts, text


def engines_alone(idx, args, base_argv, inserts, dev, card) -> int:
    """``--engine-only``: the hybrid range stream and the mixed stream
    (the one-rank engine's yardsticks), then phases 7b and 7c."""
    from repro_torch.launch import serve
    report, _ = serve.serve_stream(idx.hybrid, idx.workload, args)
    _, _, mixed = mixed_stream(idx, base_argv, inserts, dev)
    _, erates, one_rank = engine_phase(idx, base_argv, inserts, dev, report,
                                       mixed)
    _, mesh_rates = engine_mesh_phase(MeshRun.engine(idx, base_argv, inserts),
                                      card, one_rank)
    print(f"# engine on {card}: one rank: " + ", ".join(
        f"{k} {v}" for k, v in erates.items()) + f"; 1x2 mesh: {mesh_rates}")
    return 0


def forest_fit(idx, beside: str = ""):
    """Phase 8's fit: ``fit_airtree(kind="forest")`` on the deployment's
    tree and labels (host trees, exact-fit evaluation on the card);
    ``beside`` names what ran meanwhile. Returns ``(hybrid, report)``."""
    import torch
    from repro_torch.core import build
    t0 = time.time()
    hyb, rep = build.fit_airtree(idx.dtree, idx.workload, kind="forest",
                                 verbose=True)
    torch.cuda.synchronize()
    print(f"# AI+R (forest): grid {rep.grid_size}², exact-fit "
          f"{rep.exact_fit:.3f} ({int(rep.cell_fit.sum())}/"
          f"{rep.cell_fit.size} cells exact), router test acc "
          f"{rep.router.test_acc:.3f}, models {rep.model_bytes/1e6:.2f} MB, "
          f"fit {time.time() - t0:.1f}s (host trees + exact-fit evaluation "
          f"on the card{beside})")
    return hyb, rep


def forest_phase(idx, forest, base_argv, dev, card):
    """Phase 8: the forest bank at the deployment (``forest``:
    ``forest_fit``'s hybrid and report) — the range stream through it
    with its gates, the dense path of forest_infer_cells and the kernel's
    checks. Returns ``(launch counts by path, the stream's summary, the
    kernel's JSON row)``."""
    import dataclasses
    import torch
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    hyb, rep = forest
    fidx = dataclasses.replace(idx, hybrid=hyb, report=rep)
    fargs = serve.parse_args(base_argv + [
        "--classifier", "forest", "--sort", "hilbert", "--reps", "1"])
    kcuda.reset_launch_counts()
    report, dt_s = serve.serve_stream(hyb, idx.workload, fargs)
    torch.cuda.synchronize()
    counts = {"range (forest bank)": kcuda.launch_counts()}
    mism = serve.report_stream(report, dt_s, fidx)
    print(f"# launches over 2 forest-bank range streams: "
          f"{counts['range (forest bank)']}")
    check(mism == 0, f"forest oracle: {mism} n_results mismatches")
    for name in ("spatial_key", "traverse_fused", "leaf_refine",
                 "forest_infer"):
        check(counts["range (forest bank)"][name] > 0,
              f"{name} never launched on the forest-bank stream")
    check(counts["range (forest bank)"]["mlp_predict_compact"] == 0,
          "the forest-bank stream launched mlp_predict_compact")
    brute_force_check(fidx, report, dev, 512, 512)
    st = report.stats
    ai = 100 * float(st.used_ai.mean())
    acc = float(st.leaf_accesses.mean())
    rate = (f"{report.n_queries / dt_s:.0f} queries/s, {ai:.1f}% AI path, "
            f"{acc:.2f} leaf accesses/query")
    print(f"# serve forest on {card}: {rate}")
    profile_stream("range (forest bank)",
                   serve.range_stream(hyb, idx.workload, fargs))
    counts["forest (dense)"], row = forest_dense(hyb.ait.bank,
                                                 idx.workload.queries, dev)
    return counts, rate, row


def forest_dense(bank, queries, dev):
    """The dense form of the forest bank, ``forest.cell_probs_dense``,
    over the stream's queries in batches of 512 (launch counts reset
    before and read after); then, outside the counts, each batch against
    the gathered form over every cell, and forest_infer_cells against its
    plain version on the first batch and on a synthetic bank. Returns
    ``(launch counts, the kernel's JSON row)``."""
    import torch
    from repro_torch.core.classifiers import forest
    from repro_torch.kernels import cuda as kcuda, ops, ref
    q_all = torch.from_numpy(queries).to(dev)
    batches = [q_all[o:o + 512] for o in range(0, q_all.shape[0], 512)]
    kcuda.reset_launch_counts()
    dense = [forest.cell_probs_dense(bank, q) for q in batches]
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    print(f"# launches over the forest bank's dense form ({len(batches)} "
          f"batches): { {n: c for n, c in counts.items() if c} }")
    check(counts["forest_infer_cells"] == len(batches),
          f"forest_infer_cells launched {counts['forest_infer_cells']} "
          f"times for {len(batches)} batches")
    C, T, D = bank.feat_idx.shape
    Cl = bank.tables.shape[-1]
    for q, d in zip(batches, dense):
        ids = torch.arange(C, dtype=torch.int32, device=dev).expand(
            q.shape[0], C)
        check(torch.equal(d, forest.cell_probs_for(bank, q, ids)),
              "cell_probs_dense differs from cell_probs_for over every cell")
    del dense
    fi = bank.feat_idx.reshape(C * T, D)
    th = bank.thresh.reshape(C * T, D)
    tb = bank.tables.reshape(C * T, 2 ** D, Cl)
    q = batches[0]
    launch, votes = ops.prepare("forest_infer_cells", q, fi, th, tb, C)
    launch()
    want = ref.forest_infer_cells(q, fi, th, tb, C)
    mism = int((votes != want).sum())
    check(mism == 0, f"forest_infer_cells (deployment bank): {mism} "
          "mismatches (bit-exact)")
    del votes, want
    synthetic_forest_check(q, dev)
    print(f"  forest_infer_cells: bit-equal to its plain version on the "
          f"deployment's bank ({C} cells x {T} tree, depth {D}, {Cl} "
          f"labels) and on the synthetic bank; cell_probs_dense equals "
          f"the gathered form over every cell on all {len(batches)} "
          f"batches")
    # the bound counts what this batch needs: the output, the table rows
    # its codes name (each once), the features and the trees' tests
    bits = (q[:, fi.long()] > th[None]).long()
    powers = 2 ** torch.arange(D - 1, -1, -1, device=dev)
    codes = (bits * powers).sum(-1)                           # [B, C·T]
    rows = torch.arange(C * T, device=dev)[None, :] * 2 ** D + codes
    n_rows = int(torch.unique(rows).numel())
    B = q.shape[0]
    n_bytes = B * C * Cl * 4 + n_rows * Cl * 4 + q.numel() * 4 \
        + C * T * D * 8
    n_ops = B * C * T * D + B * C * Cl * (T - 1)
    row = kernel_row("forest_infer_cells", mism, launch,
                     lambda: ref.forest_infer_cells(q, fi, th, tb, C),
                     n_bytes, n_ops,
                     label=f" (deployment bank, batch {B}, {n_rows} "
                           f"distinct table rows)")
    del rows, codes, bits
    return counts, row


def synthetic_forest_check(q, dev) -> None:
    """forest_infer_cells on a synthetic bank over the batch's features:
    16 cells of 4 trees of depth 8, 37 labels (not a multiple of 32),
    cells 3 and 7 empty (``thresh = +inf``), thresholds from the
    features' own values so that both branches are taken, one feature
    exactly on its threshold. Bit-equal to the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    C, T, D, Cl = 16, 4, 8, 37
    x = q.cpu().numpy()
    B, F = x.shape
    fi = rng.integers(0, F, (C * T, D)).astype(np.int32)
    th = x[rng.integers(0, B, (C * T, D)), fi]
    th[3 * T:4 * T] = np.inf
    th[7 * T:8 * T] = np.inf
    tb = rng.uniform(0, 1, (C * T, 2 ** D, Cl)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (x, fi, th, tb)]
    launch, votes = ops.prepare("forest_infer_cells", *args, C)
    launch()
    want = ref.forest_infer_cells(*args, C)
    check(torch.equal(votes, want), "forest_infer_cells (synthetic bank, "
          f"T 4): {int((votes != want).sum())} mismatches")
    check(bool((votes[:, 3] == votes[0, 3]).all()),
          "forest_infer_cells: an empty cell's votes vary by query")


def open_loop_phase(idx, base_argv, dev):
    """Phase 9: the MLP range stream open-loop (``serve_open_loop``)
    under Poisson arrivals, both formations. The driver's automatic rate
    (1.5x the measured capacity) and deadline (6x a narrow + wide step)
    are computed once from one ``serve.measure_capacity`` and passed to
    both runs, so the two formations see the same arrivals and
    deadlines. Returns ``(launch counts by path, {formation:
    summary})``."""
    import torch
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve
    args = serve.parse_args(base_argv + ["--sort", "hilbert"])
    narrow, wide, trunc = serve.make_serve_fns(idx.hybrid, args)
    ts = serve.measure_capacity(narrow, wide, idx.workload.queries, args)
    step = ts["narrow"] + ts["wide"]
    rate = 1.5 * args.batch / step
    print(f"# open-loop capacity: narrow step {ts['narrow']*1e3:.3f} ms, "
          f"wide step {ts['wide']*1e3:.3f} ms (host clock, median of 3) -> "
          f"{args.batch / step:.0f} queries/s; both formations at "
          f"{rate:.0f} queries/s offered, deadline {6e3 * step:.3f} ms")
    counts, summary = {}, {}
    for formation in ("deadline", "full"):
        oargs = serve.parse_args(base_argv + [
            "--sort", "hilbert", "--arrival", "poisson", "--formation",
            formation, "--rate", repr(rate), "--deadline-ms",
            repr(6e3 * step)])
        kcuda.reset_launch_counts()
        t0 = time.time()
        rep, mism = serve.serve_open_loop(narrow, wide, trunc, idx.workload,
                                          oargs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        path = f"open loop ({formation})"
        counts[path] = kcuda.launch_counts()
        print(f"# launches over the {path} stream: "
              f"{ {n: c for n, c in counts[path].items() if c} }")
        check(mism == 0, f"{path} oracle: {mism} mismatches on rows not "
              "degraded")
        check(rep.stats.truncated[rep.degraded].all(),
              f"{path}: a degraded row lost its truncation flag")
        for name in ("spatial_key", "traverse_fused", "leaf_refine",
                     "mlp_predict_compact", "forest_infer"):
            check(counts[path][name] > 0,
                  f"{name} never launched on the {path} stream")
        lat = rep.telemetry["latency_s"]
        summary[formation] = (
            f"p50 {lat['p50']*1e3:.3f} / p95 {lat['p95']*1e3:.3f} / p99 "
            f"{lat['p99']*1e3:.3f} ms, goodput {100*rep.goodput:.2f}%, "
            f"{rep.n_degraded} degraded, {rep.n_missed} missed, "
            f"{rep.n_batches} + {rep.n_wide_batches} wide batches "
            f"(mean fill {100*rep.mean_fill:.1f}%), {wall:.2f}s wall")
        print(f"# open loop ({formation}): {summary[formation]}")
    return counts, summary


# rwkv6-3b: the LM serving path at the published width
RWKV_PREFILL = ((1, 32768), (8, 4096))   # cut from prefill_32k's [32, 32768]
RWKV_DECODE_BATCH = 128                  # decode_32k's batch
RWKV_DECODE_PROMPT, RWKV_DECODE_TOKENS = 16, 32
RWKV_CHECK = (4, 256)                    # decode-vs-forward prompt
WKV6_TOL = 5e-4                          # the reference's (test_kernels.py)
WKV6_SUB = 16                            # csrc/wkv6.cu's sub-chunk (kSub)


def _wkv6_chunks(T: int, chunk: int) -> list:
    return [chunk] * (T // chunk) + ([T % chunk] if T % chunk else [])


def wkv6_work(BH: int, T: int, dk: int, dv: int, chunk: int
              ) -> tuple[int, int, int]:
    """What one wkv6 call needs, whatever computes it: bytes (r, k, w, v
    read once and y written once, f32; u is BH·dk) and the operations of
    the least-work decomposition, the sub-chunked one. Per chunk of n
    steps and row: in f32, the per-channel diagonal blocks (m(m-1)/2 ·
    dk pairs for a block of m <= 16 steps; subtract, exp, multiply,
    multiply-add: 5) and the bonus (3 n·dk); on the tensor cores, one
    product each (a split-operand product takes three): the off-diagonal
    scores (2·dk a pair of steps in different blocks), scores @ v (2·dv a
    pair, the diagonal included), the inter-chunk and state products
    (2 n·dk·dv each). Counts the T steps, not the padded ones. Returns
    (bytes, f32 operations, tensor-core operations)."""
    n_bytes = 4 * (BH * T * (3 * dk + 2 * dv) + BH * dk)
    f32 = tc = 0
    for n in _wkv6_chunks(T, chunk):
        diag = sum(m * (m - 1) // 2 for m in _wkv6_chunks(n, WKV6_SUB))
        pairs = n * (n - 1) // 2
        f32 += 5 * diag * dk + 3 * n * dk
        tc += 2 * (pairs - diag) * dk + 2 * (pairs + n) * dv \
            + 4 * n * dk * dv
    return n_bytes, BH * f32, BH * tc


def wkv6_bound(BH: int, T: int, dk: int, dv: int, chunk: int
               ) -> tuple[float, str]:
    """The least time of one wkv6 call: the larger of its bytes over
    HBM and its operations (``wkv6_work``: f32 work at 67 TFLOP/s, then
    tensor-core work at the dense TF32 peak)."""
    n_bytes, f32, tc = wkv6_work(BH, T, dk, dv, chunk)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (f32 / F32_OPS_PER_S + tc / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wkv6_scores_bound(BH: int, T: int, dk: int, dv: int, chunk: int
                      ) -> float:
    """The chunk-serial kernel's yardstick, printed for continuity: every
    strictly causal score of a chunk per channel (n(n-1)/2 · dk, 5
    operations each), their product with v, the inter-chunk and state
    products and the bonus, all on f32 at 67 TFLOP/s, against the same
    bytes. It counts one decomposition's work, not the function's."""
    ops = 0
    for n in _wkv6_chunks(T, chunk):
        pairs = n * (n - 1) // 2
        ops += pairs * dk * 5 + 2 * pairs * dv + 4 * n * dk * dv + 3 * n * dk
    return bound_ms(wkv6_work(BH, T, dk, dv, chunk)[0], BH * ops)[0]


def wkv6_phase_text(ms_by_kernel: dict) -> str:
    return ", ".join(f"{n.removeprefix('wkv6_').removesuffix('_kernel')} "
                     f"{ms:.4f}" for n, ms in ms_by_kernel.items())


def wkv6_err(got, want) -> tuple[float, bool]:
    """Max |got - want| and whether every element is within
    ``WKV6_TOL + WKV6_TOL·|want|`` (and finite)."""
    import torch
    diff = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and \
        bool((diff <= WKV6_TOL + WKV6_TOL * want.abs()).all())
    return float(diff.max()), ok


def wkv6_checks(cfg, params, toks_by_path, dev):
    """The kernel against its plain version: the ``ops.wkv6`` wrapper
    (the call ``rwkv_time_mix`` makes) on layer 0's real r, k, v, w, u
    from each prefill shape, and on synthetic edge cases at dk = dv = 64.
    Times the kernels alone at each prefill shape; returns the kernel's
    JSON row at the longest."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ssm, transformer as tf
    from repro_torch.models.layers import rmsnorm
    lp = tf.layer(params, 0)
    # shortest T first: its plain scan warms the one that is timed
    for path, toks in sorted(toks_by_path.items(),
                             key=lambda kv: kv[1].shape[1]):
        with torch.no_grad():
            h = rmsnorm(params["embed"][toks], lp["norm1"], cfg.norm_eps)
            zeros = torch.zeros((toks.shape[0], cfg.d_model),
                                dtype=h.dtype, device=dev)
            r, k, v, w, u, _ = ssm.rwkv_wkv_inputs(cfg, lp, h, zeros)
            args = (r.float(), k.float(), v.float(), w, u)
            del h, r, k, v
        y = ops.wkv6(*args)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = ref.wkv6(*args)
        b.record()
        b.synchronize()
        plain_ms = a.elapsed_time(b)
        BH, T, dk = args[0].shape
        err, ok = wkv6_err(y, want)
        mism = int((~torch.isclose(y, want, rtol=WKV6_TOL,
                                   atol=WKV6_TOL)).sum())
        print(f"  wkv6 (ops.wkv6 on layer 0 of the {path} forward, BH {BH}, "
              f"dk {dk}): max |kernel - plain| {err:.3e} (max |y| "
              f"{float(want.abs().max()):.3f}), tolerance {WKV6_TOL} + "
              f"{WKV6_TOL}·|y|: {'held' if ok else 'BROKEN'}; plain "
              f"{plain_ms:.4f} ms (one call between events)")
        check(ok, f"wkv6 on layer 0 of the {path} forward: max error {err}")
        del y, want
        # the kernels alone on these inputs, beside the plain version
        launch, _ = ops.prepare("wkv6", *args, ops.WKV6_CHUNK)
        phases = kernel_means(profiled_events(launch, "wkv6_"))
        ms = sum(phases.values()) if phases else event_ms(launch)
        src = f"CUPTI, mean a launch: {wkv6_phase_text(phases)}" \
            if phases else "cuda-events"
        b, by = wkv6_bound(BH, T, dk, dk, ops.WKV6_CHUNK)
        print(f"  wkv6 (layer 0 of the {path} forward): {mism} mismatches, "
              f"kernels {ms:.4f} ms a call ({src}; {event_ms(launch):.4f} "
              f"ms between events), plain {plain_ms:.4f} ms (one call "
              f"between events: ~10^5 launches, too many to profile), "
              f"bound {b:.4f} ms ({by}; the chunk-serial yardstick "
              f"{wkv6_scores_bound(BH, T, dk, dk, ops.WKV6_CHUNK):.4f} ms)")
        # the row is the longest prefill's, the last one
        row = json_row("wkv6", ms, plain_ms, b, by, err)
        del launch
    rng = np.random.default_rng(0)
    for label, T_, lo, hi, zero, dt in (
            ("T 33", 33, 0.05, 0.999, False, torch.float32),
            ("T 4097", 4097, 0.05, 0.999, False, torch.float32),
            ("decay in [1e-8, 0.1]", 1000, 1e-8, 0.1, False, torch.float32),
            ("w = 0 rows", 1000, 0.05, 0.999, True, torch.float32),
            ("w = 0 at sub-chunk and chunk bounds", 1000, 0.05, 0.999,
             "bounds", torch.float32),
            ("bf16 inputs", 1000, 0.05, 0.999, False, torch.bfloat16)):
        a = [rng.normal(size=(8, T_, 64)).astype(np.float32)
             for _ in range(3)]
        a.append(rng.uniform(lo, hi, (8, T_, 64)).astype(np.float32))
        a.append(rng.normal(size=(8, 64)).astype(np.float32))
        if zero == "bounds":
            for i, step in ((0, 0), (0, 15), (1, 16), (2, 63), (3, 64),
                            (4, 127), (5, 128), (6, 999), (7, 511)):
                a[3][i, step] = 0.0
            a[3][7, 512, :9] = 0.0
        elif zero:
            a[3][0, 70] = 0.0
            a[3][1, 5, :7] = 0.0
            a[3][2, 127] = 0.0
        e = [torch.from_numpy(x).to(dev).to(dt) for x in a]
        got = ops.wkv6(*e)
        want = ref.wkv6(*e)
        err_, ok_ = wkv6_err(got, want)
        print(f"  wkv6 ({label}, BH 8, dk = dv = 64): max |kernel - plain| "
              f"{err_:.3e} (max |y| {float(want.abs().max()):.3f}): "
              f"{'held' if ok_ else 'BROKEN'}")
        check(ok_, f"wkv6 ({label}): max error {err_}")
    return row


def rwkv_phase(dev, card):
    """Phase 12: the rwkv6-3b serving path at the published width
    (``configs/rwkv6_3b.py``), weights from ``init_params`` (bf16,
    ``torch.Generator`` seed 0, on the card). Prefill ``forward`` at each
    ``RWKV_PREFILL`` shape (32 wkv6 launches, finite logits, tokens/s,
    device ms, wkv6 ms per launch beside its bound); the kernel against
    its plain version; decode against forward in f32 (rel < 2e-2); greedy
    decode at batch 128 (no wkv6 launch). Returns ``(launch counts by
    path, the summary, the wkv6 JSON row)``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels import cuda as kcuda, ops
    from repro_torch.models import transformer as tf
    from repro_torch.serving import decode, kvcache
    t_all = time.time()
    cfg = configs.get_config("rwkv6_3b")
    L = cfg.n_layers
    t0 = time.time()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    tensors = [params["embed"], params["final_norm"], params["lm_head"],
               *params["layers"].values()]
    n_par = sum(t.numel() for t in tensors)
    print(f"# rwkv6-3b: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.d_model // cfg.n_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}; {n_par} parameters (config n_params "
          f"{cfg.n_params()}), {sum(t.numel() * t.element_size() for t in tensors) / 1e9:.3f} "
          f"GB bf16 on the card, drawn in {time.time()-t0:.1f}s")
    print("# rwkv6-3b CUT: prefill at [1, 32768] and [8, 4096] instead of "
          "prefill_32k's [32, 32768]: forward returns the full [B, S, 65536] "
          "logits, 137 GB in bf16 at batch 32")
    gen = torch.Generator(device=dev).manual_seed(1)
    counts, summary = {}, {}
    toks_by_path = {}
    for Bp, Sp in RWKV_PREFILL:
        path = f"prefill [{Bp}, {Sp}]"
        toks = torch.randint(0, cfg.vocab, (Bp, Sp), generator=gen,
                             device=dev)
        with torch.no_grad():
            def run():
                return tf.forward(cfg, params, {"tokens": toks})
            run()
            torch.cuda.synchronize()
            kcuda.reset_launch_counts()
            logits = run()
            torch.cuda.synchronize()
            counts[path] = kcuda.launch_counts()
            finite = bool(torch.isfinite(logits).all())
            shape = tuple(logits.shape)
            del logits
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        print(f"# launches over one {path} forward: "
              f"{ {n: c for n, c in counts[path].items() if c} }")
        check(counts[path]["wkv6"] == L, f"{path}: wkv6 launched "
              f"{counts[path]['wkv6']} times, not once per layer ({L})")
        check(finite, f"{path}: logits not finite")
        check(shape == (Bp, Sp, cfg.vocab_padded), f"{path}: logits {shape}")
        ev = cuda_events(prof)
        busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        wk = cuda_events(prof, "wkv6_")
        wk_mean = kernel_means(wk)
        wk_sum = sum(e.time_range.elapsed_us() for e in wk) / 1e3
        b, by = wkv6_bound(Bp * cfg.n_heads, Sp, 64, 64, ops.WKV6_CHUNK)
        summary[path] = (
            f"{Bp * Sp / wall:.0f} tokens/s, {wall * 1e3:.1f} ms wall, "
            f"device {busy:.1f} ms per forward (wkv6 "
            f"{sum(wk_mean.values()):.4f} ms a call x {L} = "
            f"{100 * wk_sum / max(busy, 1e-9):.1f}% of it; ms a launch: "
            f"{wkv6_phase_text(wk_mean)})")
        print(f"# rwkv6-3b {path} on {card}: {summary[path]}; wkv6 bound "
              f"{b:.4f} ms ({by}); {len(ev)} device activities "
              f"({len(wk)} wkv6 kernel launches)")
        top: dict = {}
        for e in ev:
            top[e.name] = top.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
        for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {ms:9.3f} ms  {name[:100]}")
        toks_by_path[path] = toks

    print("# wkv6 vs its plain version on the card (tolerance rtol = atol "
          f"= {WKV6_TOL}, the reference's; f32, another order of sums):")
    row = wkv6_checks(cfg, params, toks_by_path, dev)
    del toks_by_path

    # decode against forward at full width, f32 weights (TF32 off)
    t0 = time.time()
    p32 = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    Bc, Sc = RWKV_CHECK
    toks = torch.randint(0, cfg.vocab, (Bc, Sc), generator=gen, device=dev)
    with torch.no_grad():
        fwd = tf.forward(cfg, p32, {"tokens": toks})[:, -1].clone()
        last, _ = decode.prefill_via_decode(
            cfg, p32, kvcache.make_cache(cfg, Bc, Sc, dtype=torch.float32,
                                         device=dev), toks)
    torch.cuda.synchronize()
    rel = float((last - fwd).abs().max()) / (float(fwd.abs().max()) + 1e-9)
    same = int((last.argmax(-1) == fwd.argmax(-1)).sum())
    summary["decode vs forward"] = (f"rel {rel:.3e}, argmax equal on "
                                    f"{same}/{Bc} rows")
    print(f"# rwkv6-3b decode vs forward (f32 weights, [{Bc}, {Sc}] "
          f"prompt, last position): {summary['decode vs forward']} "
          f"({time.time()-t0:.1f}s)")
    check(rel < 2e-2, f"rwkv6-3b decode diverges from forward: rel {rel}")
    del p32, fwd, last

    # greedy decode at decode_32k's batch (bf16 weights and cache)
    Bd = RWKV_DECODE_BATCH
    prompt = torch.randint(0, cfg.vocab, (Bd, RWKV_DECODE_PROMPT),
                           generator=gen, device=dev)
    cache = kvcache.make_cache(cfg, Bd, 32768, dtype=torch.bfloat16,
                               device=dev)
    with torch.no_grad():
        kcuda.reset_launch_counts()
        t0 = time.perf_counter()
        # token by token here, not through prefill_via_decode: a caller
        # holding the first cache would keep a third cache alive
        for t in range(LM_DECODE_PROMPT):
            logits, cache = decode.decode_step(cfg, params, cache,
                                               prompt[:, t:t + 1])
        torch.cuda.synchronize()
        t_prompt = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        t0 = time.perf_counter()
        for _ in range(RWKV_DECODE_TOKENS):
            tok = logits.argmax(-1, keepdim=True)
            logits, cache = decode.decode_step(cfg, params, cache, tok)
            finite &= bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        counts["decode"] = kcuda.launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode.decode_step(cfg, params, cache, tok)
            torch.cuda.synchronize()
            step_wall = (time.perf_counter() - t0) * 1e3
    ev = cuda_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    top = {}
    for e in ev:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"# profile of one rwkv6-3b decode step at batch {Bd} (CUPTI): "
          f"wall {step_wall:.2f} ms, device busy {busy:.3f} ms (idle "
          f"{100 - 100 * busy / step_wall:.1f}%), {len(ev)} device "
          "activities")
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {ms:8.3f} ms  {name[:100]}")
    check(finite, "rwkv6-3b decode: logits not finite")
    check(counts["decode"]["wkv6"] == 0,
          f"rwkv6-3b decode launched wkv6 {counts['decode']['wkv6']} times")
    check(int(cache["pos"]) == RWKV_DECODE_PROMPT + RWKV_DECODE_TOKENS,
          f"rwkv6-3b decode: cache pos {int(cache['pos'])}")
    summary["decode"] = (
        f"batch {Bd}: {Bd * RWKV_DECODE_TOKENS / t_dec:.0f} tokens/s over "
        f"{RWKV_DECODE_TOKENS} greedy steps ({1e3 * t_dec / RWKV_DECODE_TOKENS:.2f} "
        f"ms a step, host clock to a synchronize; the {RWKV_DECODE_PROMPT}-token "
        f"prompt {t_prompt:.2f}s), cache {kvcache.cache_bytes(cache) / 1e9:.3f} "
        f"GB, 0 wkv6 launches")
    print(f"# rwkv6-3b decode on {card}: {summary['decode']}")
    del params, cache, logits
    torch.cuda.empty_cache()
    print(f"# rwkv6-3b phase: {time.time()-t_all:.1f}s")
    return counts, summary, row


# rwkv6-3b training: launch/train.py's defaults at the published width
TRAIN_ARGV = ("--arch", "rwkv6-3b", "--batch", "8", "--seq", "128",
              "--dtype", "float32", "--accum", "1", "--device", "cuda")
TRAIN_STEPS = 3                          # cut from the driver's --steps 100
TRAIN_TOL = 1e-4                         # card step against the CPU's
WKV6_GRAD_SHAPES = ((320, 128), (8, 37))  # a full-width layer; odd T
# the card-against-CPU steps: (what, "reduced" or the published width's
# layers, batch, seq)
TRAIN_CHECKS = (("reduced (2 layers, d 64)", "reduced", 8, 128),
                ("published width, 1 layer (d 2560, vocab 65536)", 1, 2, 64))


def wkv6_grad_check(dev, BH: int, T: int, seed: int) -> dict:
    """``ops.wkv6`` under autograd on the card (the ``_WKV6`` Function:
    the kernel forward, one launch; the plain scan recomputed for the
    backward) against autograd through ``ref.wkv6`` on the same inputs
    and cotangent; forward and every gradient within ``wkv6_err``'s
    5e-4. Returns the max errors."""
    import numpy as np
    import torch
    from repro_torch.kernels import cuda as kcuda, ops, ref
    rng = np.random.default_rng(seed)
    D = 64
    a = [rng.normal(size=(BH, T, D)) for _ in range(3)] + \
        [rng.uniform(0.05, 0.999, (BH, T, D)), rng.normal(size=(BH, D))]
    xs = [torch.from_numpy(x.astype(np.float32)).to(dev).requires_grad_()
          for x in a]
    gy = torch.from_numpy(rng.normal(size=(BH, T, D)).astype(
        np.float32)).to(dev)
    kcuda.reset_launch_counts()
    y = ops.wkv6(*xs)
    torch.cuda.synchronize()
    launched = kcuda.launch_counts()["wkv6"]
    check(launched == 1, f"wkv6 under autograd [{BH}, {T}]: {launched} "
          "launches, not 1")
    check(y.grad_fn is not None and "WKV6" in type(y.grad_fn).__name__,
          f"wkv6 under autograd [{BH}, {T}]: no _WKV6 node "
          f"({type(y.grad_fn).__name__})")
    got = torch.autograd.grad(y, xs, gy)
    xr = [x.detach().clone().requires_grad_() for x in xs]
    yr = ref.wkv6(*xr)
    want = torch.autograd.grad(yr, xr, gy)
    errs = {}
    for name, g, w in zip(("y", "r", "k", "v", "w", "u"),
                          (y.detach(),) + got, (yr.detach(),) + want):
        err, ok = wkv6_err(g, w)
        errs[name] = err
        check(ok, f"wkv6 under autograd [{BH}, {T}]: d{name} max error "
              f"{err}" if name != "y" else
              f"wkv6 under autograd [{BH}, {T}]: forward max error {err}")
    print(f"  wkv6 under autograd [{BH}, {T}, 64]: 1 launch, max |card - "
          "plain|: " + ", ".join(f"{'' if n == 'y' else 'd'}{n} {e:.3e}"
                                 for n, e in errs.items()) +
          f" (tolerance {WKV6_TOL} + {WKV6_TOL}·|plain|): held")
    return errs


def train_step_check(label, cfg, ocfg, B, T, dev):
    """One train step (``ocfg``, remat "dots") on the card against the
    same step on the CPU from the same float32 weights (drawn on the
    card, copied to the host first): loss and grad norm within
    ``TRAIN_TOL`` relative. Returns ``(the larger relative difference,
    the card step's launch counts)``."""
    import torch
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import train
    from repro_torch.training import train_loop, tree
    s_card = train_loop.init_train_state(
        cfg, torch.Generator(dev).manual_seed(0), dtype=torch.float32,
        opt_cfg=ocfg, device=dev)
    s_cpu = tree.rebuild(s_card, lambda _, t: t.to("cpu", copy=True))
    batch = train.synthetic_batch(cfg, B, T, 0)
    step = train_loop.make_train_step(cfg, opt_cfg=ocfg)
    kcuda.reset_launch_counts()
    s_card, m_card = step(s_card, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    counts = kcuda.launch_counts()
    s_cpu, m_cpu = step(s_cpu, batch)
    rel = {k: abs(float(m_card[k]) - float(m_cpu[k])) /
           max(abs(float(m_cpu[k])), 1e-30) for k in ("loss", "grad_norm")}
    print(f"  {label} [{B}, {T}]: card loss {float(m_card['loss']):.6f} "
          f"gnorm {float(m_card['grad_norm']):.6f}, CPU loss "
          f"{float(m_cpu['loss']):.6f} gnorm {float(m_cpu['grad_norm']):.6f}"
          f"; rel {rel['loss']:.3e} / {rel['grad_norm']:.3e} (tolerance "
          f"{TRAIN_TOL}); kernel launches "
          f"{ {n: c for n, c in counts.items() if c} or 'none'}")
    check(max(rel.values()) <= TRAIN_TOL,
          f"train step, {label}: card against CPU rel {rel}")
    del s_card, s_cpu, m_card, m_cpu
    torch.cuda.empty_cache()
    return max(rel.values()), counts


def train_phase(dev, card):
    """Phase 13: rwkv6-3b training. (a) ``ops.wkv6`` under autograd
    against the plain scan under autograd (``WKV6_GRAD_SHAPES``); (b) one
    train step on the card against the same step on the CPU from the
    same weights, at ``reduced(rwkv6_3b)`` and at the published width
    cut to one layer (``TRAIN_CHECKS``; loss and grad norm within
    ``TRAIN_TOL`` relative; 2 wkv6 launches a layer with remat
    "dots"); (c) ``launch/train.py``'s defaults at the published width
    (``setup`` and its step, float32, remat "dots"), ``TRAIN_STEPS``
    steps: loss, grad norm, lr, ms, tokens/s, wkv6 launches a step,
    peak memory; the forward kernel's and the plain backward's device
    ms a call (CUPTI) at a layer's shape. Returns ``(launch counts of
    one full-width step, the summary, the wkv6 row's training fields)``.
    """
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import cuda as kcuda, ops, ref
    from repro_torch.launch import train
    from repro_torch.training import optimizer as opt, tree
    t_all = time.time()
    print(f"# rwkv6-3b training on {card}; {torch.cuda.memory_allocated() / 1e9:.3f} "
          "GB allocated on entry")
    print("# (a) wkv6 under autograd on the card against the plain scan "
          "under autograd:")
    for i, (BH, T) in enumerate(WKV6_GRAD_SHAPES):
        wkv6_grad_check(dev, BH, T, 40 + i)

    # (b) one step on the card against the same step on the CPU, from the
    # same weights: at reduced(rwkv6_3b), and at the published width with
    # the depth cut to one layer (the width's GEMMs, dk 64 and the vocab)
    full = configs.get_config("rwkv6_3b")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=0)
    print("# (b) one step, card against CPU:")
    for what, cfg_r, B, T in TRAIN_CHECKS:
        cfg_r = (configs.reduced(full) if cfg_r == "reduced" else
                 dataclasses.replace(full, n_layers=cfg_r))
        _, c = train_step_check(f"rwkv6-3b, {what}", cfg_r, ocfg, B, T, dev)
        check(c["wkv6"] == 2 * cfg_r.n_layers, f"train step, {what}: "
              f"{c['wkv6']} wkv6 launches, not 2 x {cfg_r.n_layers} "
              "(forward + remat)")

    # (c) the driver's defaults at the published width
    argv = list(TRAIN_ARGV) + ["--steps", str(TRAIN_STEPS)]
    print(f"# rwkv6-3b training CUT: {TRAIN_STEPS} steps instead of the "
          "driver's --steps 100")
    args = train.parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cfg, state, step_fn, start = train.setup(args)
    torch.cuda.synchronize()
    check(start == 0, f"training resumed at step {start}")
    L = cfg.n_layers
    n_par = sum(t.numel() for _, t in tree.leaves(state.params))
    n_state = sum(t.numel() * t.element_size()
                  for _, t in tree.leaves(state))
    print(f"# rwkv6-3b training: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_par} parameters, "
          f"--dtype {args.dtype}: params + m + v {n_state / 1e9:.3f} GB "
          f"(+ {n_par * 4 / 1e9:.3f} GB of grads in a step), set up in "
          f"{time.time() - t0:.1f}s")
    probe = {k: state.params["layers"][k][0, :2].clone()
             for k in ("wr", "wck", "u")}
    probe["embed"] = state.params["embed"][:2].clone()
    toks = args.batch * args.seq
    rows = []
    counts = None
    for step in range(TRAIN_STEPS):
        batch = train.synthetic_batch(cfg, args.batch, args.seq, step,
                                      device=dev)
        kcuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = kcuda.launch_counts()
        counts = counts or c
        gn, lr = float(metrics["grad_norm"]), float(metrics["lr"])
        rows.append((loss, gn, lr, dt, c["wkv6"]))
        print(f"  step {step}: loss {loss:.4f} gnorm {gn:.4f} lr {lr:.3e} "
              f"{dt * 1e3:.1f} ms ({toks / dt:.0f} tok/s), wkv6 launches "
              f"{c['wkv6']}, other kernels "
              f"{sum(v for k, v in c.items() if k != 'wkv6')}")
        check(np.isfinite(loss) and np.isfinite(gn),
              f"training step {step}: loss {loss}, gnorm {gn}")
        check(c["wkv6"] == 2 * L, f"training step {step}: {c['wkv6']} "
              f"wkv6 launches, not 2 x {L} (forward + remat recompute)")
        del batch, metrics
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    changed = {k: not torch.equal(v, (state.params["layers"][k][0, :2]
                                      if k != "embed" else
                                      state.params["embed"][:2]))
               for k, v in probe.items()}
    check(all(changed.values()), f"params unchanged after training: "
          f"{changed}")
    steady = [r[3] for r in rows[1:]]
    ms = 1e3 * statistics.mean(steady)
    print(f"# rwkv6-3b training on {card}: {TRAIN_STEPS} steps, batch "
          f"{args.batch} x seq {args.seq}; steps 1-{TRAIN_STEPS - 1}: "
          f"{ms:.1f} ms a step mean ({toks / (ms / 1e3):.0f} tokens/s), "
          f"step 0 {rows[0][3] * 1e3:.1f} ms; peak memory "
          f"{peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated); loss "
          f"{rows[0][0]:.4f} -> {rows[-1][0]:.4f}")

    # one more step under CUPTI: device busy and the wkv6 kernels' share
    batch = train.synthetic_batch(cfg, args.batch, args.seq, TRAIN_STEPS,
                                  device=dev)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    ev = cuda_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    wk = cuda_events(prof, "wkv6_")
    wk_sum = sum(e.time_range.elapsed_us() for e in wk) / 1e3
    top: dict = {}
    for e in ev:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"# profile of one more full-width step (CUPTI): wall "
          f"{prof_wall:.1f} ms, device busy {busy:.1f} ms (idle "
          f"{100 - 100 * busy / prof_wall:.1f}%), {len(ev)} device "
          f"activities; wkv6 kernels {wk_sum:.2f} ms ({len(wk)} launches "
          f"of its three kernels, {100 * wk_sum / max(busy, 1e-9):.1f}% of "
          "busy)")
    for name, t in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {t:9.3f} ms  {name[:100]}")
    del state, metrics, batch, prof, ev, wk, probe
    torch.cuda.empty_cache()

    # a layer's scan alone: the kernel forward, the plain backward
    rng = np.random.default_rng(9)
    BH, T = args.batch * cfg.n_heads, args.seq
    a = [rng.normal(size=(BH, T, 64)) for _ in range(3)] + \
        [rng.uniform(0.05, 0.999, (BH, T, 64)), rng.normal(size=(BH, 64))]
    xs = [torch.from_numpy(x.astype(np.float32)).to(dev) for x in a]
    gy = torch.from_numpy(rng.normal(size=(BH, T, 64)).astype(
        np.float32)).to(dev)
    launch, _ = ops.prepare("wkv6", *xs, ops.WKV6_CHUNK)
    phases = kernel_means(profiled_events(launch, "wkv6_"))
    fwd_ms = sum(phases.values()) if phases else event_ms(launch)

    def backward():
        # the body of ops._WKV6.backward: the plain scan under autograd
        xr = [x.detach().requires_grad_() for x in xs]
        return torch.autograd.grad(ref.wkv6(*xr), xr, gy)
    bwd_ms, bsrc = device_ms(backward, reps=3)
    bwd_wall = event_ms(backward, reps=3)
    b, by = wkv6_bound(BH, T, 64, 64, ops.WKV6_CHUNK)
    share = 100 * (2 * L * fwd_ms + L * bwd_ms) / max(busy, 1e-9)
    print(f"# wkv6 at a layer's shape [{BH}, {T}, 64] on {card}: forward "
          f"kernels {fwd_ms:.4f} ms a call (CUPTI: "
          f"{wkv6_phase_text(phases)}; bound {b:.4f} ms, {by}), plain "
          f"backward {bwd_ms:.3f} ms device a call ({bsrc}; {bwd_wall:.3f} "
          f"ms between events); a step runs {2 * L} forwards and {L} "
          f"backwards: {share:.1f}% of the profiled step's device busy")
    summary = (f"{ms:.1f} ms a step, {toks / (ms / 1e3):.0f} tokens/s "
               f"(batch {args.batch} x {args.seq}, {args.dtype}, remat "
               f"dots), peak {peak / 1e9:.3f} GB, device busy {busy:.1f} "
               f"ms of a profiled step's {prof_wall:.1f} (idle "
               f"{100 - 100 * busy / prof_wall:.1f}%), wkv6 forward {fwd_ms:.4f} ms x {2 * L} + plain "
               f"backward {bwd_ms:.3f} ms x {L} a step ({share:.1f}% of "
               "busy)")
    fields = {"train_launches_a_step": 2 * L, "train_forward_ms": fwd_ms,
              "train_plain_backward_ms": bwd_ms}
    del xs, gy, launch
    torch.cuda.empty_cache()
    print(f"# rwkv6-3b training phase: {time.time() - t_all:.1f}s")
    return {"train step": counts}, summary, fields


# the nine other LM families' training: launch/train.py's defaults at the
# published width, each at the deepest depth whose state fits
# LM_TRAIN_STATE_BYTES: (arch, layers: None for the published depth,
# the dtype of params and of AdamW's m and v)
LM_TRAIN = (
    ("whisper_small", None, "float32"),
    ("hymba_1_5b", 8, "float32"),                 # LM_TRAIN_TIME_CUT
    ("h2o_danube3_4b", 22, "float32"),
    ("gemma2_9b", 14, "float32"),                 # 7 of 21 local/global pairs
    ("deepseek_moe_16b", 6, "float32"),           # 1 dense + 5 of 27 MoE
    ("qwen2_72b", 1, "float32"),
    ("qwen2_vl_72b", 1, "float32"),
    ("llama3_405b", 1, "bfloat16"),               # the reference's 100B+ state
    ("deepseek_v2_236b", 2, "bfloat16"),          # 1 dense + 1 of 59 MoE
)
# depths cut for the smoke's time limit, not for memory (hymba's per-token
# Mamba loop makes its published-depth step the phase's longest)
LM_TRAIN_TIME_CUT = ("hymba_1_5b",)
LM_TRAIN_STATE_BYTES = 60e9     # params + grads + m + v, beside activations
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128            # the driver's defaults
# card against CPU at the published width: (arch, layers, batch, seq)
LM_TRAIN_WIDTH_CHECK = ("h2o_danube3_4b", 1, 2, 64)


def train_state_bytes(params, state_dtype) -> tuple[int, int]:
    """``(bytes of params + grads + m + v, the bytes one more entry of
    the cut stack would add)``: grads in each param's dtype, m and v in
    ``state_dtype``; an entry is a layer (gemma2: a local/global pair;
    moe: an MoE layer)."""
    from repro_torch.training import tree
    s = state_dtype.itemsize

    def per(t):
        return 2 * t.element_size() + 2 * s
    total = sum(t.numel() * per(t) for _, t in tree.leaves(params))
    entry = sum(t[0].numel() * per(t) for _, t in tree.leaves(
        params["layers"]))
    return total, entry


def train_probe_keys(params) -> list:
    """``embed`` and each stack's first ``attn/wo``, the MoE router and
    whisper's cross-attention ``wq``: a step that trains changes each."""
    from repro_torch.training import train_loop, tree
    keys = [k for k, _ in tree.leaves(params)]
    return ["embed"] + [
        next(k for k in keys if k.startswith(f"{s}/")
             and k.endswith("attn/wo"))
        for s in train_loop.STACKS if s in params] + [
        k for k in keys if k.endswith(("moe/router", "xattn/wq"))]


def train_probe(params, key, ids):
    """The ``ids`` rows of ``embed`` (token ids of the first batch: a row
    no batch reads moves by weight decay alone, below a bf16 ulp), or
    layer 0's first two rows of a stacked leaf."""
    from repro_torch.training import tree
    t = dict(tree.leaves(params))[key]
    return t[ids] if key == "embed" else t[0, :2]


def lm_train_phase(dev, card):
    """Phase 13b: training the nine other LM families. (a) One driver
    step on the card against the same step on the CPU at each config's
    ``reduced(...)`` [8, 128], and at h2o-danube3-4b's published width
    cut to one layer (``LM_TRAIN_WIDTH_CHECK``); (b) each of ``LM_TRAIN``
    at its published width and the depth printed (the deepest whose
    params, grads, m and v fit ``LM_TRAIN_STATE_BYTES``; llama3-405b and
    deepseek-v2-236b in bf16 with a bf16 AdamW state), ``TRAIN_STEPS``
    steps of ``launch/train.py``'s defaults (its ``setup`` where no cut
    is needed, its optimizer and ``synthetic_batch`` otherwise): gates
    finite loss and grad norm, params changed in every stack, 0 launches
    of the thirteen kernels; ms a step, tokens/s, peak memory, and one
    more step under CUPTI (device busy, idle, top items). Returns
    ``(launch counts by config, the summary by config)``."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch import configs
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import train
    from repro_torch.training import train_loop, tree
    t_all = time.time()
    print(f"# the nine other LM families' training on {card}")
    print("# (a) one driver step, card against CPU from the same weights:")
    def driver_args(arch, dtype_name="float32"):
        return train.parse_args([
            "--arch", arch, "--batch", str(LM_TRAIN_BATCH), "--seq",
            str(LM_TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--dtype",
            dtype_name, "--device", "cuda"])

    worst = 0.0
    for a, *_ in LM_TRAIN:
        ocfg = train.adamw_config(driver_args(a))
        rel, c = train_step_check(f"{a}, reduced", configs.reduced(
            configs.get_config(a)), ocfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)
        no_launches(c, f"{a} train step, reduced")
        worst = max(worst, rel)
    arch, layers, Bw, Tw = LM_TRAIN_WIDTH_CHECK
    width_rel, c = train_step_check(
        f"{arch}, published width cut to {layers} layer",
        lm_config(arch, layers), train.adamw_config(driver_args(arch)),
        Bw, Tw, dev)
    no_launches(c, f"{arch} train step, published width")
    counts, summary = {}, {}
    toks = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    for arch, layers, dtype_name in LM_TRAIN:
        t0 = time.time()
        full = configs.get_config(arch)
        cfg = lm_config(arch, layers)
        dtype = getattr(torch, dtype_name)
        args = driver_args(arch, dtype_name)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if layers is None and dtype_name == "float32":
            cfg, state, step_fn, _ = train.setup(args)
            how = "launch/train.py's setup"
        else:
            ocfg = dataclasses.replace(train.adamw_config(args),
                                       state_dtype=dtype)
            state = train_loop.init_train_state(
                cfg, torch.Generator(dev).manual_seed(0), dtype=dtype,
                opt_cfg=ocfg, device=dev)
            step_fn = train_loop.make_train_step(cfg, opt_cfg=ocfg)
            how = "train_loop with the driver's AdamW" + (
                f" (state_dtype {dtype_name})" if dtype_name != "float32"
                else "")
        torch.cuda.synchronize()
        n_par = sum(t.numel() for _, t in tree.leaves(state.params))
        need, entry = train_state_bytes(state.params, dtype)
        time_cut = arch in LM_TRAIN_TIME_CUT
        cut = "published depth" if layers is None else (
            f"CUT to {layers} of {full.n_layers} layers"
            + (" for the smoke's time limit" if time_cut else ""))
        fits_one_more = layers is not None and not time_cut and \
            need + entry <= LM_TRAIN_STATE_BYTES
        print(f"# {arch} training ({how}): {cut}, d_model {cfg.d_model}, "
              f"vocab {cfg.vocab}; {n_par} parameters in {dtype_name}, "
              f"params + grads + m + v {need / 1e9:.3f} GB (one more "
              f"{'pair' if cfg.layer_pattern == 'alt_local_global' else 'layer'}"
              f": {(need + entry) / 1e9:.3f} GB, budget "
              f"{LM_TRAIN_STATE_BYTES / 1e9:.0f} GB); set up in "
              f"{time.time() - t0:.1f}s")
        check(need <= LM_TRAIN_STATE_BYTES and not fits_one_more,
              f"{arch}: {need / 1e9:.3f} GB of state is not the deepest "
              f"cut under {LM_TRAIN_STATE_BYTES / 1e9:.0f} GB")
        first = train.synthetic_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, 0,
                                      device=dev)
        ids = first["tokens"][0, :2] if "tokens" in first else \
            torch.arange(2, device=dev)
        probes = {k: train_probe(state.params, k, ids).clone()
                  for k in train_probe_keys(state.params)}
        del first
        rows, c_all = [], {}
        for step in range(TRAIN_STEPS):
            batch = train.synthetic_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                          step, device=dev)
            kcuda.reset_launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            c = kcuda.launch_counts()
            c_all = {k: c_all.get(k, 0) + v for k, v in c.items()}
            gn = float(metrics["grad_norm"])
            rows.append((loss, gn, dt))
            print(f"  step {step}: loss {loss:.4f} gnorm {gn:.4f} lr "
                  f"{float(metrics['lr']):.3e} {dt * 1e3:.1f} ms "
                  f"({toks / dt:.0f} tok/s)")
            check(np.isfinite(loss) and np.isfinite(gn),
                  f"{arch} training step {step}: loss {loss}, gnorm {gn}")
            del batch, metrics
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        no_launches(c_all, f"{arch} training")
        counts[f"{arch} train step"] = c_all
        changed = {k: not torch.equal(v, train_probe(state.params, k, ids))
                   for k, v in probes.items()}
        check(all(changed.values()), f"{arch}: params unchanged after "
              f"training: {changed}")
        ms = 1e3 * statistics.mean(r[2] for r in rows[1:])
        batch = train.synthetic_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                      TRAIN_STEPS, device=dev)
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t1) * 1e3
        items = device_items(prof)
        busy = sum(t for _, t in items)
        idle = 100 - 100 * busy / prof_wall
        del state, metrics, batch, prof, probes
        torch.cuda.empty_cache()
        summary[arch] = (
            f"training {cut} ({n_par} parameters, {dtype_name}, state "
            f"{need / 1e9:.3f} GB): {ms:.1f} ms a step mean of steps "
            f"1-{TRAIN_STEPS - 1} ({toks / (ms / 1e3):.0f} tokens/s, "
            f"batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, remat dots), step 0 "
            f"{rows[0][2] * 1e3:.1f} ms, peak {peak / 1e9:.3f} GB, loss "
            f"{rows[0][0]:.4f} -> {rows[-1][0]:.4f}; a profiled step "
            f"{prof_wall:.1f} ms wall, device busy {busy:.1f} ms (idle "
            f"{idle:.1f}%, {len(items)} device activities); params changed "
            f"in {', '.join(changed)}; 0 kernel launches")
        print(f"# {arch} on {card}: {summary[arch]}")
        for name, t in top_items(items):
            print(f"    {t:9.3f} ms  {name[:100]}")
        print(f"# {arch} training: {time.time() - t0:.1f}s")
    summary["card against CPU"] = (
        f"a step at reduced(...) of all nine within rel {worst:.3e}, "
        f"{LM_TRAIN_WIDTH_CHECK[0]} at its published width cut to "
        f"{LM_TRAIN_WIDTH_CHECK[1]} layer rel {width_rel:.3e} (tolerance "
        f"{TRAIN_TOL})")
    print(f"# LM training phase: {time.time() - t_all:.1f}s")
    return counts, summary


# rwkv6-3b training over a mesh (phase 13c): launch/train.py's defaults at
# the published width, two ranks sharing the card over gloo, first as 1x2
# and then as 2x1, against the one-rank step
TRAIN_MESH_SHAPES = ((1, 2), (2, 1))
TRAIN_MESH_LAYERS = 1            # the depth cut (train_mesh_phase prints why)
TRAIN_MESH_BYTES = 60e9          # both ranks' state and steps together
TRAIN_MESH_TIMEOUT_S = 300       # the ranks' join
TRAIN_BATCH_TOKENS = 8 * 128     # TRAIN_ARGV's global batch x seq
# params, m and v against the plain one-rank step: the largest |diff| over
# the leaf's largest |value|, within the plain float32 step's own distance
# from the same step in float64 at this depth, seed and batch, rounded up
# (3.813e-3 / 7.956e-4 / 1.590e-3 on an H100: launch/float_witness.py)
TRAIN_MESH_TOL = {"params": 4e-3, "m": 1e-3, "v": 2e-3}


class CollectiveClock:
    """While entered, counts and times (host clock, the device
    synchronised before and after) every collective of a ``ModelAxis``
    past one rank: the mesh's gathers and sums. The synchronisations
    slow the step, so the step times are taken outside it."""

    def __enter__(self):
        import torch
        from repro_torch.core import engine
        self.n, self.s, self.bytes = 0, 0.0, 0
        self.saved = {name: getattr(engine.ModelAxis, name)
                      for name in ("_all_reduce", "all_gather")}
        for name, inner in self.saved.items():

            def timed(axis, x, *a, _inner=inner):
                if axis.size == 1:
                    return _inner(axis, x, *a)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _inner(axis, x, *a)
                torch.cuda.synchronize()
                self.n += 1
                self.s += time.perf_counter() - t0
                self.bytes += x.numel() * x.element_size()
                return out
            setattr(engine.ModelAxis, name, timed)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import engine
        for name, inner in self.saved.items():
            setattr(engine.ModelAxis, name, inner)


def train_mesh_bytes(cfg) -> tuple[int, int]:
    """``(both ranks' mesh steps, both ranks' one-rank steps)`` in bytes,
    reckoned from the meta-device state (``specs.state_specs``) in
    float32: a mesh rank holds the whole params and grads in a step and
    its half of params, m and v (12 bytes a parameter over two ranks);
    a one-rank step holds params, grads, m and v whole."""
    import torch
    from repro_torch.launch import specs
    from repro_torch.training import tree
    state, _ = specs.state_specs(cfg, dtype=torch.float32)
    n = sum(t.numel() for _, t in tree.leaves(state.params))
    return 2 * (8 * n + 6 * n), 2 * 16 * n


def errs_text(e: dict) -> str:
    return "; ".join(f"{n} {v[0]:.3e} of a leaf's max ({v[1]})"
                     for n, v in e.items())


def train_mesh_rank(workdir: Path) -> int:
    """One rank of phase 13c, started by ``train_mesh_phase`` with the
    environment ``torch.distributed.run`` gives its workers: join the
    world (``cuda:0``, ``gloo``), then on each of ``TRAIN_MESH_SHAPES``
    train rwkv6-3b at the job's depth for ``TRAIN_STEPS`` steps of
    ``launch/train.py``'s defaults from seed 0 (every rank draws the
    global batch, ``train_loop``'s mesh step keeps its rows), each step
    timed with the launch counts reset just before and read just after;
    keep its shards on the host, digest its gathered params, save a
    checkpoint at 2x1, profile one more step (CUPTI), and count and time
    the collectives of one more (``CollectiveClock``). Then restore the
    2x1 checkpoint at 1x2 and take the next step; then, outside any
    mesh, the one-rank steps from the same seed in each mesh's float
    order (``--accum`` the mesh's data ranks: microbatches whose
    gradients are summed as the data ranks' are; at 1 the plain step),
    each mesh's shards held against them and against the plain step,
    and the checkpoint restored on one rank with its next step. Saves
    the results under ``workdir``."""
    import hashlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import float_witness, mesh as meshlib
    from repro_torch.launch import sharding, train
    from repro_torch.training import checkpoint, train_loop, tree
    w = meshlib.init_from_env("cuda", timeout_s=120)
    try:
        job = torch.load(workdir / "job.pt", weights_only=False)
        dev = w.device
        cfg = dataclasses.replace(configs.get_config("rwkv6_3b"),
                                  n_layers=job["layers"])
        args = train.parse_args(list(TRAIN_ARGV) +
                                ["--steps", str(TRAIN_STEPS)])
        ocfg = train.adamw_config(args)
        meshes = {s: meshlib.make_debug_mesh(*s, device=dev)
                  for s in TRAIN_MESH_SHAPES}
        specs = {s: sharding.state_shardings(cfg, m)
                 for s, m in meshes.items()}
        batches = [train.synthetic_batch(cfg, args.batch, args.seq, s,
                                         device=dev)
                   for s in range(TRAIN_STEPS + 2)]
        ckpt = str(workdir / "ckpt")
        out = dict(rank=w.rank, device=str(dev), backend=w.backend,
                   meshes={})
        shards = {}

        def fresh(shape=None):
            return train_loop.init_train_state(
                cfg, torch.Generator(dev).manual_seed(0),
                dtype=torch.float32, opt_cfg=ocfg, device=dev,
                mesh=meshes.get(shape), specs=specs.get(shape))

        def steps(state, step):
            rows = []
            for b in batches[:TRAIN_STEPS]:
                state, m = step(state, b)
                rows.append(dict(loss=float(m["loss"]),
                                 gnorm=float(m["grad_norm"])))
            return state, rows

        for shape in TRAIN_MESH_SHAPES:
            mesh = meshes[shape]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = fresh(shape)
            step = train_loop.make_train_step(cfg, opt_cfg=ocfg, mesh=mesh,
                                              specs=specs[shape])
            rows = []
            for s in range(TRAIN_STEPS):
                kcuda.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batches[s])
                loss = float(m["loss"])
                torch.cuda.synchronize()
                rows.append(dict(
                    loss=loss, gnorm=float(m["grad_norm"]),
                    s=time.perf_counter() - t0,
                    launches=kcuda.launch_counts()))
                print(f"# rank {w.rank}: {shape[0]}x{shape[1]} step {s}: "
                      f"loss {loss:.6f} {rows[-1]['s'] * 1e3:.1f} ms",
                      flush=True)
            peak = torch.cuda.max_memory_allocated()
            shards[shape] = {k: x.to("cpu", copy=True)
                             for k, x in tree.leaves(state)}
            digest = hashlib.sha1()
            whole = sharding.gather_tree(state.params, specs[shape].params,
                                         mesh)
            for _, x in tree.leaves(whole):
                digest.update(x.cpu().numpy().tobytes())
            del whole
            if shape == (2, 1):
                checkpoint.save(ckpt, TRAIN_STEPS - 1, state, mesh=mesh,
                                specs=specs[shape])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, m = step(state, batches[TRAIN_STEPS])
                next_loss = float(m["loss"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy = sum(e.time_range.elapsed_us()
                       for e in cuda_events(prof)) / 1e3
            with CollectiveClock() as clock:
                state, m = step(state, batches[TRAIN_STEPS + 1])
                float(m["loss"])
            out["meshes"][shape] = dict(
                rows=rows, peak=peak, digest=digest.hexdigest(),
                next_loss=next_loss, profiled_ms=wall * 1e3, busy_ms=busy,
                collectives=clock.n, collective_s=clock.s,
                collective_bytes=clock.bytes)
            del state, m, step, prof
        torch.cuda.empty_cache()

        # the 2x1 checkpoint at 1x2, and its next step
        state, _ = checkpoint.restore(ckpt, fresh((1, 2)), mesh=meshes[
            (1, 2)], specs=specs[(1, 2)])
        state, m = train_loop.make_train_step(
            cfg, opt_cfg=ocfg, mesh=meshes[(1, 2)], specs=specs[(1, 2)])(
            state, batches[TRAIN_STEPS])
        out["restored_1x2"] = float(m["loss"])
        del state, m
        torch.cuda.empty_cache()
        torch.distributed.barrier()

        # one rank, outside the mesh: the steps in each mesh's float order
        # (--accum n_data) and the plain step, each mesh's shards held
        # against both; the checkpoint restored on one rank
        out["errs"], out["same"], out["one_rank"] = {}, {}, {}
        for nd in sorted({shape[0] for shape in TRAIN_MESH_SHAPES},
                         reverse=True):
            state, out["one_rank"][nd] = steps(
                fresh(), train_loop.make_train_step(
                    cfg, opt_cfg=ocfg, accum_steps=nd))
            for shape, mesh in meshes.items():
                spec = dict(tree.leaves(specs[shape]))

                def cut(key, x):
                    return sharding.shard_leaf(x, spec[key], mesh)
                if shape[0] == nd:
                    out["same"][shape] = all(
                        torch.equal(shards[shape][key].to(dev), cut(key, x))
                        for key, x in tree.leaves(state)) and all(
                        (r["loss"], r["gnorm"]) == (g["loss"], g["gnorm"])
                        for r, g in zip(out["one_rank"][nd],
                                        out["meshes"][shape]["rows"]))
                if nd == 1:
                    out["errs"][shape] = float_witness.leaf_errs(
                        shards[shape], dict(tree.leaves(state)), cut)
            del state
        step = train_loop.make_train_step(cfg, opt_cfg=ocfg)
        state, _ = checkpoint.restore(ckpt, fresh())
        state, m = step(state, batches[TRAIN_STEPS])
        out["restored_one"] = float(m["loss"])
        torch.save(out, workdir / f"rank{w.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def train_mesh_phase(dev, card):
    """Phase 13c: rwkv6-3b training over a mesh. Two ranks of this
    script (``train_mesh_rank``) share ``cuda:0`` over ``gloo`` and train
    at the published width cut to ``TRAIN_MESH_LAYERS`` layer (within
    ``TRAIN_MESH_BYTES`` for both ranks and within the phase's time),
    on a 1x2 and then a 2x1 mesh.
    Gates: both ranks exit 0; each mesh's loss and grad norm every step
    within ``TRAIN_TOL`` relative of the plain one-rank step's, and its
    params, m and v within ``TRAIN_MESH_TOL`` of each leaf's largest
    value (the plain float32 step's own distance from float64); each
    mesh's state and metrics equal bit for bit to the one-rank steps in
    its float order (``--accum`` its data ranks: 1x2 the plain step,
    2x1 two microbatches, through the accumulation path, which shares
    nothing with the mesh's data split); both ranks' gathered params
    equal bit for bit; 2 x depth ``wkv6``
    launches a step on every rank; the 2x1 checkpoint restored at 1x2
    and on one rank gives the 2x1 mesh's next loss. Returns ``(launch
    counts by path, summed over the ranks; the summary; the wkv6 row's
    fields)``."""
    import torch
    from repro_torch import configs
    t_all = time.time()
    L = TRAIN_MESH_LAYERS
    full = configs.get_config("rwkv6_3b")
    cfg = dataclasses.replace(full, n_layers=L)
    mesh_b, one_b = train_mesh_bytes(cfg)
    fits = max(n for n in range(1, full.n_layers + 1) if max(
        train_mesh_bytes(dataclasses.replace(full, n_layers=n)))
        <= TRAIN_MESH_BYTES)
    print(f"# rwkv6-3b training over a mesh on {card}: CUT to {L} of "
          f"{full.n_layers} layers (published width: d_model "
          f"{full.d_model}, {full.n_heads} heads, vocab {full.vocab}); "
          f"reckoned for two ranks on the one card: mesh steps "
          f"{mesh_b / 1e9:.2f} GB, one-rank steps {one_b / 1e9:.2f} GB "
          f"beside activations (limit {TRAIN_MESH_BYTES / 1e9:.0f} GB: "
          f"{fits} layers would fit). The cut is the phase's time: every "
          "step gathers the params and sums the gradients through the "
          "host, and 1 layer takes most of the phase's 150 s; past it the "
          "float32 gradient itself drifts from float64 by percents "
          "(launch/float_witness.py; PERF.md, PR 33)")
    check(max(mesh_b, one_b) <= TRAIN_MESH_BYTES,
          f"train mesh: {max(mesh_b, one_b)} bytes reckoned")
    torch.cuda.empty_cache()
    run = MeshRun({"layers": L}, "--train-mesh-rank", 2,
                  TRAIN_MESH_TIMEOUT_S)
    failed, logs, wall, outs = run.join()
    for r, (rc, text) in enumerate(logs):
        print("\n".join(ln for ln in text.splitlines()
                        if ln.startswith("#")))
        if failed:
            print(f"# rank {r} exited {rc}; its log's end:\n{text[-4000:]}")
    check(failed is None, f"train mesh: {failed}")
    counts, texts = {}, []
    for shape in TRAIN_MESH_SHAPES:
        label = f"{shape[0]}x{shape[1]}"
        path = f"train mesh {label}"
        per_rank = []
        for o in outs:
            r, got = o["rank"], o["meshes"][shape]
            check(o["backend"] == "gloo" and o["device"] == "cuda:0",
                  f"train mesh rank {r} on {o['device']} over "
                  f"{o['backend']}")
            order = "the plain step" if shape[0] == 1 else \
                f"the --accum {shape[0]} step"
            check(o["same"][shape], f"train mesh {label} rank {r}: the "
                  f"state or metrics differ from {order}'s bits")
            for s, (row, ref) in enumerate(zip(got["rows"],
                                               o["one_rank"][1])):
                rel = max(abs(row[k] - ref[k]) / abs(ref[k])
                          for k in ("loss", "gnorm"))
                check(rel <= TRAIN_TOL, f"train mesh {label} rank {r} step "
                      f"{s}: loss/gnorm rel {rel} against one rank")
                check(row["launches"]["wkv6"] == 2 * L,
                      f"train mesh {label} rank {r} step {s}: "
                      f"{row['launches']['wkv6']} wkv6 launches, not "
                      f"2 x {L}")
                counts[path] = {k: counts.get(path, {}).get(k, 0) + v
                                for k, v in row["launches"].items()}
            errs = o["errs"][shape]
            for n, e in errs.items():
                check(e[0] <= TRAIN_MESH_TOL[n], f"train mesh {label} rank "
                      f"{r}: {n} {e[0]:.3e} of {e[1]}'s max against the "
                      f"plain step (bound {TRAIN_MESH_TOL[n]})")
            rel = max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(
                got["rows"], o["one_rank"][1]) for k in ("loss", "gnorm"))
            print(f"# train mesh {label} rank {r}: params, m, v, loss and "
                  f"grad norm equal bit for bit to {order} on one rank; "
                  f"against the plain step: loss/gnorm rel {rel:.3e} "
                  f"(bound {TRAIN_TOL}); " + errs_text(errs) + " (bounds "
                  + " / ".join(f"{v:g}" for v in TRAIN_MESH_TOL.values())
                  + ")")
            steady = got["rows"][1:]
            ms = 1e3 * statistics.mean(x["s"] for x in steady)
            coll_ms = 1e3 * got["collective_s"] / max(got["collectives"], 1)
            idle = 100 - 100 * got["busy_ms"] / got["profiled_ms"]
            print(f"# train mesh {label} rank {r}: {ms:.1f} ms a step (mean "
                  f"of steps 1-{TRAIN_STEPS - 1}; "
                  f"{TRAIN_BATCH_TOKENS / (ms / 1e3):.0f} tokens/s of the "
                  f"global batch); one more step with its collectives "
                  f"clocked: {got['collectives']} collectives "
                  f"({got['collective_bytes'] / 1e9:.3f} GB) at "
                  f"{coll_ms:.2f} ms each (host clock, the device "
                  f"synchronised around each; gloo through the host); peak "
                  f"{got['peak'] / 1e9:.3f} GB "
                  f"(torch.cuda.max_memory_allocated of the rank); a "
                  f"profiled step {got['profiled_ms']:.1f} ms with device "
                  f"busy {got['busy_ms']:.1f} ms (idle {idle:.1f}%); wkv6 "
                  f"launches a step {got['rows'][0]['launches']['wkv6']}")
            per_rank.append(f"rank {r} {ms:.1f} ms a step, "
                            f"{TRAIN_BATCH_TOKENS / (ms / 1e3):.0f} "
                            f"tokens/s, {got['collectives']} collectives at "
                            f"{coll_ms:.2f} ms, peak "
                            f"{got['peak'] / 1e9:.3f} GB, idle {idle:.1f}%")
        digests = [o["meshes"][shape]["digest"] for o in outs]
        check(all(d == digests[0] for d in digests),
              f"train mesh {label}: the ranks' gathered params differ")
        texts.append(f"{label}: " + "; ".join(per_rank))
    nexts = {"2x1 mesh": outs[0]["meshes"][(2, 1)]["next_loss"]}
    for o in outs:
        nexts[f"restored at 1x2 (rank {o['rank']})"] = o["restored_1x2"]
        nexts[f"restored on one rank (rank {o['rank']})"] = \
            o["restored_one"]
    want = nexts["2x1 mesh"]
    for what, v in nexts.items():
        check(abs(v - want) <= TRAIN_TOL * abs(want),
              f"train mesh checkpoint: next loss {what} {v} against the "
              f"2x1 mesh's {want}")
    print("# train mesh checkpoint (written at 2x1 after step "
          f"{TRAIN_STEPS - 1}): next loss " + ", ".join(
              f"{k} {v:.6f}" for k, v in nexts.items())
          + f" (tolerance {TRAIN_TOL} relative); both ranks' gathered "
          "params equal bit for bit on each mesh")
    summary = (f"{L} of {full.n_layers} layers, two ranks on one card "
               f"over gloo (every collective through the host; no "
               f"multi-GPU rate): " + " | ".join(texts))
    print(f"# rwkv6-3b training over a mesh on {card}: {summary}")
    print(f"# train mesh phase: {time.time() - t_all:.1f}s ({wall:.1f} s "
          "of ranks)")
    return counts, summary, {"train_mesh_launches_a_step": 2 * L}


# the LM serving paths: the seven GQA families (dense x5, hybrid,
# encdec), then the moe pair
LM_SLOTS = 32768                         # decode_32k's context
LM_DECODE_PROMPT, LM_DECODE_TOKENS = 16, 32
LM_MARGIN = 6e9                          # bytes kept free for activations
# (arch, layers: None for the published depth, prefill shapes to try in
# order (the first whose reckoned peak fits runs), decode batch wanted)
# gemma2-9b, h2o-danube3-4b, hymba-1.5b and deepseek-moe-16b are cut in
# depth for the smoke's time limit (at their published depth the whole
# smoke ran 1,152.6 s of 1,200 on an H100 80GB HBM3 at 700 W); the
# others' bf16 weights do not fit one card
LM_SERVE = (
    ("gemma2_9b", 14, ((1, 32768), (1, 16384)), 8),
    ("h2o_danube3_4b", 8, ((1, 32768),), 128),
    ("hymba_1_5b", 8, ((1, 2048),), 128),
    ("whisper_small", None, ((8, 448),), 8),
    ("llama3_405b", 2, ((1, 4096),), 8),
    ("qwen2_72b", 2, ((1, 4096),), 8),
    ("qwen2_vl_72b", 2, ((1, 4096),), 8),
    ("deepseek_moe_16b", 6, ((1, 32768), (1, 16384)), 8),
    ("deepseek_v2_236b", 2, ((1, 4096),), 8),
)
LM_CHECK_BATCH, LM_CHECK_PROMPT = 2, 64  # decode vs forward, f32, 2 layers


def lm_config(arch: str, layers):
    """The published config, its depth cut to ``layers`` when given
    (whisper's encoder too; gemma2's pairs: ``layers`` is then 2, one
    local/global pair)."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    if layers is None:
        return cfg
    cut = {"n_layers": layers}
    if cfg.family == "encdec":
        cut["n_enc_layers"] = layers
    return dataclasses.replace(cfg, **cut)


def moe_transient_bytes(cfg, T: int) -> int:
    """Bytes (bf16) of ``moe_ffn``'s transients at ``T`` tokens and the
    published capacity: the ``[E, C, d]`` buffer and expert outputs, the
    three ``[E, C, de]`` hidden tensors, the three ``[T·k, d]`` row
    gathers (the dispatch's, the combine's and its weighted copy)."""
    from repro_torch.models import moe
    if cfg.family != "moe":
        return 0
    C = moe.capacity(cfg, T)
    E, k, d, de = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_expert
    return 2 * (2 * E * C * d + 3 * E * C * de + 3 * T * k * d)


@contextlib.contextmanager
def moe_stats_recorded():
    """A list that collects the ``MoEStats`` of every ``moe_ffn`` call in
    the block (``transformer.forward`` drops them, as the reference's
    does): ``moe.moe_ffn`` is wrapped for the block's duration."""
    from repro_torch.models import moe
    plain, stats = moe.moe_ffn, []

    def recorded(*args, **kwargs):
        out, st = plain(*args, **kwargs)
        stats.append(st)
        return out, st
    moe.moe_ffn = recorded
    try:
        yield stats
    finally:
        moe.moe_ffn = plain


def moe_stats_text(cfg, stats, T: int) -> str:
    """Each MoE layer's dropped pairs and expert load (printed), and
    their spread over the layers (returned)."""
    from repro_torch.models import moe
    C = moe.capacity(cfg, T)
    dropped, ratios = [], []
    for i, st in enumerate(stats):
        load = st.load.to("cpu")
        dropped.append(100 * float(st.dropped_frac))
        mean = T * cfg.top_k / cfg.n_experts
        ratios.append(int(load.max()) / mean)
        print(f"    MoE layer {cfg.n_dense_layers + i}: dropped "
              f"{dropped[-1]:.3f}% of {T * cfg.top_k} pairs, load max "
              f"{int(load.max())} / mean {mean:.1f} / min "
              f"{int(load.min())} (capacity C {C})")
    return (f"{len(stats)} MoE layers at capacity factor "
            f"{cfg.capacity_factor} (C {C}): dropped {min(dropped):.3f}–"
            f"{max(dropped):.3f}% of pairs, max load {min(ratios):.2f}–"
            f"{max(ratios):.2f}x the mean")


def lm_batch(cfg, B: int, S: int, gen, dev, dtype) -> dict:
    """A prefill batch: tokens, or qwen2-vl's stubbed ``embeds``, plus
    whisper's ``frames [B, enc_seq, d]``, drawn on the card."""
    import torch
    out = {}
    if cfg.frontend == "vision":
        out["embeds"] = torch.randn((B, S, cfg.d_model), generator=gen,
                                    device=dev).to(dtype)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                      device=dev)
    if cfg.family == "encdec":
        out["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model),
                                    generator=gen, device=dev).to(dtype)
    return out


def fill_cross(cfg, params, frames, cache):
    """Whisper's serving preparation, the copy of the reference's test
    helper ``encode_and_fill_cross`` (``tests/test_archs.py``): the
    encoder on ``frames``, each decoder layer's cross k/v written into
    ``cache["xk"]`` / ``cache["xv"]``."""
    import torch
    from repro_torch.models import transformer as tf
    with torch.no_grad():
        enc = tf.encode(cfg, params, frames)
        for i in range(cfg.n_layers):
            k, v = tf.cross_heads(cfg, tf.layer(params, i)["xattn"], enc)
            cache["xk"][i].copy_(k)
            cache["xv"][i].copy_(v)
    return cache


def device_items(prof) -> list:
    """``(name, ms)`` of each device activity of a profile, read from
    the profiler's raw (kineto) events: a forward of ~400K activities
    takes ~1 s there where ``prof.events()`` (``cuda_events``), which
    parses the whole trace, takes ~65 s."""
    from torch.autograd import DeviceType
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        return [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in cuda_events(prof)]
    return [(e.name(), e.duration_ns() / 1e6) for e in raw
            if e.device_type() == DeviceType.CUDA]


def cast_device_ms(prof, layer_shapes: list) -> float:
    """Device ms of a CPU + CUDA profile charged to the float32 casts
    (``aten::_to_copy``) of tensors shaped as ``layer_shapes``: one
    layer of a decode cache (``decode_attention``'s reads of it)."""
    return sum(e.device_time_total / 1e3 for e in prof.events()
               if e.name == "aten::_to_copy" and e.input_shapes
               and e.input_shapes[0] in layer_shapes)


def top_items(items, n: int = 5) -> list:
    by: dict = {}
    for name, ms in items:
        by[name] = by.get(name, 0.0) + ms
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def no_launches(counts: dict, what: str) -> None:
    check(not any(counts.values()), f"{what} launched kernels of "
          f"kernels/csrc: { {n: c for n, c in counts.items() if c} }")


def lm_prefill(cfg, params, shapes, gen, dev, card, label, profile=True):
    """Prefill ``forward`` at the first of ``shapes`` whose reckoned
    peak (weights, the [B, S, vocab] logits thrice: softcap's two
    temporaries, the MoE block's transients, then margin) fits the card;
    launch counts reset and read around one forward (no kernel of the
    thirteen), finite logits, each MoE layer's stats; tokens/s on the
    host clock over that forward (after a [1, 256] warm-up), device ms
    of one more (CUPTI), peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.serving import kvcache
    from repro_torch.models import transformer as tf
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    w = kvcache.cache_bytes(params)
    for Bp, Sp in shapes:
        peak = (w + 3 * Bp * Sp * cfg.vocab_padded * 2
                + moe_transient_bytes(cfg, Bp * Sp) + LM_MARGIN)
        fits = peak <= total
        print(f"# {label}: prefill [{Bp}, {Sp}] reckoned peak "
              f"{peak / 1e9:.1f} GB of the card's {total / 1e9:.1f} GB: "
              f"{'runs' if fits else 'does not fit'}")
        if fits:
            break
    b = lm_batch(cfg, Bp, Sp, gen, dev, params["embed"].dtype)
    with torch.no_grad():
        def run():
            return tf.forward(cfg, params, b)
        # a short warm-up (kernel and cuBLAS set-up), then one counted
        # and timed forward, then one profiled
        tf.forward(cfg, params, lm_batch(cfg, 1, 256, gen, dev,
                                         params["embed"].dtype))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kcuda.reset_launch_counts()
        with moe_stats_recorded() as stats:
            t0 = time.perf_counter()
            logits = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = kcuda.launch_counts()
        peak_got = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        del logits
        busy, ev = None, []
        if profile:
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev = device_items(prof)
            busy = sum(ms for _, ms in ev)
            t_prof = time.perf_counter() - t0
    del b
    no_launches(counts, f"{label} prefill")
    check(finite, f"{label} prefill: logits not finite")
    check(shape == (Bp, Sp, cfg.vocab_padded), f"{label} prefill: {shape}")
    dev_txt = (f"device {busy:.1f} ms a forward "
               f"({100 * busy / (wall * 1e3):.1f}% of the wall; {len(ev)} "
               f"device activities, read in {t_prof:.1f}s)"
               if busy is not None else
               "device time not profiled (the per-token Mamba loop makes "
               f"~{Sp * cfg.n_layers * 8} launches a forward)")
    text = (f"prefill [{Bp}, {Sp}]: {Bp * Sp / wall:.0f} tokens/s, "
            f"{wall * 1e3:.1f} ms wall, "
            f"{dev_txt}, peak {peak_got / 1e9:.3f} GB, 0 kernel launches")
    if cfg.family == "moe":
        check(len(stats) == cfg.n_layers - cfg.n_dense_layers,
              f"{label} prefill: {len(stats)} MoE layers ran")
        text += "; " + moe_stats_text(cfg, stats, Bp * Sp)
    print(f"# {label} on {card}: {text}")
    for name, ms in top_items(ev):
        print(f"    {ms:9.3f} ms  {name[:100]}")
    return text, counts


def lm_decode(cfg, params, B_want, gen, dev, card, label):
    """Greedy decode against a ``LM_SLOTS``-slot cache (O(window) for
    swa): the batch cut by halves from ``B_want`` until the weights, two
    caches (a step returns a new cache and keeps the one it was given)
    and a margin fit the card; ``LM_DECODE_PROMPT`` prompt tokens then
    ``LM_DECODE_TOKENS`` greedy steps with launch counts reset and read
    around them (none of the thirteen), finite logits, ``pos``; tokens/s,
    a profiled step's wall against device busy, the cache copy's share
    (the clones of the k/v stacks, timed alone) and the caches' float32
    casts' (one more step profiled with its host ops), the moe family's
    per-row gather of its experts' weights (one MoE layer's, timed
    alone), peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.serving import decode, kvcache
    from repro_torch.training import tree
    # the prefill's freed logits blocks stay reserved: give them back, or
    # the caches' large blocks find no room
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    w = kvcache.cache_bytes(params)
    one = kvcache.cache_bytes(kvcache.make_cache(cfg, 1, LM_SLOTS,
                                                 device=dev)) - 4
    B = B_want
    while B > 1 and w + 2 * B * one + LM_MARGIN > total:
        B //= 2
    cut = "" if B == B_want else (
        f"; CUT: batch {B}, not {B_want}: two caches of "
        f"{B_want * one / 1e9:.1f} GB and {w / 1e9:.1f} GB of weights "
        f"pass the card's {total / 1e9:.1f} GB")
    print(f"# {label}: decode at batch {B} against {LM_SLOTS} slots, cache "
          f"{B * one / 1e9:.3f} GB (reckoned peak "
          f"{(w + 2 * B * one) / 1e9:.1f} GB with two caches){cut}")
    cache = kvcache.make_cache(cfg, B, LM_SLOTS, device=dev)
    if cfg.family == "encdec":
        frames = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen,
                             device=dev).to(params["embed"].dtype)
        cache = fill_cross(cfg, params, frames, cache)
        del frames
    prompt = torch.randint(0, cfg.vocab, (B, LM_DECODE_PROMPT),
                           generator=gen, device=dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kcuda.reset_launch_counts()
        t0 = time.perf_counter()
        # token by token here, not through prefill_via_decode: a caller
        # holding the first cache would keep a third cache alive
        for t in range(LM_DECODE_PROMPT):
            logits, cache = decode.decode_step(cfg, params, cache,
                                               prompt[:, t:t + 1])
        torch.cuda.synchronize()
        t_prompt = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        t0 = time.perf_counter()
        for _ in range(LM_DECODE_TOKENS):
            tok = logits.argmax(-1, keepdim=True)
            logits, cache = decode.decode_step(cfg, params, cache, tok)
            finite &= bool(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        counts = kcuda.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        pos = int(cache["pos"])
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, nxt = decode.decode_step(cfg, params, cache, tok)
            torch.cuda.synchronize()
            step_wall = (time.perf_counter() - t0) * 1e3
        del nxt
        # one more step with the host ops recorded, to charge device time
        # to the float32 casts of the caches in decode_attention
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      record_shapes=True) as prof_ops:
            _, nxt = decode.decode_step(cfg, params, cache, tok)
            torch.cuda.synchronize()
        del nxt
        # the step's copy of its k/v stacks, alone between CUDA events
        # (CUPTI records these multi-GB clones incompletely or not at
        # all): the room it takes is the step's second cache
        stacks = {k: cache[k] for k in ("k", "v", "local", "global",
                                        "dense", "ckv", "krope")
                  if k in cache}
        copy = event_ms(lambda: [t.clone() for _, t in
                                 tree.leaves(stacks)], reps=3)
        gather = moe_gather(cfg, params, B, dev)
    no_launches(counts, f"{label} decode")
    check(finite, f"{label} decode: logits not finite")
    check(pos == LM_DECODE_PROMPT + LM_DECODE_TOKENS,
          f"{label} decode: cache pos {pos}")
    ev = device_items(prof)
    busy = sum(ms for _, ms in ev)
    copied = kvcache.cache_bytes(stacks)
    casts = cast_device_ms(prof_ops, [list(t.shape[1:]) for _, t in
                                      tree.leaves(stacks)])
    text = (f"decode at batch {B}: {B * LM_DECODE_TOKENS / t_dec:.0f} "
            f"tokens/s over {LM_DECODE_TOKENS} greedy steps "
            f"({1e3 * t_dec / LM_DECODE_TOKENS:.2f} ms a step, host clock "
            f"to a synchronize; the {LM_DECODE_PROMPT}-token prompt "
            f"{t_prompt:.2f}s); a profiled step {step_wall:.2f} ms wall, "
            f"device busy {busy:.3f} ms (idle "
            f"{100 - 100 * busy / step_wall:.1f}%), the cache copy "
            f"{copy:.3f} ms between events ({100 * copy / step_wall:.1f}% "
            f"of the step's wall; {copied / 1e9:.3f} GB copied, bound "
            f"{2 * copied / HBM_BYTES_PER_S * 1e3:.3f} ms), "
            f"the caches' float32 casts {casts:.3f} ms "
            f"({100 * casts / max(busy, 1e-9):.1f}% of busy), "
            f"peak {peak / 1e9:.3f} GB, 0 kernel launches{cut}")
    if gather is not None:
        g_ms, g_bytes, n_moe = gather
        text += (f"; the experts' weight gather {g_ms:.3f} ms a MoE layer "
                 f"between events x {n_moe} layers "
                 f"({100 * g_ms * n_moe / step_wall:.1f}% of the step's "
                 f"wall; {g_bytes / 1e9:.3f} GB gathered a layer, bound "
                 f"{2 * g_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms)")
    print(f"# {label} on {card}: {text}")
    for name, ms in top_items(ev):
        print(f"    {ms:9.3f} ms  {name[:100]}")
    del cache, logits
    return text, counts


def moe_gather(cfg, params, B: int, dev):
    """Decode's gather of each row's k experts' weights (``_moe1``:
    ``[B, k, d, de]`` a weight) for one MoE layer, alone between CUDA
    events, on distinct random experts a row: ``(ms, bytes gathered,
    MoE layers a step)``, or None outside the moe family."""
    import torch
    from repro_torch.models import transformer as tf
    if cfg.family != "moe":
        return None
    lp = tf.layer(params, 0)["moe"]
    ids = torch.rand((B, cfg.n_experts), device=dev).argsort(-1)[
        :, :cfg.top_k]
    ms = event_ms(lambda: [lp[n][ids] for n in ("wi", "wg", "wo")], reps=5)
    n_bytes = 3 * B * cfg.top_k * cfg.d_model * cfg.d_expert * \
        lp["wi"].element_size()
    return ms, n_bytes, tf.depth(params)


def lm_decode_check(arch, gen, dev, card) -> str:
    """Decode against forward at the published width cut to 2 layers
    (one local/global pair for gemma2; one dense and one MoE layer for
    the moe pair, at the reference test's drop-free capacity
    ``capacity_factor = n_experts``), f32 weights (TF32 off): a prompt
    of ``LM_CHECK_PROMPT`` tokens past the window for the windowed
    configs (so the rings wrap), else ``LM_CHECK_PROMPT``, decoded token
    by token against forward's last position (rel < 2e-2, argmax
    equal)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import decode, kvcache
    cfg = lm_config(arch, 2)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    S = cfg.window + LM_CHECK_PROMPT if cfg.window else LM_CHECK_PROMPT
    t0 = time.time()
    p32 = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    toks = torch.randint(0, cfg.vocab, (LM_CHECK_BATCH, S), generator=gen,
                         device=dev)
    fb = {"tokens": toks}
    if cfg.family == "encdec":
        fb["frames"] = torch.randn((LM_CHECK_BATCH, cfg.enc_seq, cfg.d_model),
                                   generator=gen, device=dev)
    with torch.no_grad():
        fwd = tf.forward(cfg, p32, fb)[:, -1].clone()
        cache = kvcache.make_cache(cfg, LM_CHECK_BATCH, S,
                                   dtype=torch.float32, device=dev)
        if cfg.family == "encdec":
            cache = fill_cross(cfg, p32, fb["frames"], cache)
        last, cache = decode.prefill_via_decode(cfg, p32, cache, toks)
    torch.cuda.synchronize()
    rel = float((last - fwd).abs().max()) / (float(fwd.abs().max()) + 1e-9)
    same = int((last.argmax(-1) == fwd.argmax(-1)).sum())
    text = (f"decode vs forward (f32, 2 layers, [{LM_CHECK_BATCH}, {S}] "
            f"prompt{', drop-free capacity' if cfg.family == 'moe' else ''}"
            f"): rel {rel:.3e}, argmax equal on {same}/"
            f"{LM_CHECK_BATCH} rows ({time.time() - t0:.1f}s)")
    print(f"# {arch} on {card}: {text}")
    check(rel < 2e-2, f"{arch}: decode diverges from forward: rel {rel}")
    check(same == LM_CHECK_BATCH, f"{arch}: decode's argmax differs from "
          f"forward's on {LM_CHECK_BATCH - same} rows")
    del p32, cache, fb
    torch.cuda.empty_cache()
    return text


def lm_phase(dev, card):
    """Phase 14: the LM serving paths on the card (``LM_SERVE``): the
    seven GQA families, then the moe pair, each model from
    ``init_params`` in bf16 (``torch.Generator`` seed 0, on the card) at
    its published width and the depth ``LM_SERVE`` gives (whisper-small
    at its published depth; gemma2-9b, h2o-danube3-4b, hymba-1.5b and
    deepseek-moe-16b cut for the smoke's time limit; llama3-405b,
    qwen2-72b, qwen2-vl-72b and deepseek-v2-236b cut to 2 layers: their
    bf16 weights do not fit one card), prefill
    (``lm_prefill``) and greedy decode (``lm_decode``), then each
    config's decode against its forward in f32 at 2 layers
    (``lm_decode_check``). Returns ``(launch counts by path, the
    summary)``."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import kvcache
    from repro_torch.training import tree
    t_all = time.time()
    gen = torch.Generator(device=dev).manual_seed(2)
    counts, summary = {}, {}
    for arch, layers, shapes, B_dec in LM_SERVE:
        t0 = time.time()
        cfg = lm_config(arch, layers)
        params = tf.init_params(cfg,
                                torch.Generator(device=dev).manual_seed(0),
                                dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        n_par = sum(t.numel() for _, t in tree.leaves(params))
        depth = (f"{cfg.n_layers} layers" if layers is None else
                 f"CUT to {layers} layers of {lm_config(arch, None).n_layers}")
        if cfg.family == "moe":
            depth += (f" ({cfg.n_dense_layers} dense, "
                      f"{cfg.n_layers - cfg.n_dense_layers} MoE: "
                      f"{cfg.n_experts} experts of {cfg.d_expert}, top "
                      f"{cfg.top_k}, {cfg.n_shared_experts} shared"
                      + (f"; MLA kv_lora {cfg.kv_lora}, q_lora "
                         f"{cfg.q_lora}, rope {cfg.rope_head_dim}"
                         if cfg.use_mla else "") + ")")
        print(f"# {arch} ({cfg.family}, {cfg.layer_pattern}"
              f"{f', window {cfg.window}' if cfg.window else ''}): "
              f"{depth}, d_model {cfg.d_model}, {cfg.n_heads} heads / "
              f"{cfg.n_kv_heads} KV of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab}; {n_par} parameters (config n_params "
              f"{cfg.n_params()}), {kvcache.cache_bytes(params) / 1e9:.3f} "
              f"GB bf16 on the card, drawn in {time.time() - t0:.1f}s")
        t1 = time.time()
        pre, counts[f"{arch} prefill"] = lm_prefill(
            cfg, params, shapes, gen, dev, card, arch,
            profile=cfg.family != "hybrid")
        t_pre = time.time() - t1
        t1 = time.time()
        dec, counts[f"{arch} decode"] = lm_decode(cfg, params, B_dec, gen,
                                                  dev, card, arch)
        t_dec = time.time() - t1
        del params
        torch.cuda.empty_cache()
        summary[arch] = f"{pre}; {dec}"
        print(f"# {arch}: prefill {t_pre:.1f}s, decode {t_dec:.1f}s, "
              f"{time.time() - t0:.1f}s in all")
    for arch, *_ in LM_SERVE:
        summary[arch] += "; " + lm_decode_check(arch, gen, dev, card)
    print(f"# LM serving phase: {time.time() - t_all:.1f}s")
    return counts, summary



def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="chip smoke of repro_torch")
    p.add_argument("--points", type=int, default=POINTS,
                   help="dataset size (a cut below the deployment's "
                        f"{POINTS} is printed as such)")
    p.add_argument("--large-points", type=int, default=LARGE_POINTS,
                   help="the large index's size (a cut below "
                        f"{LARGE_POINTS} is printed as such)")
    p.add_argument("--engine-only", action="store_true",
                   help="stop after the engines (phases 1-3, the range "
                        "and mixed streams, 7b and 7c); prints no "
                        "contract line")
    p.add_argument("--engine-mesh-rank", default=None,
                   help=argparse.SUPPRESS)   # a rank of phase 7c
    p.add_argument("--train-mesh-rank", default=None,
                   help=argparse.SUPPRESS)   # a rank of phase 13c
    opts = p.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no src/repro_torch under {ROOT})", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the smoke runs only on the card",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    if opts.engine_mesh_rank:
        return engine_mesh_rank(Path(opts.engine_mesh_rank))
    if opts.train_mesh_rank:
        return train_mesh_rank(Path(opts.train_mesh_rank))
    from repro_torch import resolve_device
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.launch import serve

    t_start = time.time()
    card = card_line()
    print(card)
    dev = resolve_device("cuda")

    t0 = time.time()
    kcuda.build_all()
    print(f"# built {len(kcuda.KERNELS)} CUDA kernels in "
          f"{time.time()-t0:.1f}s")
    for k in kcuda.KERNELS.values():
        regs = [ln.split("ptxas info    : ")[-1]
                for ln in k.log_path().read_text().splitlines()
                if "registers" in ln]
        print(f"  {k.name}: {'; '.join(regs)}")

    if opts.points != POINTS:
        print(f"# CUT: {opts.points} points instead of the deployment's "
              f"{POINTS}")
    base_argv = [
        "--dataset", "crimes", "--points", str(opts.points),
        "--queries", str(QUERIES), "--selectivity", "5e-5",
        "--node-capacity", "128", "--batch", "512", "--max-visited", "64",
        "--wide-factor", "8", "--classifier", "mlp", "--device", "cuda"]
    args = serve.parse_args(base_argv + ["--sort", "hilbert", "--reps", "3"])
    t0 = time.time()
    idx = serve.build_index(args)
    print(f"# index built in {time.time()-t0:.1f}s")

    inserts = make_inserts()
    if opts.engine_only:
        return engines_alone(idx, args, base_argv, inserts, dev, card)
    print("# kernels vs plain versions on the card:")
    rows = kernel_checks(idx, args, base_argv, dev, inserts)

    # -- the range stream in Hilbert order (the reference's default)
    kcuda.reset_launch_counts()
    report, dt_s = serve.serve_stream(idx.hybrid, idx.workload, args)
    torch.cuda.synchronize()
    counts = {"range": kcuda.launch_counts()}
    mism = serve.report_stream(report, dt_s, idx)
    print(f"# launches over {1 + args.reps} range streams "
          f"({report.n_batches} narrow + {report.wide_batches} wide "
          f"batches each): {counts['range']}")
    for name in ("spatial_key", "traverse_fused", "leaf_refine",
                 "mlp_predict_compact", "forest_infer"):
        check(counts["range"][name] > 0,
              f"{name} never launched on the range stream")
    check(mism == 0, f"oracle: {mism} n_results mismatches vs labels")
    brute_force_check(idx, report, dev, 512, 512)
    rates = {"range (hilbert)": f"{report.n_queries / dt_s:.0f} queries/s"}
    schedule_cost(idx.workload.queries, args.batch, dev)

    # -- the same stream in arrival order: a comparison, not gated
    args_none = serve.parse_args(base_argv + ["--sort", "none",
                                              "--reps", "3"])
    rep_none, dt_none = serve.serve_stream(idx.hybrid, idx.workload,
                                           args_none)
    same = all(np.array_equal(getattr(report.stats, f),
                              getattr(rep_none.stats, f))
               for f in report.stats._fields)
    print(f"# arrival order (comparison): {rep_none.n_queries / dt_none:.0f}"
          f" queries/s against {report.n_queries / dt_s:.0f} in Hilbert "
          f"order; per-query stats {'identical' if same else 'DIFFER'}")
    rates["range (arrival order)"] = \
        f"{rep_none.n_queries / dt_none:.0f} queries/s"
    profile_stream("range (hilbert)",
                   serve.range_stream(idx.hybrid, idx.workload, args),
                   report.n_batches + report.wide_batches)
    profile_stream("range (arrival order)",
                   serve.range_stream(idx.hybrid, idx.workload, args_none),
                   rep_none.n_batches + rep_none.wide_batches)

    # -- kNN, join and point streams on the same index
    for qt in ("knn", "join", "point"):
        qargs = serve.parse_args(base_argv + [
            "--sort", "hilbert", "--reps", "1", "--query-type", qt])
        kcuda.reset_launch_counts()
        if qt == "point":
            out, mism = serve.serve_point(idx.hybrid, idx.points, qargs)
        else:
            fn = serve.serve_knn if qt == "knn" else serve.serve_join
            out, mism, _ = fn(idx.dtree, idx.points, qargs)
        torch.cuda.synchronize()
        counts[qt] = kcuda.launch_counts()
        print(f"# launches over 2 {qt} streams: {counts[qt]}")
        if qt == "point":
            profile_stream(qt, serve.point_stream(idx.hybrid, idx.points,
                                                  qargs)[-1])
        else:
            make = serve.knn_stream if qt == "knn" else serve.join_stream
            _, busy, by_name = profile_stream(
                qt, make(idx.dtree, idx.points, qargs)[-1])
            if qt == "knn":
                knn_stream_sortless("knn", busy, by_name)
        check(mism == 0, f"{qt} oracle: {mism} mismatches")
        need = {"knn": ("spatial_key", "traverse_compact", "knn_browse"),
                "join": ("spatial_key", "traverse_compact", "leaf_refine"),
                "point": ("spatial_key", "traverse_fused", "leaf_refine",
                          "mlp_predict_compact", "forest_infer")}[qt]
        for name in need:
            check(counts[qt][name] > 0,
                  f"{name} never launched on the {qt} stream")
        if qt != "point":
            check(counts[qt]["traverse_fused"] == 0,
                  f"the {qt} stream built a dense [B, L] visited mask")
        rates[qt] = ", ".join(f"{v:.0f} {k}" for k, v in out.items())

    counts["mixed"], rates["mixed"], mixed = mixed_stream(
        idx, base_argv, inserts, dev)

    # -- the serving engine at one rank: range, point and mixed streams
    ecounts, erates, one_rank = engine_phase(idx, base_argv, inserts, dev,
                                             report, mixed)
    counts.update(ecounts)

    # -- the same three streams over a mesh of two ranks sharing the card,
    # served while this process fits the forest bank on the host
    mesh_run = MeshRun.engine(idx, base_argv, inserts)
    forest = forest_fit(idx, "; the mesh phase's two ranks served meanwhile")
    mcounts, mesh_rates = engine_mesh_phase(
        mesh_run, card, one_rank, "; this process fit the forest bank "
        "meanwhile")
    counts.update(mcounts)

    # -- the forest bank, then the open loop, on the same index
    fcounts, rates["forest"], frow = forest_phase(idx, forest, base_argv,
                                                  dev, card)
    counts.update(fcounts)
    rows.append(frow)
    ocounts, open_loop = open_loop_phase(idx, base_argv, dev)
    counts.update(ocounts)

    # -- the walk ladder's rungs, then the 40M-point index's streams
    counts["routing"], routing_levels, routing_sliced = routing_phase(idx,
                                                                      dev)
    next(r for r in rows if r["name"] == "mbr_intersect")["routing"] = \
        routing_levels
    next(r for r in rows if r["name"] == "traverse_fused_sliced")[
        "routing"] = routing_sliced
    if opts.large_points != LARGE_POINTS:
        print(f"# CUT: the large index holds {opts.large_points} points "
              f"instead of {LARGE_POINTS}")
    large, large_rates, large_row, large_select = large_index(
        dev, card, opts.large_points)
    counts["knn (large index)"] = large["knn"]
    counts["join (large index)"] = large["join"]
    rows.append(large_row)
    knn_row = next(r for r in rows if r["name"] == "knn_browse")
    knn_row["large"] = {tier: {key: r[key] for key in
                               ("ms", "plain_ms", "bound_ms", "bound_by")}
                        for tier, (r, _) in large_select.items()}

    # -- the rwkv6-3b serving path: prefill forward (wkv6) and decode
    rcounts, rwkv, wkv6_row = rwkv_phase(dev, card)
    counts.update(rcounts)
    rows.append(wkv6_row)

    # -- rwkv6-3b training: wkv6 under autograd, launch/train.py's step
    tcounts, rwkv["training"], train_fields = train_phase(dev, card)
    counts.update(tcounts)
    wkv6_row.update(train_fields)

    # -- the nine other LM families' training at their published width
    tcounts, lm_train = lm_train_phase(dev, card)
    counts.update(tcounts)

    # -- rwkv6-3b training over a 1x2 and a 2x1 mesh of two ranks
    tcounts, rwkv["training over a mesh"], mesh_fields = train_mesh_phase(
        dev, card)
    counts.update(tcounts)
    wkv6_row.update(mesh_fields)

    # -- the LM serving paths (the GQA families, the moe pair): prefill
    # and decode
    lcounts, lm = lm_phase(dev, card)
    counts.update(lcounts)

    for r in rows:
        r["launches_by_path"] = {p: c[r["name"]] for p, c in counts.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        check(r["launches"] > 0, f"{r['name']} never launched")

    st = report.stats
    ai = 100 * float(st.used_ai.mean())
    acc = float(st.leaf_accesses.mean())
    print("kernels: " + ", ".join(kcuda.KERNELS) + " (CUDA C++, sm_90a)")
    print(f"# serve on {card}: range {rates['range (hilbert)']} in Hilbert "
          f"order ({ai:.1f}% answered on the AI path, {acc:.2f} leaf "
          f"accesses/query; {rates['range (arrival order)']} in arrival "
          f"order); knn {rates['knn']}; join {rates['join']}; point "
          f"{rates['point']}; mixed {rates['mixed']} with {INSERTS} "
          f"inserts; engine at one rank: range {erates['engine range']}, "
          f"point {erates['engine point']}, mixed {erates['engine mixed']}; "
          f"engine over a 1x2 mesh on one card (gloo, through the host): "
          f"{mesh_rates}; "
          f"forest bank {rates['forest']}; open loop at 1.5x "
          f"capacity: deadline formation {open_loop['deadline']}, full "
          f"{open_loop['full']} ({opts.points} points, batch {args.batch}); "
          f"on the {opts.large_points}-point index knn {large_rates['knn']}, "
          f"join {large_rates['join']}")
    print(f"# rwkv6-3b on {card}: " + "; ".join(
        f"{path} {v}" for path, v in rwkv.items()))
    for arch, v in lm.items():
        print(f"# {arch} on {card}: {v}")
    for arch, v in lm_train.items():
        print(f"# {arch} training on {card}: {v}")
    print(f"# smoke finished in {time.time()-t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
