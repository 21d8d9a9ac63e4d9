"""Time the ancestor-sliced walks and ``mbr_intersect`` on one card.

``python -m repro_torch.launch.walk_probe [--leaves 449439] [--queries 512]``

Builds a ``synth_levels`` hierarchy of ``--leaves`` STR-packed leaves
(fanout 89, the 40M-point index's fill), 512 small range queries in
lexicographic centre order, and two ancestor tables over it: the one
``build_ancestor_table`` makes, and a degenerate one whose every window
is the whole lane-padded level (what real STR trees can give). For each
table it launches ``traverse_compact_sliced`` (k 64) and, where its shared
memory fits, ``traverse_fused_sliced``; then ``mbr_intersect`` of the
queries with the leaf level. Every launch is held bit-equal to its plain
version before it is timed (CUDA events, mean of 10 launches after 3).
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from repro_torch.core import device_tree as dt
from repro_torch.data.synth_tree import synth_levels
from repro_torch.kernels import ops, ref


def _ms(launch, reps: int = 10) -> float:
    for _ in range(3):
        launch()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--leaves", type=int, default=449_439)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("walk_probe times CUDA kernels: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    mbrs, parents = synth_levels(args.leaves, 89,
                                 np.random.default_rng(args.seed),
                                 str_pack=True)
    sizes = [len(p) for p in parents]
    mb = [torch.from_numpy(m).to(dev) for m in mbrs]
    pa = [torch.from_numpy(p).to(dev) for p in parents]
    c = np.random.default_rng(args.seed + 1).uniform(
        -1, 1, (args.queries, 2)).astype(np.float32)
    c = c[np.lexsort((c[:, 1], c[:, 0]))]
    q = torch.from_numpy(np.concatenate([c - 0.003, c + 0.003], 1)).to(dev)
    built = dt.build_ancestor_table(parents, device=dev)
    degen = dt.AncestorTable(
        starts=torch.zeros_like(built.starts),
        widths=tuple(-(-n // 128) * 128 for n in sizes[:-1]), tl=built.tl)
    print(f"levels {sizes}")
    for name, sl in (("built", built), ("degenerate", degen)):
        launch, (idx, cnt) = ops.prepare("traverse_compact_sliced", q, mb,
                                         pa, sl, 64)
        launch()
        w_idx, _, w_cnt = ref.traverse_compact_sliced(
            q, mb, pa, sl.starts, sl.widths, sl.tl, 64)
        assert torch.equal(idx, w_idx) and torch.equal(cnt, w_cnt), name
        print(f"{name} windows {sl.widths}: traverse_compact_sliced "
              f"{_ms(launch)} ms (mean visited "
              f"{float(cnt.float().mean())})")
        if ops.walk_smem("fused", "sliced", sizes, sl.widths, sl.tl) > \
                ops.MAX_DYNAMIC_SMEM:
            print(f"{name}: traverse_fused_sliced does not fit one CTA")
            continue
        launch, out = ops.prepare("traverse_fused_sliced", q, mb, pa, sl)
        launch()
        assert torch.equal(out, ref.traverse_fused_sliced(
            q, mb, pa, sl.starts, sl.widths, sl.tl)), name
        print(f"{name} windows {sl.widths}: traverse_fused_sliced "
              f"{_ms(launch)} ms")
    launch, out = ops.prepare("mbr_intersect", q, mb[-1])
    launch()
    assert torch.equal(out, ref.mbr_intersect(q, mb[-1]))
    print(f"mbr_intersect {args.queries} x {sizes[-1]}: {_ms(launch)} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
