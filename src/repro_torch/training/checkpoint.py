"""Checkpointing: atomic, device-independent, resumable.

The port of the JAX package's ``training/checkpoint.py``, in its format:
one ``.npz`` per checkpoint step holding every leaf as a whole host
array keyed by its path (``params/layers/wr``, ``opt/m/embed``,
``opt/step``: ``tree.leaves``), plus a JSON manifest with the step and
the caller's ``extra`` (data cursor, RNG). Leaves are stored logically,
so a checkpoint restores onto any device; a float32 checkpoint written
by the reference restores into the port's template, and the port's
float32 checkpoints are the reference's format.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits and
named under the manifest's ``"bf16"`` list, so it restores bit for bit.
A *bf16* checkpoint written by the reference (``ml_dtypes`` arrays in
the ``.npz``) is not read: the card's machine has no ``ml_dtypes``.

Writes are atomic (tmp file + rename); ``keep`` bounds disk usage;
restore picks the newest complete manifest, so a preemption mid-write
can never leave the job unable to resume.

Over a mesh (``launch/mesh.py``) both take the state's spec tree
(``launch/sharding.state_shardings``). Every rank calls ``save``: each
leaf is gathered whole, rank 0 writes the same format and prunes, and
the ranks meet at a barrier. ``restore(..., mesh=, specs=)`` keeps this
rank's block of each whole leaf, whatever mesh (or one device) wrote
it.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.training import shards, tree


def _flatten(state: Any, mesh=None, specs: Any = None
             ) -> Tuple[dict, list]:
    """``({key: numpy array}, [keys of bf16 leaves])``, each leaf whole
    (gathered over ``mesh`` by ``specs``; kept by rank 0 alone)."""
    flat, bf16 = {}, []
    spec = dict(tree.leaves(specs)) if mesh is not None else {}
    for key, leaf in tree.leaves(state):
        if mesh is not None:
            leaf = shards.gather_leaf(leaf, spec[key], mesh)
            if mesh.rank != 0:
                continue
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat, bf16


def _leaf(key: str, arr: np.ndarray, bf16: set) -> torch.Tensor:
    arr = np.array(arr, order="C")
    if key in bf16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _unflatten_into(template: Any, flat, bf16: set, mesh=None,
                    specs: Any = None) -> Any:
    spec = dict(tree.leaves(specs)) if mesh is not None else {}

    def one(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        t = _leaf(key, arr, bf16)
        if mesh is not None:        # this rank's block of the whole leaf
            b = shards.shard_leaf(t, spec[key], mesh)
            t = b if b.shape == t.shape else \
                b.clone(memory_format=torch.contiguous_format)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} "
                f"{'(this rank: ' + str(tuple(t.shape)) + ') ' if mesh else ''}"
                f"vs model {tuple(leaf.shape)}")
        return t.to(dtype=leaf.dtype, device=leaf.device)
    return tree.rebuild(template, one)


def save(ckpt_dir: str, step: int, state: Any, *,
         extra: Optional[dict] = None, keep: int = 3, mesh=None,
         specs: Any = None) -> Optional[str]:
    """Atomically write checkpoint ``step``; prune to ``keep`` newest.
    Over a ``mesh`` (``state`` this rank's shards, ``specs`` their spec
    tree: ``launch.sharding.state_shardings``) every rank calls it; rank 0
    writes and returns the path, the others None once it has."""
    flat, bf16 = _flatten(state, mesh, specs)
    if mesh is not None and mesh.rank != 0:
        dist.barrier()
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = f"step_{step:010d}"
    tmp_fd, tmp_path = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(tmp_fd, "wb") as f:
        np.savez(f, **flat)
    final_npz = os.path.join(ckpt_dir, tag + ".npz")
    os.replace(tmp_path, final_npz)
    manifest = {"step": step, "time": time.time(), "file": tag + ".npz",
                "extra": extra or {}, "bf16": bf16}
    mtmp = os.path.join(ckpt_dir, tag + ".manifest.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, tag + ".manifest.json"))
    _prune(ckpt_dir, keep)
    if mesh is not None:
        dist.barrier()
    return final_npz


def _prune(ckpt_dir: str, keep: int) -> None:
    manifests = sorted(
        f for f in os.listdir(ckpt_dir) if f.endswith(".manifest.json"))
    for m in manifests[:-keep]:
        tag = m.replace(".manifest.json", "")
        for suffix in (".manifest.json", ".npz"):
            p = os.path.join(ckpt_dir, tag + suffix)
            if os.path.exists(p):
                os.remove(p)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for f in os.listdir(ckpt_dir):
        if f.endswith(".manifest.json"):
            tag = f.replace(".manifest.json", "")
            if os.path.exists(os.path.join(ckpt_dir, tag + ".npz")):
                steps.append(int(tag.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, *,
            step: Optional[int] = None, mesh=None,
            specs: Any = None) -> Tuple[Any, dict]:
    """Restore into ``template``'s structure, each leaf in its template
    leaf's dtype and on its device. A missing leaf raises ``KeyError``,
    a shape that differs ``ValueError``. With a ``mesh`` and ``specs``
    (as ``save`` takes them) the template holds this rank's shards, and
    each whole leaf is cut to this rank's block."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    tag = f"step_{step:010d}"
    with open(os.path.join(ckpt_dir, tag + ".manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, tag + ".npz")) as z:
        # an NpzFile reads a leaf when it is asked for: one at a time
        return _unflatten_into(template, z, set(manifest.get("bf16", [])),
                               mesh, specs), manifest
