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
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training import tree


def _flatten(state: Any) -> Tuple[dict, list]:
    """``({key: numpy array}, [keys of bf16 leaves])``."""
    flat, bf16 = {}, []
    for key, leaf in tree.leaves(state):
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


def _unflatten_into(template: Any, flat: dict, bf16: set) -> Any:
    def one(key, leaf):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"model {tuple(leaf.shape)}")
        return _leaf(key, arr, bf16).to(dtype=leaf.dtype,
                                        device=leaf.device)
    return tree.rebuild(template, one)


def save(ckpt_dir: str, step: int, state: Any, *,
         extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically write checkpoint ``step``; prune to ``keep`` newest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat, bf16 = _flatten(state)
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
            step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore into ``template``'s structure, each leaf in its template
    leaf's dtype and on its device. A missing leaf raises ``KeyError``,
    a shape that differs ``ValueError``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    tag = f"step_{step:010d}"
    with open(os.path.join(ckpt_dir, tag + ".manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(ckpt_dir, tag + ".npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(template, flat,
                           set(manifest.get("bf16", []))), manifest
