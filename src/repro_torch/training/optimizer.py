"""AdamW with configurable state dtype + gradient clipping.

The port of the JAX package's ``training/optimizer.py``, its order of
operations kept, so the same float32 inputs give the same float32
results up to the last ulp of an elementary function (the schedule's
``cos``; ATen's CPU ``sqrt``, which is not always correctly rounded).
``state_dtype=torch.bfloat16`` halves m and v; gradient accumulation
lives in ``train_loop``. ``apply_updates`` walks the tree leaf by leaf
and each leaf in slices of ``SLICE`` of its flattened elements, writing
the new values into the state's own tensors: a step holds params, m and
v once (where the JAX step, jitted, would donate its buffers), and its
float32 temporaries are a few slices, not a few leaves (llama3-405b's
``embed`` is 2.10 B elements: ~42 GB of temporaries whole, ~340 MB a
slice). The expressions are elementwise, so slicing leaves every bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.training import tree

F32 = torch.float32
SLICE = 1 << 24         # elements of a leaf updated (and normed) at a time


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: torch.dtype = torch.float32    # bf16 at 100B+ scale
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay, in float32."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(cfg: AdamWConfig, params: Any) -> OptState:
    """Zero m and v in ``cfg.state_dtype`` beside each param, step 0."""
    dev = next(tree.leaves(params))[1].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree.rebuild(params, lambda _, p: torch.zeros(
            p.shape, dtype=cfg.state_dtype, device=p.device)),
        v=tree.rebuild(params, lambda _, p: torch.zeros(
            p.shape, dtype=cfg.state_dtype, device=p.device)))


def _slices(x: torch.Tensor):
    """Views of ``SLICE`` consecutive elements of ``x`` (contiguous)."""
    return x.view(-1).split(SLICE)


def global_norm(t: Any) -> torch.Tensor:
    """The square root of every leaf's sum of squares in float32, a leaf
    longer than ``SLICE`` summed slice by slice (its float32 copy and
    square would otherwise be whole-leaf temporaries)."""
    return torch.sqrt(sum(torch.sum(torch.square(s.to(F32)))
                          for _, x in tree.leaves(t) for s in _slices(x)))


def _upd(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2):
    """One leaf's new (param, m, v) in float32. The reference's
    expressions (``optimizer.py:73-81``) op for op; some run in place
    on a temporary, which rounds the same."""
    g = g.to(F32) * scale
    m32 = m.to(F32) * cfg.b1                    # b1 * m
    m32 += g * (1 - cfg.b1)                     #   + (1 - b1) * g
    v32 = v.to(F32) * cfg.b2                    # b2 * v
    t = g * (1 - cfg.b2)
    t *= g
    v32 += t                                    #   + (1 - b2) * g * g
    del g, t
    u = m32 / bc1
    t = v32 / bc2
    t.sqrt_()
    t += cfg.eps
    u /= t                                      # (m/bc1) / (sqrt(v/bc2) + eps)
    del t
    u += p.to(F32) * cfg.weight_decay           # u + wd * p
    u *= lr
    return torch.sub(p.to(F32), u, out=u), m32, v32     # p - lr * u


def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: OptState, gnorm: torch.Tensor | None = None
                  ) -> tuple[Any, OptState, dict]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``.

    In place: the new params, m and v are written into the given
    tensors (contiguous, as ``init_params`` and ``init_opt_state`` make
    them), slice by slice, which come back in the same trees
    (``state.step`` is replaced), and each leaf of ``grads`` (a dict
    tree) is dropped once it is used, so a step holds params, m, v and
    grads once.

    ``gnorm`` (default ``global_norm(grads)``) is the norm to clip by:
    a rank that holds shards of params, grads, m and v passes the whole
    tree's, and its shard's update is then the same bits as that slice
    of the whole update (every expression is elementwise)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0) \
        if cfg.clip_norm else 1.0
    step = state.step + 1
    lr = schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step.to(F32)
    bc2 = 1 - cfg.b2 ** step.to(F32)
    flat_m = dict(tree.leaves(state.m))
    flat_v = dict(tree.leaves(state.v))
    with torch.no_grad():
        for key, p in tree.leaves(params):
            for ps, gs, ms, vs in zip(*map(_slices, (
                    p, _pop(grads, key), flat_m[key], flat_v[key]))):
                newp, m32, v32 = _upd(cfg, ps, gs, ms, vs, scale, lr, bc1,
                                      bc2)
                ps.copy_(newp)
                ms.copy_(m32)
                vs.copy_(v32)
                del newp, m32, v32
    return params, OptState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm, "lr": lr}


def _pop(t: dict, key: str):
    *head, last = key.split("/")
    for k in head:
        t = t[k]
    return t.pop(last)


def opt_state_bytes(state: OptState) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree.leaves(state))
