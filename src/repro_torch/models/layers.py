"""Shared primitives: initializers, norms, activations.

The port of the JAX package's ``models/layers.py``. Its sharding helpers
(``with_sharding``, ``shard_batch``) are mesh code that does nothing off
a mesh, and have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.float32,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (all linear layers): a standard normal
    truncated to [-2, 2], drawn in float32 from ``generator`` on the
    generator's own device, times ``1/sqrt(fan_in)`` unless ``scale`` is
    given, then moved to ``device`` (where it was drawn when None)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(device=device, dtype=dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2-style tanh soft capping."""
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap
