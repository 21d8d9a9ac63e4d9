"""Decode-time caches, the rwkv6 family.

The port of the JAX package's ``serving/kvcache.py`` for the ssm family:
token shifts ``tm_shift`` / ``cm_shift`` ``[L, B, d]`` and the wkv state
``[L, B, H, dk, dk]`` in float32 — O(1) in the context length. ``pos``
is a scalar step counter shared across the batch. The other families'
caches are ROADMAP A13.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import require_ssm

Cache = Dict[str, Any]


def make_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> Cache:
    """Allocate the decode cache for a maximum context of ``seq_len``
    (which the rwkv6 cache does not depend on)."""
    require_ssm(cfg)
    device = resolve_device(device)
    L, B = cfg.n_layers, batch
    dk = cfg.d_model // cfg.n_heads
    return {
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "tm_shift": torch.zeros((L, B, cfg.d_model), dtype=dtype,
                                device=device),
        "cm_shift": torch.zeros((L, B, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((L, B, cfg.n_heads, dk, dk), dtype=torch.float32,
                           device=device),
    }


def cache_bytes(cache: Cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values()
               if torch.is_tensor(t))
