"""Decode-time caches for the ported families.

The port of the JAX package's ``serving/kvcache.py``. Layouts (leading
L = layers, stacked as the params are):

  dense / moe   k,v: [L, B, Hkv, S_cache, Dh]   (S_cache = seq_len, or the
                window size for SWA layers — an O(window) cache); the
                moe config without MLA (deepseek-moe) holds its
                ``L - n_dense_layers`` MoE layers there and its leading
                dense layers in a ``dense`` k/v stack of their own
  MLA           ckv: [L, B, S, kv_lora], krope: [L, B, S, d_rope] over
                all L layers, the dense ones first — the compressed
                latent is all that is stored (deepseek-v2: 1,152 bytes a
                token a layer in bf16, where 128 heads of 128 would
                take 65,536)
  gemma2        two stacks: local (window) + global (full) caches, each
                [L/2, ...]
  rwkv6         tm/cm shifts [L, B, d] + wkv state [L, B, H, dk, dk] — O(1)
  hymba         window k/v + mamba conv tail [L, B, K-1, di] and state
                ``ssm_h`` [L, B, di, N] (float32) — O(window + d·N)
  whisper       decoder self k/v + the encoder's cross k/v ``xk`` / ``xv``
                [L, B, Hkv, enc_seq, Dh], filled by the caller from the
                encoder's output (the reference's tests do the same)

``pos`` is a scalar step counter shared across the batch (standard batched
decode); ring-buffer writes use ``pos % window`` for windowed layers.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig

Cache = Dict[str, Any]


def _kv(L, B, Hkv, S, Dh, dtype, device) -> Cache:
    return {"k": torch.zeros((L, B, Hkv, S, Dh), dtype=dtype, device=device),
            "v": torch.zeros((L, B, Hkv, S, Dh), dtype=dtype, device=device)}


def make_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16,
               device: str | torch.device = "cuda") -> Cache:
    """Allocate the decode cache for a maximum context of ``seq_len``
    (which the rwkv6 cache does not depend on)."""
    device = resolve_device(device)
    L, B = cfg.n_layers, batch
    H, Dh = cfg.n_kv_heads, cfg.d_head
    cache: Cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.family == "ssm":
        dk = cfg.d_model // cfg.n_heads
        cache.update(tm_shift=zeros((L, B, cfg.d_model)),
                     cm_shift=zeros((L, B, cfg.d_model)),
                     wkv=zeros((L, B, cfg.n_heads, dk, dk), torch.float32))
        return cache
    if cfg.use_mla:
        cache.update(ckv=zeros((L, B, seq_len, cfg.kv_lora)),
                     krope=zeros((L, B, seq_len, cfg.rope_head_dim)))
        return cache
    if cfg.layer_pattern == "alt_local_global":
        half = L // 2
        cache["local"] = _kv(half, B, H, min(cfg.window, seq_len), Dh,
                             dtype, device)
        cache["global"] = _kv(half, B, H, seq_len, Dh, dtype, device)
        return cache
    S_eff = min(cfg.window, seq_len) if cfg.layer_pattern == "swa" \
        else seq_len
    moe = cfg.family == "moe"
    cache.update(_kv(L - cfg.n_dense_layers if moe else L, B, H, S_eff, Dh,
                     dtype, device))
    if cfg.family == "hybrid":
        di = cfg.d_model * cfg.ssm_expand
        cache.update(conv=zeros((L, B, cfg.ssm_conv - 1, di)),
                     ssm_h=zeros((L, B, di, cfg.ssm_state), torch.float32))
    if cfg.family == "encdec":
        cache.update(xk=zeros((L, B, H, cfg.enc_seq, Dh)),
                     xv=zeros((L, B, H, cfg.enc_seq, Dh)))
    if moe and cfg.n_dense_layers:
        cache["dense"] = _kv(cfg.n_dense_layers, B, H, seq_len, Dh, dtype,
                             device)
    return cache


def cache_bytes(cache) -> int:
    """Bytes of every tensor in ``cache``, nested dicts included."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if torch.is_tensor(cache):
        return cache.numel() * cache.element_size()
    return 0
