"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the exact published config;
``reduced(cfg)`` shrinks it for CPU smoke tests (same family/topology,
small widths). A copy of the JAX package's registry (data only); every
config serves and trains in the port.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "whisper_small",
    "rwkv6_3b",
    "qwen2_vl_72b",
    "deepseek_moe_16b",
    "deepseek_v2_236b",
    "gemma2_9b",
    "llama3_405b",
    "h2o_danube3_4b",
    "qwen2_72b",
    "hymba_1_5b",
)

ALIASES = {
    "whisper-small": "whisper_small",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "gemma2-9b": "gemma2_9b",
    "llama3-405b": "llama3_405b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "qwen2-72b": "qwen2_72b",
    "hymba-1.5b": "hymba_1_5b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCHS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving shrink for CPU smoke tests."""
    d_head = 16
    n_heads = max(2, min(cfg.n_heads, 4))
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // min(ratio, n_heads))
    d_model = 64 if cfg.family != "hybrid" else 64
    changes = dict(
        n_layers=2 if cfg.layer_pattern != "alt_local_global" else 2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=d_head,
        d_ff=128,
        vocab=512,
        window=min(cfg.window, 16) if cfg.window else 0,
    )
    if cfg.family == "ssm":
        changes.update(n_heads=4, n_kv_heads=4, d_model=64)  # dk = 16
    if cfg.use_mla:
        changes.update(kv_lora=32, q_lora=32, rope_head_dim=8,
                       mla_d_nope=16, mla_d_v=16)
    if cfg.family == "moe":
        changes.update(n_experts=min(cfg.n_experts, 8),
                       top_k=min(cfg.top_k, 2), d_expert=32,
                       n_dense_layers=min(cfg.n_dense_layers, 1))
    if cfg.family == "hybrid":
        changes.update(ssm_state=8)
    if cfg.family == "encdec":
        changes.update(n_enc_layers=2, enc_seq=32)
    return dataclasses.replace(cfg, **changes)
