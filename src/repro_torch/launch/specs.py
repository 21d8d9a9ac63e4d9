"""Input specifications for every (architecture × shape) dry-run cell:
the port of ``src/repro/launch/specs.py``.

The reference returns ``jax.ShapeDtypeStruct`` stand-ins through
``jax.eval_shape``. Here every stand-in is a tensor on PyTorch's
``meta`` device: its shape and dtype, no storage and no draw
(``init_params`` on ``meta`` skips the random draws,
``models/layers.dense_init``). Modality frontends are stubs per the
assignment: whisper gets precomputed frame embeddings, qwen2-vl gets a
precomputed embedding sequence in place of tokens.

Shape classes (LM shapes are seq_len × global_batch):
  train_4k     seq 4096,   batch 256   → train_step
  prefill_32k  seq 32768,  batch 32    → forward (inference prefill)
  decode_32k   seq 32768,  batch 128   → serve_step (1 token + 32k cache)
  long_500k    seq 524288, batch 1     → serve_step, sub-quadratic archs only
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache
from repro_torch.training import optimizer as opt, train_loop

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

SHAPE_DEFS = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# gradient-accumulation plan per arch for train_4k (activation-memory
# lever). batch 256 must divide by accum.
ACCUM = {
    "llama3-405b": 16,
    "deepseek-v2-236b": 8,
    "qwen2-72b": 4,
    "qwen2-vl-72b": 4,
    "gemma2-9b": 2,
    "deepseek-moe-16b": 4,
    # SSM/hybrid trains materialize f32 scan inputs over the full
    # sequence; microbatching keeps the live set well inside memory
    "rwkv6-3b": 8,
    "hymba-1.5b": 8,
}

META = torch.device("meta")


def cell_supported(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense decode is the "
                       "quadratic blow-up this shape excludes")
    return True, ""


def f32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=META)


def bf16(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.bfloat16, device=META)


def i32(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=META)


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, torch.Tensor]:
    """Batch stand-ins for train/prefill cells."""
    sd = SHAPE_DEFS[shape]
    B, S = sd["global_batch"], sd["seq_len"]
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        # stub: precomputed multimodal embedding sequence
        specs["embeds"] = bf16(B, S, cfg.d_model)
    else:
        specs["tokens"] = i32(B, S)
    if cfg.family == "encdec":
        specs["frames"] = bf16(B, cfg.enc_seq, cfg.d_model)
    if sd["kind"] == "train":
        specs["labels"] = i32(B, S)
    return specs


def decode_specs(cfg: ModelConfig, shape: str,
                 cache_dtype=torch.bfloat16) -> tuple[dict, Any]:
    """(tokens stand-in, cache stand-in tree) for decode cells."""
    sd = SHAPE_DEFS[shape]
    B, S = sd["global_batch"], sd["seq_len"]
    cache = kvcache.make_cache(cfg, B, seq_len=S, dtype=cache_dtype,
                               device=META)
    return {"tokens": i32(B, 1)}, cache


def state_specs(cfg: ModelConfig, *, dtype=torch.bfloat16,
                opt_state_dtype=None) -> tuple[Any, Any]:
    """``(TrainState stand-in, AdamWConfig)``: the AdamW state in bf16
    past 1e11 parameters, else float32, unless ``opt_state_dtype``."""
    ocfg = opt.AdamWConfig(
        state_dtype=opt_state_dtype
        or (torch.bfloat16 if cfg.n_params() > 1e11 else torch.float32))
    return train_loop.init_train_state(
        cfg, torch.Generator(), dtype=dtype, opt_cfg=ocfg,
        device=META), ocfg
