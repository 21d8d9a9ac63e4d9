"""Single-token decode steps, the rwkv6 family.

The port of the JAX package's ``serving/decode.py`` for the ssm family:
one new token against the carried cache, layer by layer in a Python loop
(the reference scans the stacked layers). Each layer's time-mix is one
recurrence step in plain tensor code (S == 1), so decode launches no
``wkv6`` kernel. Like the reference, a step returns a new cache and
leaves the one it was given as it was.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import ssm as ssmlib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm, softcap
from repro_torch.models.transformer import layer, require_ssm
from repro_torch.serving.kvcache import Cache

Params = Dict[str, Any]


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, 1] → (logits [B, vocab_padded], new cache)."""
    require_ssm(cfg)
    x = params["embed"][tokens[:, 0]]
    tm_s, cm_s, wkv_s = [], [], []
    for i in range(cfg.n_layers):
        lp = layer(params, i)
        tms, cms = cache["tm_shift"][i], cache["cm_shift"][i]
        hn = rmsnorm(x[:, None], lp["norm1"], cfg.norm_eps)
        tm, tm_new, wkv_new = ssmlib.rwkv_time_mix(cfg, lp, hn, tms,
                                                   cache["wkv"][i])
        x = x + tm[:, 0]
        hn = rmsnorm(x[:, None], lp["norm2"], cfg.norm_eps)
        cm, cm_new = ssmlib.rwkv_channel_mix(cfg, lp, hn, cms)
        x = x + cm[:, 0]
        tm_s.append(tm_new.to(tms.dtype))
        cm_s.append(cm_new.to(cms.dtype))
        wkv_s.append(wkv_new)
    new_cache = dict(cache, pos=cache["pos"] + 1,
                     tm_shift=torch.stack(tm_s), cm_shift=torch.stack(cm_s),
                     wkv=torch.stack(wkv_s))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap(torch.einsum("bd,dv->bv", x, head), cfg.logit_softcap)
    return logits, new_cache


def prefill_via_decode(cfg: ModelConfig, params: Params, cache: Cache,
                       tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Sequentially decode a prompt (test/example helper)."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1])
    return logits, cache
