"""Model zoo core, the RWKV-6 (``ssm``) family: init and forward.

The port of the JAX package's ``models/transformer.py`` for the ssm
family. Params are nested dicts of tensors with the reference's names,
and the decoder blocks are stacked ``[L, ...]``, so carrying weights
across from the reference is a tree map (``bridge.lm_params_from_
reference``). The layer loop is a Python loop; serving runs it under
``torch.no_grad()``, training under autograd with each layer
checkpointed by ``remat_policy`` (``loss_fn``). The other nine families
(dense, moe, hybrid, encdec) raise ``NotImplementedError``: they are
ROADMAP A13's rest.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn)

from repro_torch import resolve_device
from repro_torch.models import ssm as ssmlib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm, softcap

Params = Dict[str, Any]


def require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): only the ssm family (rwkv6) is "
            "ported; the other families are ROADMAP A13")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _rwkv_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                 device) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dk = d // H
    r = 32  # token-shift LoRA rank

    def init(shape, dt=dtype):
        return dense_init(gen, shape, dtype=dt, device=device)

    def full(value):
        return torch.full((d,), value, dtype=dtype, device=device)

    p: Params = {}
    for nm in ("r", "k", "v", "w", "g"):
        p[f"mu_{nm}"] = full(0.5)
        p[f"la_{nm}"] = init((d, r))
        p[f"lb_{nm}"] = init((r, d))
    for nm in ("wr", "wk", "wv", "wg", "wo"):
        p[nm] = init((d, d))
    p["w_base"] = full(-2.0)                           # decay ≈ exp(-e^-2)
    p["la_wd"] = init((d, 64))
    p["lb_wd"] = init((64, d))
    p["u"] = init((H, dk), torch.float32)
    p["ln_x"] = full(0.0)
    p["mu_ck"] = full(0.5)
    p["mu_cr"] = full(0.5)
    p["wck"] = init((d, cfg.d_ff))
    p["wcv"] = init((cfg.d_ff, d))
    p["wcr"] = init((d, d))
    return p


def _block_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                  device) -> Params:
    require_ssm(cfg)
    d = cfg.d_model
    p: Params = {"norm1": torch.zeros((d,), dtype=dtype, device=device),
                 "norm2": torch.zeros((d,), dtype=dtype, device=device)}
    p.update(_rwkv_params(cfg, gen, dtype, device))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16,
                device: str | torch.device = "cuda") -> Params:
    """Initialize the full parameter dict on ``device``. The draws come
    from ``generator`` on its own device, so one seed gives one draw per
    generator device; a generator on ``device`` avoids the copy.

    As the reference's ``stacked=True``, ONE layer is drawn and repeated
    L times; the stack is materialised (``[L, ...]`` tensors, not views),
    so the device holds every layer's weights as a trained model would.
    """
    require_ssm(cfg)
    device = resolve_device(device)
    d, Vp = cfg.d_model, cfg.vocab_padded
    params: Params = {
        "embed": dense_init(generator, (Vp, d), scale=0.02, dtype=dtype,
                            device=device),
        "final_norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (d, Vp), dtype=dtype,
                                       device=device)
    one = _block_params(cfg, generator, dtype, device)
    L = cfg.n_layers
    params["layers"] = {k: v[None].expand((L,) + v.shape).contiguous()
                        for k, v in one.items()}
    return params


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views into the ``[L, ...]`` stacks (or
    the ``i``-th entry where a stack is held as a sequence of per-layer
    tensors, as the train step holds it)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _rwkv_block(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    B = x.shape[0]
    zeros = torch.zeros((B, cfg.d_model), dtype=x.dtype, device=x.device)
    dk = cfg.d_model // cfg.n_heads
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    tm, _, _ = ssmlib.rwkv_time_mix(
        cfg, p, h, zeros,
        torch.zeros((B, cfg.n_heads, dk, dk), dtype=torch.float32,
                    device=x.device))
    x = x + tm
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    cm, _ = ssmlib.rwkv_channel_mix(cfg, p, h, zeros)
    return x + cm


# the matmuls "dots" keeps (jax.checkpoint_policies.checkpoint_dots): an
# einsum reaches ATen as mm (no batch dims) or bmm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat(f: Callable, policy: Optional[str]) -> Callable:
    """``f`` under activation checkpointing, as the reference's ``_remat``
    (``src/repro/models/transformer.py:325-334``): ``"full"`` recomputes
    everything in the backward, ``"dots"`` keeps the matmul outputs and
    recomputes the rest, ``"none"`` / ``None`` keeps everything. Without
    autograd (serving under ``torch.no_grad()``) ``f`` runs as it is."""
    if policy == "none" or policy is None:
        return f
    if policy == "full":
        context_fn = noop_context_fn
    elif policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_dots)
    else:
        raise ValueError(f"unknown remat_policy {policy!r} (full, dots, "
                         "none)")

    def run(*args):
        if not torch.is_grad_enabled():
            return f(*args)
        return checkpoint(f, *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


def forward(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *,
            remat_policy: Optional[str] = "dots") -> torch.Tensor:
    """Training/prefill forward → logits [B, S, vocab_padded].

    ``batch``: {"tokens": [B,S]}. Each layer's time-mix runs one ``wkv6``
    scan over the whole sequence. Under autograd each layer is
    checkpointed by ``remat_policy`` (``_remat``), which does not change
    the values; under ``torch.no_grad()`` it costs nothing.
    """
    require_ssm(cfg)
    x = params["embed"][batch["tokens"]]
    for i in range(cfg.n_layers):
        x = _remat(functools.partial(_rwkv_block, cfg, layer(params, i)),
                   remat_policy)(x)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return softcap(logits, cfg.logit_softcap)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *,
            remat_policy: Optional[str] = "dots") -> torch.Tensor:
    """Next-token cross entropy over the logical vocab, in float32, as a
    mean over the positions ``batch["loss_mask"]`` weights (all of them
    when it is absent)."""
    logits = forward(cfg, params, batch, remat_policy=remat_policy)
    labels = batch["labels"].long()
    logits = logits[..., :cfg.vocab].to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(lse) if mask is None else mask.to(torch.float32)
    return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                        min=1.0)
