"""Model zoo core: init and forward for the ported families.

The port of the JAX package's ``models/transformer.py``. Params are
nested dicts of tensors with the reference's names, and the decoder
blocks are stacked ``[L, ...]`` (gemma2: ``{"local", "global"}`` pair
stacks ``[L/2, ...]``), so carrying weights across from the reference is
a tree map (``bridge.lm_params_from_reference``). The layer loop is a
Python loop; serving runs it under ``torch.no_grad()``, training under
autograd with each layer checkpointed by ``remat_policy`` (``loss_fn``).

Families:
  dense   — llama3 / qwen2 / qwen2-vl / gemma2 / h2o-danube (GQA,
            softcap, SWA, bias; gemma2's local/global alternation runs
            over layer pairs)
  moe     — deepseek-moe / deepseek-v2 (shared + routed experts,
            ``models/moe.py``; v2 adds MLA); the leading dense layers
            are a stack of their own, ``dense_layers``, run first
  ssm     — rwkv6 (attention-free; the ``wkv6`` CUDA kernel)
  hybrid  — hymba (parallel SWA-attention + Mamba heads)
  encdec  — whisper (stub audio frontend; cross-attention decoder)
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
    noop_context_fn)

from repro_torch import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moelib
from repro_torch.models import ssm as ssmlib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn, dense_init, rmsnorm, softcap

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                 device) -> Params:
    d = cfg.d_model

    def init(shape):
        return dense_init(gen, shape, dtype=dtype, device=device)

    if cfg.use_mla:
        p: Params = {}
        if cfg.q_lora:
            p["wq_a"] = init((d, cfg.q_lora))
            p["wq_b"] = init((cfg.q_lora, cfg.q_dim))
        else:
            p["wq"] = init((d, cfg.q_dim))
        p["wkv_a"] = init((d, cfg.kv_lora + cfg.rope_head_dim))
        p["wkv_b"] = init((cfg.kv_lora,
                           cfg.n_heads * (cfg.mla_d_nope + cfg.mla_d_v)))
        p["wo"] = init((cfg.n_heads * cfg.mla_d_v, d))
        return p
    p = {"wq": init((d, cfg.q_dim)), "wk": init((d, cfg.kv_dim)),
         "wv": init((d, cfg.kv_dim)), "wo": init((cfg.q_dim, d))}
    if cfg.qkv_bias:
        for nm, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                      ("bv", cfg.kv_dim)):
            p[nm] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _mlp_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi": dense_init(gen, (d, f), dtype=dtype, device=device),
         "wo2": dense_init(gen, (f, d), dtype=dtype, device=device)}
    if cfg.act == "silu":  # gated (llama-style); whisper uses plain gelu
        p["wg"] = dense_init(gen, (d, f), dtype=dtype, device=device)
    return p


def _moe_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                device) -> Params:
    """The router (float32 whatever ``dtype``), the routed experts and
    the shared experts."""
    d, E, de = cfg.d_model, cfg.n_experts, cfg.d_expert

    def init(shape, dt=dtype):
        return dense_init(gen, shape, dtype=dt, device=device)

    p = {"router": init((d, E), torch.float32), "wi": init((E, d, de)),
         "wg": init((E, d, de)), "wo": init((E, de, d))}
    if cfg.n_shared_experts:
        dsh = cfg.n_shared_experts * de
        p["sh_wi"] = init((d, dsh))
        p["sh_wg"] = init((d, dsh))
        p["sh_wo"] = init((dsh, d))
    return p


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


def _mamba_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                  device) -> Params:
    d = cfg.d_model
    di = d * cfg.ssm_expand
    N = cfg.ssm_state

    def init(shape):
        return dense_init(gen, shape, dtype=dtype, device=device)

    def full(shape, value, dt=dtype):
        return torch.full(shape, value, dtype=dt, device=device)

    return {
        "w_in": init((d, 2 * di)),
        "conv_w": init((cfg.ssm_conv, di)),
        "conv_b": full((di,), 0.0),
        "w_dt_a": init((di, 64)),
        "w_dt_b": init((64, di)),
        "dt_bias": full((di,), -4.6),                  # softplus ≈ 0.01
        "w_B": init((di, N)),
        "w_C": init((di, N)),
        "A_log": torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=device)).expand(
                di, N).contiguous(),
        "D": full((di,), 1.0),
        "w_out": init((di, d)),
        "norm_attn": full((d,), 0.0),
        "norm_ssm": full((d,), 0.0),
        "beta_attn": full((), 1.0, torch.float32),
        "beta_ssm": full((), 1.0, torch.float32),
    }


def _block_params(cfg: ModelConfig, gen: torch.Generator, dtype,
                  device, moe_layer: bool = False) -> Params:
    """One layer's parameters: a block holds ``moe`` (``moe_layer``) or
    ``mlp``, never both."""
    d = cfg.d_model
    p: Params = {"norm1": torch.zeros((d,), dtype=dtype, device=device),
                 "norm2": torch.zeros((d,), dtype=dtype, device=device)}
    if cfg.family == "ssm":
        p.update(_rwkv_params(cfg, gen, dtype, device))
        return p
    p["attn"] = _attn_params(cfg, gen, dtype, device)
    if cfg.name.startswith("gemma2"):
        p["norm_post1"] = torch.zeros((d,), dtype=dtype, device=device)
        p["norm_post2"] = torch.zeros((d,), dtype=dtype, device=device)
    if moe_layer:
        p["moe"] = _moe_params(cfg, gen, dtype, device)
    else:
        p["mlp"] = _mlp_params(cfg, gen, dtype, device)
    if cfg.family == "hybrid":
        p["ssm"] = _mamba_params(cfg, gen, dtype, device)
    return p


def _stack(tree, L: int):
    """Each tensor of ``tree`` repeated into a materialised ``[L, ...]``
    stack (a copy, not a view: every layer holds its own weights)."""
    if isinstance(tree, dict):
        return {k: _stack(v, L) for k, v in tree.items()}
    return tree[None].expand((L,) + tree.shape).contiguous()


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16,
                device: str | torch.device = "cuda") -> Params:
    """Initialize the full parameter dict on ``device``. The draws come
    from ``generator`` on its own device, so one seed gives one draw per
    generator device; a generator on ``device`` avoids the copy.

    As the reference's ``stacked=True``, ONE layer is drawn and repeated
    L times (gemma2: one local and one global layer, each repeated L/2
    times; whisper: one encoder and one decoder layer); the stacks are
    materialised, so the device holds every layer's weights as a trained
    model would. The names, shapes and dtypes are the reference's. The
    moe family's ``layers`` are its ``n_layers - n_dense_layers`` MoE
    blocks, and ``dense_layers`` its ``n_dense_layers`` leading blocks
    with the dense FFN at ``d_ff``.
    """
    device = resolve_device(device)
    d, Vp = cfg.d_model, cfg.vocab_padded

    def init(shape, scale=None):
        return dense_init(generator, shape, scale=scale, dtype=dtype,
                          device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params: Params = {"embed": init((Vp, d), 0.02),
                      "final_norm": zeros((d,))}
    if not cfg.tie_embeddings:
        params["lm_head"] = init((d, Vp))
    moe = cfg.family == "moe"
    one = _block_params(cfg, generator, dtype, device, moe_layer=moe)
    if cfg.layer_pattern == "alt_local_global":
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.name}: alt_local_global needs an even "
                             f"n_layers, not {cfg.n_layers}")
        pair = {"local": one,
                "global": _block_params(cfg, generator, dtype, device)}
        params["layers"] = _stack(pair, cfg.n_layers // 2)
    else:
        params["layers"] = _stack(
            one, cfg.n_layers - cfg.n_dense_layers if moe else cfg.n_layers)
    if moe and cfg.n_dense_layers:
        params["dense_layers"] = _stack(
            _block_params(cfg, generator, dtype, device), cfg.n_dense_layers)
    if cfg.family == "encdec":
        enc_one = {"norm1": zeros((d,)), "norm2": zeros((d,)),
                   "attn": _attn_params(cfg, generator, dtype, device),
                   "mlp": _mlp_params(cfg, generator, dtype, device)}
        params["enc_layers"] = _stack(enc_one, cfg.n_enc_layers)
        params["enc_norm"] = zeros((d,))
        params["enc_pos"] = init((cfg.enc_seq, d), 0.02)
        # decoder blocks additionally carry cross-attention
        cross = {"norm_x": zeros((d,)),
                 "xattn": _attn_params(cfg, generator, dtype, device)}
        params["layers"].update(_stack(cross, cfg.n_layers))
        # learned decoder positions sized for the largest decode cell
        params["dec_pos"] = init((32768, d), 0.02)
    return params


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def layer(params: Params, i: int, stack: str = "layers") -> Params:
    """Layer ``i``'s parameters of ``params[stack]`` (``"layers"``,
    whisper's ``"enc_layers"`` or the moe family's ``"dense_layers"``),
    nested dicts and all: views into the
    ``[L, ...]`` stacks (or the ``i``-th entry where a stack is held as a
    sequence of per-layer tensors, as the train step holds it). For
    gemma2, layer ``i`` is the ``{"local", "global"}`` pair ``i``."""
    return _index(params[stack], i)


def depth(params: Params, stack: str = "layers") -> int:
    """The number of entries of ``params[stack]``: layers, or gemma2's
    local/global pairs."""
    tree = params[stack]
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    h = torch.einsum("bsd,df->bsf", x, p["wi"])
    if "wg" in p:
        h = a(torch.einsum("bsd,df->bsf", x, p["wg"])) * h
    else:
        h = a(h)
    return torch.einsum("bsf,fd->bsd", h, p["wo2"])


def _attn_block(cfg: ModelConfig, p: Params, x: torch.Tensor, positions,
                *, causal: bool, window: int) -> torch.Tensor:
    B, S, _ = x.shape
    if cfg.use_mla:
        o = attn.mla_attention(cfg, p, attn.mla_project(cfg, p, x,
                                                        positions),
                               causal=causal)
    else:
        q, k, v = attn.gqa_qkv(cfg, p, x, positions)
        o = attn.blockwise_attention(q, k, v, causal=causal, window=window,
                                     cap=cfg.attn_softcap)
        o = o.permute(0, 2, 1, 3).reshape(B, S, cfg.q_dim)
    return torch.einsum("bsq,qd->bsd", o, p["wo"])


def hybrid_mix(cfg: ModelConfig, p: Params, a: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
    """Hymba's mean of the normalized attention and SSM outputs, scaled
    by the float32 0-d ``beta_attn`` / ``beta_ssm``. The reference
    computes it in float32 (JAX promotes a float32 array times a bf16
    one to float32; PyTorch would keep a 0-d tensor's product in bf16),
    so the normalized outputs are cast up before the betas meet them."""
    return (p["beta_attn"] * rmsnorm(a, p["norm_attn"], cfg.norm_eps).to(
        torch.float32) + p["beta_ssm"] * rmsnorm(
            m, p["norm_ssm"], cfg.norm_eps).to(torch.float32)) * 0.5


def _dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor, positions,
                 *, window: int, use_moe: bool = False,
                 data=None) -> torch.Tensor:
    """Attention, then the FFN (the MoE block when ``use_moe``, routed
    over the data axis ``data``, whose ``MoEStats`` are dropped as the
    reference drops them), each with its residual."""
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    a = _attn_block(cfg, p["attn"], h, positions, causal=True, window=window)
    if cfg.family == "hybrid":
        m, _ = ssmlib.mamba_head(
            cfg, p["ssm"], h,
            ssmlib.mamba_zero_state(cfg, x.shape[0], device=x.device))
        a = hybrid_mix(cfg, p["ssm"], a, m).to(x.dtype)
    if "norm_post1" in p:
        a = rmsnorm(a, p["norm_post1"], cfg.norm_eps)
    x = x + a
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    if use_moe:
        f, _ = moelib.moe_ffn(cfg, p["moe"], h, data=data)
    else:
        f = _mlp(cfg, p["mlp"], h)
    if "norm_post2" in p:
        f = rmsnorm(f, p["norm_post2"], cfg.norm_eps)
    return x + f


def _pair_block(cfg: ModelConfig, positions, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    """gemma2's layer pair: a sliding-window layer, then a global one."""
    x = _dense_block(cfg, p["local"], x, positions, window=cfg.window)
    return _dense_block(cfg, p["global"], x, positions, window=0)


def _enc_block(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder layer: bidirectional attention at positions 0
    (RoPE is the identity there; the encoder's positions are the learned
    ``enc_pos``), then the MLP."""
    B, S, _ = h.shape
    hn = rmsnorm(h, p["norm1"], cfg.norm_eps)
    q, k, v = attn.gqa_qkv(cfg, p["attn"], hn, torch.zeros(
        (B, S), dtype=torch.int32, device=h.device))
    o = attn.blockwise_attention(q, k, v, causal=False, window=0)
    o = o.permute(0, 2, 1, 3).reshape(B, S, cfg.q_dim)
    h = h + torch.einsum("bsq,qd->bsd", o, p["attn"]["wo"])
    hn = rmsnorm(h, p["norm2"], cfg.norm_eps)
    return h + _mlp(cfg, p["mlp"], hn)


def cross_heads(cfg: ModelConfig, p: Params, enc_out: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's k and v ``[B, Hkv, enc_seq, Dh]`` of one
    decoder layer: ``wk`` / ``wv`` without the biases, no RoPE."""
    B = enc_out.shape[0]

    def heads(w):
        return torch.einsum("bsd,dk->bsk", enc_out, w).reshape(
            B, -1, cfg.n_kv_heads, cfg.d_head).permute(0, 2, 1, 3)
    return heads(p["wk"]), heads(p["wv"])


def _encdec_block(cfg: ModelConfig, enc_out: torch.Tensor, positions,
                  p: Params, h: torch.Tensor) -> torch.Tensor:
    """Whisper's decoder layer: self-attention → cross-attention → MLP
    (the decode path in ``serving/decode.py`` mirrors this order)."""
    B, S, _ = h.shape
    hn = rmsnorm(h, p["norm1"], cfg.norm_eps)
    h = h + _attn_block(cfg, p["attn"], hn, positions, causal=True,
                        window=0)
    hn = rmsnorm(h, p["norm_x"], cfg.norm_eps)
    q = torch.einsum("bsd,dq->bsq", hn, p["xattn"]["wq"]).reshape(
        B, S, cfg.n_heads, cfg.d_head).permute(0, 2, 1, 3)
    k, v = cross_heads(cfg, p["xattn"], enc_out)
    o = attn.blockwise_attention(q, k, v, causal=False, window=0)
    o = o.permute(0, 2, 1, 3).reshape(B, S, cfg.q_dim)
    h = h + torch.einsum("bsq,qd->bsd", o, p["xattn"]["wo"])
    hn = rmsnorm(h, p["norm2"], cfg.norm_eps)
    return h + _mlp(cfg, p["mlp"], hn)


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


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, *,
           remat_policy: Optional[str] = None) -> torch.Tensor:
    """Whisper's encoder: ``frames [B, enc_seq, d]`` (the stubbed
    frontend's output) → the normed encoder states, in the params'
    dtype."""
    f = frames.to(params["embed"].dtype)
    e = f + params["enc_pos"][None, :f.shape[1]]
    e = _run_layers(params, "enc_layers", functools.partial(_enc_block, cfg),
                    e, remat_policy)
    return rmsnorm(e, params["enc_norm"], cfg.norm_eps)


def _run_layers(params: Params, stack: str, block: Callable,
                x: torch.Tensor, remat_policy: Optional[str]
                ) -> torch.Tensor:
    """``x`` through ``block(layer_params, x)`` for each entry of
    ``params[stack]``, each under ``_remat``."""
    for i in range(depth(params, stack)):
        x = _remat(functools.partial(block, layer(params, i, stack)),
                   remat_policy)(x)
    return x


def forward(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *,
            remat_policy: Optional[str] = "dots",
            data=None) -> torch.Tensor:
    """Training/prefill forward → logits [B, S, vocab_padded].

    ``batch``: {"tokens": [B,S]} or {"embeds": [B,S,d]} (qwen2-vl's
    modality stub), plus {"frames": [B,enc_seq,d]} for the enc-dec
    family. The moe family runs its ``dense_layers`` first, then its
    MoE ``layers``. rwkv6's time-mix runs one ``wkv6`` scan a layer over the
    whole sequence; the other families launch no kernel of
    ``kernels/csrc`` (their attention and Mamba scan are plain PyTorch,
    as the reference's are plain JAX). Under autograd each layer is
    checkpointed by ``remat_policy`` (``_remat``), which does not change
    the values; under ``torch.no_grad()`` it costs nothing. ``data``:
    the data axis ``batch``'s rows are one block of (the MoE layers'
    capacity and drop order are then the global batch's).
    """
    if "embeds" in batch:
        x = batch["embeds"].to(params["embed"].dtype)
        B, S, _ = x.shape
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    window = cfg.window if cfg.layer_pattern == "swa" else 0

    if cfg.family == "ssm":
        block = functools.partial(_rwkv_block, cfg)
    elif cfg.layer_pattern == "alt_local_global":
        block = functools.partial(_pair_block, cfg, positions)
    elif cfg.family == "encdec":
        enc_out = encode(cfg, params, batch["frames"],
                         remat_policy=remat_policy)
        x = x + params["dec_pos"][None, :S]
        block = functools.partial(_encdec_block, cfg, enc_out, positions)
    else:
        use_moe = cfg.family == "moe"
        if use_moe and "dense_layers" in params:
            def dblock(p, h):
                return _dense_block(cfg, p, h, positions, window=window)
            x = _run_layers(params, "dense_layers", dblock, x, remat_policy)

        def block(p, h):
            return _dense_block(cfg, p, h, positions, window=window,
                                use_moe=use_moe, data=data)
    x = _run_layers(params, "layers", block, x, remat_policy)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return softcap(logits, cfg.logit_softcap)


def loss_fn(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *,
            remat_policy: Optional[str] = "dots",
            data=None) -> torch.Tensor:
    """Next-token cross entropy over the logical vocab, in float32, as a
    mean over the positions ``batch["loss_mask"]`` weights (all of them
    when it is absent).

    ``data`` (a data axis of more than one rank, ``engine.ModelAxis``:
    ``batch`` is this rank's block of the global batch's rows) divides
    this rank's sum by the global batch's mask count (summed over the
    axis, then clamped at 1), so the ranks' losses and gradients add up
    to the global mean's, and routes the MoE layers over it."""
    logits = forward(cfg, params, batch, remat_policy=remat_policy,
                     data=data)
    labels = batch["labels"].long()
    logits = logits[..., :cfg.vocab].to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(lse) if mask is None else mask.to(torch.float32)
    count = torch.sum(mask)
    if data is not None:
        count = data.psum(count)
    return torch.sum((lse - gold) * mask) / torch.clamp(count, min=1.0)
