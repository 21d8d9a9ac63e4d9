"""Single-token decode steps for the ported families.

The port of the JAX package's ``serving/decode.py``: one new token
against the carried cache, layer by layer in a Python loop (the
reference scans the stacked layers). rwkv6's time-mix is one recurrence
step in plain tensor code (S == 1), so decode launches no ``wkv6``
kernel; attention decodes densely over the cache, float32 scores with
the not-yet-written tail masked, and a windowed layer writes its ring
slot ``pos % S``.

Like the reference, a step returns a new cache and leaves the one it
was given as it was: each k/v stack is copied once at the top of the
step and the new token's slot written into the copy, so two caches are
alive during a step. The pieces a step does not change (whisper's cross
``xk`` / ``xv``) are shared between the two. ``pos`` stays a 0-d tensor
on the cache's device: no step waits for the host.

The moe family: its leading dense layers run first, over their own
cache (``dense``, or the first ``n_dense_layers`` of MLA's stacks). MLA
decode (``_mla_decode``) uses weight absorption: scores and values are
computed against the latent cache itself (``q_nope`` folded through
W_uk, the output through W_uv), so a step reads kv_lora + d_rope values
a token a layer. Decode's MoE (``_moe1``) gathers each row's k experts'
weights and has no capacity.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import ssm as ssmlib
from repro_torch.models.attention import NEG_INF, _div_sqrt, decode_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn, rmsnorm, softcap
from repro_torch.models.moe import route_topk, router_scores, shared_experts
from repro_torch.models.rope import apply_rope
from repro_torch.models.transformer import depth, hybrid_mix, layer
from repro_torch.serving.kvcache import Cache

Params = Dict[str, Any]


def _proj_heads(x, w, b, n, d):
    y = torch.einsum("bd,de->be", x, w)
    if b is not None:
        y = y + b
    return y.reshape(x.shape[0], n, d)


def _gqa_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
                window: int) -> torch.Tensor:
    """h [B, d] → attn_out [B, d]. Writes the token's k/v into ``kc`` /
    ``vc`` ([B, Hkv, S, Dh], a layer of the step's new cache) at slot
    ``pos % S`` if windowed (a ring), else ``min(pos, S - 1)``, then
    attends over the first ``min(pos + 1, S)`` slots."""
    B = h.shape[0]
    posv = pos.expand(B)
    q = _proj_heads(h, p["wq"], p.get("bq"), cfg.n_heads, cfg.d_head)
    k = _proj_heads(h, p["wk"], p.get("bk"), cfg.n_kv_heads, cfg.d_head)
    v = _proj_heads(h, p["wv"], p.get("bv"), cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q[:, None], posv[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], posv[:, None], cfg.rope_theta)[:, 0]
    S = kc.shape[2]
    slot = (pos % S) if window else torch.clamp(pos, max=S - 1)
    slot = slot.long().reshape(1)
    kc.index_copy_(2, slot, k[:, :, None].to(kc.dtype))
    vc.index_copy_(2, slot, v[:, :, None].to(vc.dtype))
    length = torch.clamp(pos + 1, max=S).expand(B)
    o = decode_attention(q.reshape(B, cfg.n_heads, 1, cfg.d_head), kc, vc,
                         length, cap=cfg.attn_softcap)
    o = o.reshape(B, cfg.q_dim)
    return torch.einsum("bq,qd->bd", o, p["wo"])


def _write_slot(c: torch.Tensor, pos: torch.Tensor, new: torch.Tensor
                ) -> None:
    """``c[:, pos] = new`` in place (``c`` [B, S, r]); past the last slot
    the write is dropped, as JAX drops an out-of-range write: slot S - 1
    is then written with its own value, so no index past S reaches the
    card and no step waits for the host."""
    S = c.shape[1]
    slot = torch.clamp(pos, max=S - 1).long().reshape(1)
    old = c.index_select(1, slot)
    c.index_copy_(1, slot, torch.where(pos < S, new[:, None].to(c.dtype),
                                       old))


def _mla_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                ckv: torch.Tensor, krope: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """h [B, d] → attn_out [B, d]. Writes the token's latent and rope key
    into ``ckv`` [B, S, kv_lora] / ``krope`` [B, S, d_rope] (a layer of
    the step's new cache) at ``pos``, then attends over slots ``<= pos``
    in the latent space, in float32."""
    B = h.shape[0]
    H = cfg.n_heads
    posv = pos.expand(B)
    if cfg.q_lora:
        q = torch.einsum("br,rq->bq", torch.einsum("bd,dr->br", h,
                                                   p["wq_a"]), p["wq_b"])
    else:
        q = torch.einsum("bd,dq->bq", h, p["wq"])
    q = q.reshape(B, H, cfg.mla_d_nope + cfg.rope_head_dim)
    q_nope, q_rope = torch.split(q, [cfg.mla_d_nope, cfg.rope_head_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope[:, None], posv[:, None], cfg.rope_theta)[:, 0]
    ckr = torch.einsum("bd,dr->br", h, p["wkv_a"])
    c_new, kr_new = torch.split(ckr, [cfg.kv_lora, cfg.rope_head_dim],
                                dim=-1)
    kr_new = apply_rope(kr_new[:, None, None, :], posv[:, None],
                        cfg.rope_theta)[:, 0, 0]
    _write_slot(ckv, pos, c_new)
    _write_slot(krope, pos, kr_new)
    # absorbed attention in latent space
    f32 = torch.float32
    wk = p["wkv_b"][:, :H * cfg.mla_d_nope].reshape(
        cfg.kv_lora, H, cfg.mla_d_nope)
    wv = p["wkv_b"][:, H * cfg.mla_d_nope:].reshape(
        cfg.kv_lora, H, cfg.mla_d_v)
    c32 = ckv.to(f32)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope.to(f32), wk.to(f32))
    s = torch.einsum("bhr,bsr->bhs", q_lat, c32)
    s = s + torch.einsum("bhe,bse->bhs", q_rope.to(f32), krope.to(f32))
    s = _div_sqrt(s, cfg.mla_d_nope + cfg.rope_head_dim)
    S = ckv.shape[1]
    valid = torch.arange(S, device=h.device)[None, None, :] <= pos
    w = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", w, c32)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv.to(f32))
    o = o.reshape(B, H * cfg.mla_d_v).to(h.dtype)
    return torch.einsum("bq,qd->bd", o, p["wo"])


def _mlp1(cfg, p, x):
    a = act_fn(cfg.act)
    hdn = torch.einsum("bd,df->bf", x, p["wi"])
    if "wg" in p:
        hdn = a(torch.einsum("bd,df->bf", x, p["wg"])) * hdn
    else:
        hdn = a(hdn)
    return torch.einsum("bf,fd->bd", hdn, p["wo2"])


def _moe1(cfg, p, x):
    """Decode-time MoE: each row's top-k experts' weights gathered
    (``[B, k, d, de]`` a weight), no capacity; then the shared
    experts."""
    ids, gates = route_topk(router_scores(p, x), cfg.top_k)   # [B, k]
    ids = ids.long()
    wi, wg, wo = p["wi"][ids], p["wg"][ids], p["wo"][ids]
    a = act_fn(cfg.act)
    h = a(torch.einsum("bd,bkdf->bkf", x, wg)) * \
        torch.einsum("bd,bkdf->bkf", x, wi)
    y = torch.einsum("bkf,bkfd->bkd", h, wo)
    out = torch.einsum("bkd,bk->bd", y, gates.to(x.dtype))
    if cfg.n_shared_experts:
        out = out + shared_experts(cfg, p, x)
    return out


def _ffn1(cfg, lp, x):
    """A layer's FFN on one token: its MoE block or its dense MLP."""
    return _moe1(cfg, lp["moe"], x) if "moe" in lp \
        else _mlp1(cfg, lp["mlp"], x)


def _post_norm(cfg, p, name, a):
    return rmsnorm(a, p[name], cfg.norm_eps) if name in p else a


def _half_pair(cfg, p, h, kc, vc, pos, window):
    """One half of gemma2's layer pair: attention (post-normed), then
    the MLP (post-normed), each with its residual."""
    hn = rmsnorm(h, p["norm1"], cfg.norm_eps)
    a = _gqa_decode(cfg, p["attn"], hn, kc, vc, pos, window)
    h = h + _post_norm(cfg, p, "norm_post1", a)
    hn = rmsnorm(h, p["norm2"], cfg.norm_eps)
    return h + _post_norm(cfg, p, "norm_post2", _mlp1(cfg, p["mlp"], hn))


def _rwkv_layers(cfg, params, cache, x):
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
    return x, dict(tm_shift=torch.stack(tm_s), cm_shift=torch.stack(cm_s),
                   wkv=torch.stack(wkv_s))


def _pair_layers(cfg, params, cache, x, pos):
    new = {half: {n: cache[half][n].clone() for n in ("k", "v")}
           for half in ("local", "global")}
    for i in range(depth(params)):
        lp = layer(params, i)
        x = _half_pair(cfg, lp["local"], x, new["local"]["k"][i],
                       new["local"]["v"][i], pos, cfg.window)
        x = _half_pair(cfg, lp["global"], x, new["global"]["k"][i],
                       new["global"]["v"][i], pos, 0)
    return x, new


def _mla_layers(cfg, params, cache, x, pos):
    """deepseek-v2's layers: MLA against the latent cache, then the FFN;
    ``dense_layers`` first, over the first ``n_dense_layers`` entries of
    ``ckv`` / ``krope``."""
    new = {"ckv": cache["ckv"].clone(), "krope": cache["krope"].clone()}
    li = 0
    for stack in [s for s in ("dense_layers", "layers") if s in params]:
        for i in range(depth(params, stack)):
            lp = layer(params, i, stack)
            hn = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            x = x + _mla_decode(cfg, lp["attn"], hn, new["ckv"][li],
                                new["krope"][li], pos)
            hn = rmsnorm(x, lp["norm2"], cfg.norm_eps)
            x = x + _ffn1(cfg, lp, hn)
            li += 1
    return x, new


def _dense_layers(cfg, params, cache, x, pos):
    """The dense, hybrid, encdec and non-MLA moe layers: self-attention
    (with hymba's parallel Mamba head, or whisper's cross-attention
    after it), then the FFN (the MLP or the MoE block). A moe cache's
    ``dense`` k/v stack serves ``dense_layers``, run first."""
    B = x.shape[0]
    window = cfg.window if cfg.layer_pattern == "swa" else 0
    new = {"k": cache["k"].clone(), "v": cache["v"].clone()}
    runs = [("layers", new)]
    if "dense" in cache:
        new["dense"] = {n: cache["dense"][n].clone() for n in ("k", "v")}
        runs.insert(0, ("dense_layers", new["dense"]))
    conv_s, ssm_s = [], []
    for stack, kv in runs:
        for i in range(depth(params, stack)):
            lp = layer(params, i, stack)
            hn = rmsnorm(x, lp["norm1"], cfg.norm_eps)
            a = _gqa_decode(cfg, lp["attn"], hn, kv["k"][i], kv["v"][i],
                            pos, window)
            if cfg.family == "hybrid":
                st = ssmlib.MambaState(conv=cache["conv"][i],
                                       h=cache["ssm_h"][i])
                m, st = ssmlib.mamba_head(cfg, lp["ssm"], hn[:, None], st)
                a = hybrid_mix(cfg, lp["ssm"], a, m[:, 0]).to(x.dtype)
                conv_s.append(st.conv)
                ssm_s.append(st.h)
            if cfg.family == "encdec":
                xk, xv = cache["xk"][i], cache["xv"][i]
                hn2 = rmsnorm(x + a, lp["norm_x"], cfg.norm_eps)
                q = _proj_heads(hn2, lp["xattn"]["wq"], None, cfg.n_heads,
                                cfg.d_head)
                o = decode_attention(
                    q[:, :, None, :], xk, xv,
                    torch.full((B,), xk.shape[2], dtype=torch.int32,
                               device=x.device))
                a = a + torch.einsum("bq,qd->bd", o.reshape(B, cfg.q_dim),
                                     lp["xattn"]["wo"])
            x = x + a
            hn = rmsnorm(x, lp["norm2"], cfg.norm_eps)
            x = x + _ffn1(cfg, lp, hn)
    if cfg.family == "hybrid":
        new.update(conv=torch.stack(conv_s), ssm_h=torch.stack(ssm_s))
    return x, new


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, 1] → (logits [B, vocab_padded], new cache)."""
    pos = cache["pos"]
    x = params["embed"][tokens[:, 0]]
    if cfg.family == "encdec":
        x = x + params["dec_pos"].index_select(0, pos.long().reshape(1))
    if cfg.family == "ssm":
        x, new = _rwkv_layers(cfg, params, cache, x)
    elif cfg.use_mla:
        x, new = _mla_layers(cfg, params, cache, x, pos)
    elif cfg.layer_pattern == "alt_local_global":
        x, new = _pair_layers(cfg, params, cache, x, pos)
    else:
        x, new = _dense_layers(cfg, params, cache, x, pos)
    new_cache = dict(cache, pos=pos + 1, **new)
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
