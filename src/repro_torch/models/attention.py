"""Attention flavours: GQA (bias, softcap, sliding window), MLA, cross.

The port of the JAX package's ``models/attention.py``.
Full-sequence attention is computed **blockwise** (flash-style online
softmax over KV chunks), so a 32K-token prefill never materializes an
[S, S] score matrix; decode attends densely over the cache (an [B, H, S]
row is cheap). The chunk schedule is the reference's and static: the
causal upper bound and a sliding window's lower bound skip KV chunks
that lie wholly outside, so window work is skipped, not masked.

Scores and values run in float32 (``torch.einsum``; TF32 stays off,
``resolve_device``), and the scores are divided by a float32 ``sqrt(D)``
held on the scores' device: a Python or CPU scalar divisor becomes a
multiply by its reciprocal on the card, which rounds otherwise when
``sqrt(D)`` is inexact (``d_head`` 120). Masked scores take the
reference's finite ``NEG_INF``: a window's first chunk can mask a row
whole, and ``-inf`` would then give ``exp(-inf - -inf)`` = NaN, where
the finite value gives a partial that the next chunk's rescale wipes
out.

MLA (deepseek-v2): ``mla_project`` makes the per-head queries (through
the ``q_lora`` bottleneck), the compressed latent ``c_kv`` and one rope
key shared by all heads; ``mla_attention`` expands the latent into
per-head keys and values for prefill and runs ``blockwise_attention``
with D = d_nope + d_rope (192) and Dv = d_v (128). Decode keeps the
latent and attends in its space (``serving/decode._mla_decode``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softcap
from repro_torch.models.rope import apply_rope

NEG_INF = -2.0 ** 30


def _div_sqrt(s: torch.Tensor, D: int) -> torch.Tensor:
    """``s / sqrt(D)`` with the divisor a float32 tensor on ``s``'s
    device, so the card divides as the host does."""
    return s / torch.full((), D, dtype=torch.float32, device=s.device).sqrt()


def _online_chunk(q, k, v, mask, cap):
    """One flash chunk: q [B,Hq,Tq,D], k/v [B,Hkv,Tk,D], mask [Tq,Tk]|None.

    Returns (scores_max [B,Hkv,G,Tq], exp_sum, acc [B,Hkv,G,Tq,Dv])
    partials.
    """
    G = q.shape[1] // k.shape[1]
    B, Hkv, Tk, D = k.shape
    qg = q.reshape(B, Hkv, G, q.shape[2], D)
    s = _div_sqrt(torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                               k.to(torch.float32)), D)
    s = softcap(s, cap)
    if mask is not None:
        s = torch.where(mask[None, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.to(torch.float32))
    return m, l, acc


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0, cap: float = 0.0,
                        q_chunk: int = 1024, kv_chunk: int = 1024
                        ) -> torch.Tensor:
    """q [B,Hq,S,D], k/v [B,Hkv,S,Dk/Dv] → [B,Hq,S,Dv]. GQA via head groups.

    ``window`` > 0 ⇒ token i attends to (i-window, i]; KV chunks wholly
    outside the window are not computed at all.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    dtype = q.dtype
    # the chunks' float32 casts, once for all chunks (same values)
    q, k, v = (a.to(torch.float32) for a in (q, k, v))
    if causal and Sq != Sk:
        raise ValueError("causal attention requires equal q/k lengths")
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    n_q = (Sq + q_chunk - 1) // q_chunk
    n_k = (Sk + kv_chunk - 1) // kv_chunk
    dev = q.device
    out = []
    for qi in range(n_q):
        q0 = qi * q_chunk
        qs = q[:, :, q0:q0 + q_chunk]
        Tq = qs.shape[2]
        # static KV range for this q chunk
        k_hi = n_k if not causal else (q0 + Tq + kv_chunk - 1) // kv_chunk
        k_lo = 0
        if window > 0:
            k_lo = max(0, (q0 - window) // kv_chunk)
        m_run = torch.full((B, Hkv, G, Tq), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, Hkv, G, Tq), dtype=torch.float32, device=dev)
        a_run = torch.zeros((B, Hkv, G, Tq, Dv), dtype=torch.float32,
                            device=dev)
        qpos = q0 + torch.arange(Tq, device=dev)
        for ki in range(k_lo, k_hi):
            k0 = ki * kv_chunk
            ks = k[:, :, k0:k0 + kv_chunk]
            vs = v[:, :, k0:k0 + kv_chunk]
            Tk = ks.shape[2]
            kpos = k0 + torch.arange(Tk, device=dev)
            mask = None
            if causal:
                mask = qpos[:, None] >= kpos[None, :]
            if window > 0:
                inside = qpos[:, None] - kpos[None, :] < window
                mask = inside if mask is None else mask & inside
            m, l, acc = _online_chunk(qs, ks, vs, mask, cap)
            m_new = torch.maximum(m_run, m)
            sc_old = torch.exp(m_run - m_new)
            sc_new = torch.exp(m - m_new)
            l_run = l_run * sc_old + l * sc_new
            a_run = a_run * sc_old[..., None] + acc * sc_new[..., None]
            m_run = m_new
        o = a_run / torch.clamp(l_run[..., None], min=1e-30)
        out.append(o.reshape(B, Hq, Tq, Dv))
    return torch.cat(out, dim=2).to(dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor, *,
                     cap: float = 0.0) -> torch.Tensor:
    """Single-token decode: q [B,Hq,1,D], caches [B,Hkv,S,D*].

    ``length`` [B] masks the not-yet-written tail of the cache.
    """
    B, Hq, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D)
    s = _div_sqrt(torch.einsum("bhgd,bhkd->bhgk", qg.to(torch.float32),
                               k_cache.to(torch.float32)), D)
    s = softcap(s, cap)
    valid = torch.arange(S, device=q.device)[None, :] < length[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.to(torch.float32))
    return o.reshape(B, Hq, 1, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# projection helpers (params are dicts of stacked tensors; transformer.py)
# ---------------------------------------------------------------------------

def gqa_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
            positions: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,d] → q [B,H,S,Dh], k/v [B,Hkv,S,Dh] with RoPE applied."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dq->bsq", x, p["wq"])
    k = torch.einsum("bsd,dk->bsk", x, p["wk"])
    v = torch.einsum("bsd,dk->bsk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return (q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3),
            v.permute(0, 2, 1, 3))


class MLAProj(NamedTuple):
    q_nope: torch.Tensor   # [B, H, S, d_nope]
    q_rope: torch.Tensor   # [B, H, S, d_rope]
    c_kv: torch.Tensor     # [B, S, kv_lora]    the compressed cache
    k_rope: torch.Tensor   # [B, S, d_rope]     shared across heads


def mla_project(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor) -> MLAProj:
    """DeepSeek-V2 multi-head latent attention projections."""
    B, S, _ = x.shape
    H = cfg.n_heads
    if cfg.q_lora:
        cq = torch.einsum("bsd,dr->bsr", x, p["wq_a"])
        q = torch.einsum("bsr,rq->bsq", cq, p["wq_b"])
    else:
        q = torch.einsum("bsd,dq->bsq", x, p["wq"])
    q = q.reshape(B, S, H, cfg.mla_d_nope + cfg.rope_head_dim)
    q_nope, q_rope = torch.split(q, [cfg.mla_d_nope, cfg.rope_head_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckr = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv, k_rope = torch.split(ckr, [cfg.kv_lora, cfg.rope_head_dim],
                               dim=-1)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return MLAProj(q_nope.permute(0, 2, 1, 3), q_rope.permute(0, 2, 1, 3),
                   c_kv, k_rope)


def mla_attention(cfg: ModelConfig, p: dict, proj: MLAProj, *,
                  causal: bool = True, q_chunk: int = 1024,
                  kv_chunk: int = 1024) -> torch.Tensor:
    """Per-head K/V materialized from the latent through ``wkv_b``'s two
    halves, then blockwise attention. Returns [B, S, H·d_v]."""
    B, H, S, _ = proj.q_nope.shape
    wk = p["wkv_b"][:, :H * cfg.mla_d_nope]
    wv = p["wkv_b"][:, H * cfg.mla_d_nope:]
    k_nope = torch.einsum("bsr,rk->bsk", proj.c_kv, wk).reshape(
        B, S, H, cfg.mla_d_nope).permute(0, 2, 1, 3)
    v = torch.einsum("bsr,rk->bsk", proj.c_kv, wv).reshape(
        B, S, H, cfg.mla_d_v).permute(0, 2, 1, 3)
    k_rope = proj.k_rope[:, None].expand(B, H, S, cfg.rope_head_dim)
    q = torch.cat([proj.q_nope, proj.q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    o = blockwise_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    return o.permute(0, 2, 1, 3).reshape(B, S, H * cfg.mla_d_v)
