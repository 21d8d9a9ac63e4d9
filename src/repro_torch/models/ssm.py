"""State-space blocks: RWKV-6 (Finch) and a Mamba head (for Hymba).

The port of the JAX package's ``models/ssm.py``, with its einsum orders
and float32 casts. RWKV-6 is attention-free: time-mix
(the WKV linear-attention scan with data-dependent per-channel decay,
``kernels.ops.wkv6``) + channel-mix. The data-dependent token-shift
interpolation uses the low-rank (LoRA) parameterization of the paper.

A sequence (S > 1) runs the chunked scan: on the card the CUDA kernel
``csrc/wkv6.cu``, on the CPU its plain version (the sequential scan). One
token (S == 1, decode) is one recurrence step against the carried state,
in plain tensor code, as in the reference.

The Mamba head is the selective-SSM recurrence (Δ, B, C data-dependent,
diagonal A) with a depthwise causal conv front; Hymba runs it in
parallel with sliding-window attention heads and mean-combines the
normalized outputs. Its scan is one step a token in a Python loop, as
the reference's ``lax.scan`` (plain code there too: no TPU kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm


class RWKVState(NamedTuple):
    tm_shift: torch.Tensor   # [B, d] last token (time-mix shift)
    cm_shift: torch.Tensor   # [B, d] last token (channel-mix shift)
    wkv: torch.Tensor        # [B, H, dk, dv] linear-attention state


def rwkv_zero_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device: str | torch.device = "cuda") -> RWKVState:
    device = resolve_device(device)
    H = cfg.n_heads
    dk = cfg.d_model // H
    return RWKVState(
        tm_shift=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        cm_shift=torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        wkv=torch.zeros((batch, H, dk, dk), dtype=torch.float32,
                        device=device),
    )


def _shifted(x: torch.Tensor, shift_in: torch.Tensor) -> torch.Tensor:
    """The previous token of each position: ``shift_in`` then x[:, :-1]."""
    return torch.cat([shift_in[:, None, :], x[:, :-1]], dim=1)


def _ddlerp(x, xx, mu, lora_a, lora_b):
    """Data-dependent interpolation (RWKV-6 token shift).

    x/xx: [B,S,d]; mu: [d]; lora_a: [d,r]; lora_b: [r,d].
    """
    base = x + (xx - x) * mu
    dyn = torch.tanh(torch.einsum("bsd,dr->bsr", base, lora_a))
    mix = mu + torch.einsum("bsr,rd->bsd", dyn, lora_b)
    return x + (xx - x) * mix


def rwkv_wkv_inputs(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    shift_in: torch.Tensor):
    """The scan's inputs of one time-mix: ``(r, k, v, w, u, g)`` with r,
    k, v, w ``[B·H, S, dk]`` (r, k, v in x's dtype, w float32), u
    ``[B·H, dk]`` float32 and the gate g ``[B, S, d]``."""
    B, S, d = x.shape
    H = cfg.n_heads
    dk = d // H
    xx = _shifted(x, shift_in)
    r_in = _ddlerp(x, xx, p["mu_r"], p["la_r"], p["lb_r"])
    k_in = _ddlerp(x, xx, p["mu_k"], p["la_k"], p["lb_k"])
    v_in = _ddlerp(x, xx, p["mu_v"], p["la_v"], p["lb_v"])
    w_in = _ddlerp(x, xx, p["mu_w"], p["la_w"], p["lb_w"])
    g_in = _ddlerp(x, xx, p["mu_g"], p["la_g"], p["lb_g"])

    r = torch.einsum("bsd,de->bse", r_in, p["wr"])
    k = torch.einsum("bsd,de->bse", k_in, p["wk"])
    v = torch.einsum("bsd,de->bse", v_in, p["wv"])
    g = F.silu(torch.einsum("bsd,de->bse", g_in, p["wg"]))
    # per-channel decay in (0,1): w = exp(-exp(wl))
    wl = p["w_base"] + torch.einsum(
        "bsr,rd->bsd",
        torch.tanh(torch.einsum("bsd,dr->bsr", w_in, p["la_wd"])),
        p["lb_wd"])
    w = torch.exp(-torch.exp(wl.to(torch.float32)))

    def heads(a):
        return a.reshape(B, S, H, dk).permute(0, 2, 1, 3).reshape(
            B * H, S, dk)

    u = p["u"][None].expand(B, H, dk).reshape(B * H, dk)
    return heads(r), heads(k), heads(v), heads(w), u, g


def rwkv_time_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                  shift_in: torch.Tensor, wkv_in: torch.Tensor):
    """x [B,S,d] → (out [B,S,d], last_token [B,d], wkv_out).

    For a sequence (S>1) the incoming wkv state is zero (sequence start);
    for decode (S=1) states thread through.
    """
    B, S, d = x.shape
    H = cfg.n_heads
    dk = d // H
    r, k, v, w, u, g = rwkv_wkv_inputs(cfg, p, x, shift_in)
    f32 = torch.float32
    if S == 1:
        # decode: one recurrence step against the carried state
        rt, kt, vt = r.to(f32)[:, 0], k.to(f32)[:, 0], v.to(f32)[:, 0]
        wt = w[:, 0]
        Sst = wkv_in.reshape(B * H, dk, dk)
        kv = kt[:, :, None] * vt[:, None, :]
        y = torch.einsum("nd,nde->ne", rt, Sst + u[:, :, None] * kv)
        S_new = wt[:, :, None] * Sst + kv
        wkv_out = S_new.reshape(B, H, dk, dk)
        o = y.reshape(B, H, 1, dk)
    else:
        y = ops.wkv6(r.to(f32), k.to(f32), v.to(f32), w, u)
        o = y.reshape(B, H, S, dk)
        wkv_out = wkv_in  # a sequence does not thread state across calls
    o = o.permute(0, 2, 1, 3)                          # [B,S,H,dk]
    # per-head group norm, then output gate + projection
    o = rmsnorm(o, p["ln_x"].reshape(H, dk), cfg.norm_eps)
    o = o.reshape(B, S, d).to(x.dtype) * g
    out = torch.einsum("bse,ed->bsd", o, p["wo"])
    return out, x[:, -1, :], wkv_out


def rwkv_channel_mix(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     shift_in: torch.Tensor):
    xx = _shifted(x, shift_in)
    xk = x + (xx - x) * p["mu_ck"]
    xr = x + (xx - x) * p["mu_cr"]
    k = torch.einsum("bsd,df->bsf", xk, p["wck"])
    k = torch.square(F.relu(k))
    kv = torch.einsum("bsf,fd->bsd", k, p["wcv"])
    out = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["wcr"])) * kv
    return out, x[:, -1, :]


# ---------------------------------------------------------------------------
# Mamba head (Hymba's parallel SSM)
# ---------------------------------------------------------------------------

class MambaState(NamedTuple):
    conv: torch.Tensor   # [B, K-1, di] conv tail
    h: torch.Tensor      # [B, di, N] SSM state


def mamba_zero_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device: str | torch.device = "cuda") -> MambaState:
    device = resolve_device(device)
    di = cfg.d_model * cfg.ssm_expand
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                      device=device),
    )


def mamba_head(cfg: ModelConfig, p: dict, x: torch.Tensor,
               state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """Selective SSM: x [B,S,d] → (y [B,S,di→d], new state)."""
    B, S, d = x.shape
    xz = torch.einsum("bsd,de->bse", x, p["w_in"])     # [B,S,2di]
    xs, z = torch.chunk(xz, 2, dim=-1)
    # depthwise causal conv (kernel K) with carried tail; the sum starts
    # from 0 over the taps, as the reference's Python ``sum``
    K = cfg.ssm_conv
    ext = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
    conv = sum(ext[:, i:i + S] * p["conv_w"][i][None, None, :]
               for i in range(K)) + p["conv_b"]
    xs = F.silu(conv)
    new_tail = ext[:, -(K - 1):] if K > 1 else state.conv

    dt = F.softplus(torch.einsum("bse,er->bsr", xs, p["w_dt_a"])
                    @ p["w_dt_b"] + p["dt_bias"])      # [B,S,di]
    Bm = torch.einsum("bse,en->bsn", xs, p["w_B"])     # [B,S,N]
    Cm = torch.einsum("bse,en->bsn", xs, p["w_C"])
    A = -torch.exp(p["A_log"].to(torch.float32))       # [di,N]

    f32 = torch.float32
    xs32, dt32, B32, C32 = (a.to(f32) for a in (xs, dt, Bm, Cm))
    h = state.h
    ys = []
    for t in range(S):
        xt, dtt, Bt, Ct = xs32[:, t], dt32[:, t], B32[:, t], C32[:, t]
        dA = torch.exp(dtt[:, :, None] * A[None])     # [B,di,N]
        h = h * dA + (dtt * xt)[:, :, None] * Bt[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Ct))
    y = torch.stack(ys, dim=1).to(x.dtype)             # [B,S,di]
    y = y + xs * p["D"]
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"])
    return out, MambaState(conv=new_tail, h=h)
