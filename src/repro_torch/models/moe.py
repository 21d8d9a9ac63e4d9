"""Mixture-of-experts block (DeepSeek-style: shared + fine-grained routed).

The port of the JAX package's ``models/moe.py``. Dispatch is the
sort-based fixed-capacity formulation: the (token, slot) pairs are
sorted by expert (stably, so a token's pairs keep their order), each
pair takes the next of its expert's ``C`` slots in an ``[E, C, d]``
buffer, each expert runs one [C, d] × [d, de] product (``torch.bmm``
over the experts), and the results come back weighted by the router's
gate. Pairs past an expert's capacity are dropped and counted.

Three places differ in form from the reference and keep its values:
- ``route_topk`` takes the top k by a stable descending sort, so tied
  scores put the lower expert id first as ``jax.lax.top_k`` does
  (``torch.topk`` promises no order for ties).
- The dispatch writes each kept pair's row into its own slot instead of
  scatter-adding every pair (a dropped pair adds a zero row in the
  reference): the kept slots are distinct, so the rows land as they
  are, and no atomic add runs on the card. Dropped pairs write to a
  spare row past the buffer that is then cut off.
- The combine adds each token's k weighted contributions left to right
  in ``x.dtype``, in the order the reference's scatter-add meets them
  (ascending expert id: the sort is stable), instead of an atomic,
  unordered ``index_add_``: a bf16 prefill gives the same bits on every
  run. (``torch.sum`` over k would accumulate bf16 in float32 and round
  once, which is not the reference's rounding.)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn


class MoEStats(NamedTuple):
    dropped_frac: torch.Tensor   # fraction of (token, slot) pairs dropped
    load: torch.Tensor           # [E] int32 pairs per expert (pre-capacity)


def route_topk(scores: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """softmax-after-topk routing (DeepSeek-MoE): [T, E] → ids (int32)
    and gates [T, k], the ids in descending score order, ties to the
    lower id."""
    top, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, ids = top[..., :k], ids[..., :k]
    return ids.to(torch.int32), torch.softmax(top, dim=-1)


def router_scores(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The float32 router's softmax over all experts: x [..., d] →
    [..., E], ``x`` cast to float32 first."""
    return torch.softmax(torch.einsum(
        "td,de->te", x.to(torch.float32), p["router"].to(torch.float32)),
        dim=-1)


def shared_experts(cfg: ModelConfig, p: dict, xt: torch.Tensor
                   ) -> torch.Tensor:
    """The always-on dense FFN of the shared experts: [T, d] → [T, d]."""
    act = act_fn(cfg.act)
    hs = act(torch.einsum("td,df->tf", xt, p["sh_wg"])) * \
        torch.einsum("td,df->tf", xt, p["sh_wi"])
    return torch.einsum("tf,fd->td", hs, p["sh_wo"])


def capacity(cfg: ModelConfig, T: int,
             capacity_factor: Optional[float] = None,
             deterministic_capacity: Optional[int] = None) -> int:
    """Each expert's slots ``C`` for ``T`` tokens, reckoned in Python
    floats as the reference does."""
    cf = capacity_factor if capacity_factor is not None \
        else cfg.capacity_factor
    return deterministic_capacity or max(
        1, int(T * cfg.top_k * cf / cfg.n_experts))


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
            capacity_factor: Optional[float] = None,
            deterministic_capacity: Optional[int] = None
            ) -> tuple[torch.Tensor, MoEStats]:
    """x [B, S, d] → ([B, S, d], MoEStats).

    Params: ``router`` [d, E] (float32); routed experts ``wi`` / ``wg``
    [E, d, de], ``wo`` [E, de, d]; shared experts ``sh_wi`` / ``sh_wg``
    [d, n_sh·de], ``sh_wo`` [n_sh·de, d].
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xt = x.reshape(T, d)
    act = act_fn(cfg.act)

    ids, gates = route_topk(router_scores(p, xt), k)       # [T, k]
    C = capacity(cfg, T, capacity_factor, deterministic_capacity)
    # ---- sort (token, slot) pairs by expert id
    flat_e = ids.reshape(-1).long()                        # [T·k]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k                                        # the pair's token
    # each expert's segment [bounds[e], bounds[e + 1]) and each pair's
    # position in it (no host sync: ``bincount`` would wait for a max)
    bounds = torch.searchsorted(se, torch.arange(E + 1, device=dev))
    pos = torch.arange(T * k, device=dev) - bounds[se]
    keep = pos < C
    load = torch.diff(bounds).to(torch.int32)

    # ---- dispatch into [E, C, d]: kept rows into their own slots, the
    # dropped ones into the spare row E·C
    slot = torch.where(keep, se * C + pos, E * C)
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xt[st]
    buf = buf[:E * C].view(E, C, d)

    # ---- expert products
    h = act(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    y = torch.bmm(h, p["wo"]).reshape(E * C, d)            # [E·C, d]

    # ---- combine: each token's pairs in ascending expert order (the
    # reference's scatter order), added left to right in x.dtype
    slot_tk = torch.empty_like(slot)
    slot_tk[order] = slot
    slot_tk = slot_tk.view(T, k)
    by_e = torch.argsort(ids, dim=-1)                      # ids are distinct
    slot_tk = torch.gather(slot_tk, 1, by_e)
    gate_tk = torch.gather(gates, 1, by_e).to(x.dtype)
    kept = slot_tk < E * C
    rows = y[torch.where(kept, slot_tk, 0)]                # [T, k, d]
    contrib = torch.where(kept[..., None], rows * gate_tk[..., None], 0)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]

    # ---- shared experts (always-on dense path)
    if cfg.n_shared_experts:
        out = out + shared_experts(cfg, p, xt)

    # the mean as the reference's lowering computes it: the sum times a
    # float32 reciprocal of the count (a division rounds otherwise)
    kept_frac = torch.sum(keep.to(torch.float32)) * torch.full(
        (), T * k, dtype=torch.float32, device=dev).reciprocal()
    stats = MoEStats(dropped_frac=1.0 - kept_frac, load=load)
    return out.reshape(B, S, d), stats
