"""Rotary position embeddings (interleaved-pair convention).

The port of the JAX package's ``models/rope.py``: pairs are the even and
odd channels (``x[..., 0::2]``, ``x[..., 1::2]``), not the half-split
``rotate_half`` form, and the angles are float32 in the reference's
order (``theta ** (arange / D)``, then ``positions * freqs``, then
``cos`` / ``sin``).

M-RoPE (qwen2-vl): the vision frontend is a stub (the batch carries
``embeds``), so the backbone applies the temporal component, which for
text positions is standard RoPE.
"""
from __future__ import annotations

import torch


def rope_freqs(d_head: int, theta: float,
               device: str | torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., S, H, D], positions: [..., S] → same shape."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)             # [D/2]
    ang = positions[..., :, None].to(torch.float32) * freqs[None, :]
    cos = torch.cos(ang)[..., :, None, :]              # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
