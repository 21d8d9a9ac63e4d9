"""int8 gradient compression with stochastic rounding (cross-node option).

The port of the JAX package's ``training/compression.py``. Where the
gradient all-reduce crosses slower links, a per-tensor-scaled int8
encode cuts those bytes 4× (from float32; 2× from bf16). Stochastic
rounding keeps the quantizer unbiased, so SGD/Adam convergence holds in
expectation. The draws come from an explicit ``torch.Generator``;
``quantize(g, uniforms)`` is the rounding alone, so a test can hand it
the reference's own uniforms and compare the codes bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training import tree


def quantize(g: torch.Tensor, uniforms: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g → (int8 codes, scale) with ``uniforms`` (float32 in [0, 1), g's
    shape) as the rounding draws: x = g / scale rounds up where its draw
    is below its fractional part. scale = absmax / 127."""
    g32 = g.to(torch.float32)
    scale = torch.max(torch.abs(g32)) / 127.0 + 1e-30
    x = g32 / scale
    lo = torch.floor(x)
    p_up = x - lo
    q = lo + (uniforms < p_up).to(torch.float32)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def encode(g: torch.Tensor, generator: torch.Generator
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g → (int8 codes, scale), the draws taken from ``generator`` (on
    g's device)."""
    u = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                   device=g.device)
    return quantize(g, u)


def decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def encode_tree(grads: Any, generator: torch.Generator
                ) -> Tuple[Any, Any]:
    """Every leaf of a nested dict encoded, in sorted-key order, with
    draws taken one leaf after another from ``generator``."""
    enc = {k: encode(g, generator) for k, g in tree.leaves(grads)}
    return (tree.rebuild(grads, lambda k, _: enc[k][0]),
            tree.rebuild(grads, lambda k, _: enc[k][1]))


def decode_tree(qs: Any, scales: Any) -> Any:
    by_key = dict(tree.leaves(scales))
    return tree.rebuild(qs, lambda k, q: decode(q, by_key[k]))
