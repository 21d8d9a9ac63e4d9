"""A rank's blocks of a sharded tree, and the whole leaves back.

A spec (``launch/sharding.py``'s rules) is a tuple with one entry a
dim: an axis name, a tuple of names (the dim split over their product,
the first the major one) or None. ``mesh`` is ``launch.mesh.Mesh`` or
anything with the named axes as attributes, each an ``index``, a
``size`` and an ``all_gather`` (``core.engine.ModelAxis``). Block *i* of
a dim goes to the rank whose index on its axis is *i*, as
``jax.NamedSharding`` lays it out.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.training import tree


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``spec``: a view
    (``.contiguous()`` it to store it). Each named dim is cut into
    equal blocks over its axes (``Mesh.data`` / ``Mesh.model``: an
    ``index`` and a ``size`` each), the first name the major one."""
    for dim, entry in enumerate(spec):
        idx, n = 0, 1
        for name in _names(entry):
            ax = getattr(mesh, name)
            idx, n = idx * ax.size + ax.index, n * ax.size
        if n > 1:
            b = x.shape[dim] // n
            x = x.narrow(dim, idx * b, b)
    return x


def gather_leaf(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's ``shard_leaf`` block: one
    all-gather a named axis over its group (the minor name first), in
    axis-index order. A replicated leaf comes back as it is."""
    x = shard
    for dim, entry in enumerate(spec):
        for name in reversed(_names(entry)):
            x = getattr(mesh, name).all_gather(x, dim)
    return x


def shard_tree(state: Any, specs: Any, mesh) -> Any:
    """Each leaf of the whole ``state`` replaced by a contiguous copy of
    this rank's block (a replicated leaf: a copy of it)."""
    flat = dict(tree.leaves(specs))
    return tree.rebuild(state, lambda key, x: shard_leaf(
        x, flat[key], mesh).clone(memory_format=torch.contiguous_format))


def gather_tree(state: Any, specs: Any, mesh) -> Any:
    """The whole leaves of a sharded ``state`` (``gather_leaf`` each, in
    ``tree.leaves`` order, the same on every rank: each calls it)."""
    spec = dict(tree.leaves(specs))
    whole = {key: gather_leaf(x, spec[key], mesh)
             for key, x in tree.leaves(state)}
    return tree.rebuild(state, lambda key, _: whole.pop(key))
