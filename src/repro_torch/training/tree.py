"""Nested parameter trees: dicts (keys in sorted order, as JAX flattens
them) and NamedTuples (fields in order) whose leaves are tensors.

A leaf's key is its path joined by ``/`` — ``params/layers/wr``,
``opt/m/embed``, ``opt/step`` — as the reference's
``training/checkpoint._path_key`` spells a pytree path.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of ``tree``, in the reference's order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from leaves(getattr(tree, k), f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def rebuild(template: Any, leaf_of: Callable[[str, Any], Any],
            prefix: str = "") -> Any:
    """A tree of ``template``'s structure whose leaf at ``key`` is
    ``leaf_of(key, template's leaf)``."""
    if isinstance(template, dict):
        return {k: rebuild(v, leaf_of, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(rebuild(getattr(template, k), leaf_of,
                                        f"{prefix}{k}/")
                                for k in template._fields))
    return leaf_of(prefix[:-1], template)
