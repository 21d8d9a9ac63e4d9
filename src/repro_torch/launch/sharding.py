"""Parameter/activation sharding rules for a ``(data, model)`` mesh: the
port of ``src/repro/launch/sharding.py``.

Strategy (the reference's, rules copied verbatim):
  * TP over ``model``: attention head·d_head projections, FFN hidden dim,
    expert dim (EP), vocab dim of embedding/lm_head;
  * FSDP over ``data``: the d_model axis of every large matrix (ZeRO-3
    style — parameters, grads and optimizer state all shard the same way);
  * replicate across ``pod`` (pure DP between pods);
  * anything small (norms, biases under ~d, LoRA factors) is replicated.

Rules are name-keyed over a leaf's key (``params/layers/attn/wq``,
``opt/m/embed``: ``training/tree.py``), with divisibility checks — a dim
that does not divide its mesh axis is replicated rather than
mis-sharded.

A spec is a tuple with one entry a dim: an axis name, a tuple of names
(the dim split over their product, the first the major one) or None —
the reference's ``PartitionSpec`` as a tuple (``()`` where it is
``P()``). A ``mesh`` is anything with ``axis_names`` and a ``shape``:
``launch.mesh.Mesh`` or a stand-in such as
``SimpleNamespace(axis_names=("data", "model"), shape=(16, 16))``.

``shard_leaf`` keeps this rank's block of a whole leaf and
``gather_leaf`` all-gathers the blocks back, over the mesh's groups
(``Mesh.data``, ``Mesh.model``): they live in ``training/shards.py``,
below the train step and the checkpoints that call them, and are named
here beside the rules.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.launch import specs
from repro_torch.training import tree
from repro_torch.training.shards import (  # noqa: F401
    gather_leaf, gather_tree, shard_leaf, shard_tree)

Spec = tuple

# (regex over "a/b/c" path, spec over the LAST ndim dims of the leaf)
# The leading scan/layer dim (when present) is always unsharded: rules are
# written against the trailing dims and left-padded with None.
_RULES: list[tuple[str, tuple]] = [
    # embeddings
    (r"(^|/)embed$", ("model", "data")),
    (r"(^|/)lm_head$", ("data", "model")),
    (r"(^|/)enc_pos$", (None, None)),        # 1500 rows — replicated
    (r"(^|/)dec_pos$", ("data", None)),      # 32768 rows — shard positions
    # attention (GQA + biases)
    (r"/attn/wq$", ("data", "model")),
    (r"/attn/wk$", ("data", "model")),
    (r"/attn/wv$", ("data", "model")),
    (r"/attn/wo$", ("model", "data")),
    (r"/attn/b[qkv]$", ("model",)),
    (r"/xattn/w[qkv]$", ("data", "model")),
    (r"/xattn/wo$", ("model", "data")),
    (r"/xattn/b[qkv]$", ("model",)),
    # MLA
    (r"/attn/wq_a$", ("data", None)),
    (r"/attn/wq_b$", (None, "model")),
    (r"/attn/wkv_a$", ("data", None)),
    (r"/attn/wkv_b$", (None, "model")),
    # dense MLP
    (r"/mlp/wi$", ("data", "model")),
    (r"/mlp/wg$", ("data", "model")),
    (r"/mlp/wo2$", ("model", "data")),
    # MoE: experts over model (EP), d_model over data
    (r"/moe/router$", ("data", None)),
    (r"/moe/w[ig]$", ("model", "data", None)),
    (r"/moe/wo$", ("model", None, "data")),
    (r"/moe/sh_w[ig]$", ("data", "model")),
    (r"/moe/sh_wo$", ("model", "data")),
    # rwkv6
    (r"/w[rkvg]$", ("data", "model")),
    (r"/wo$", ("model", "data")),
    (r"/wck$", ("data", "model")),
    (r"/wcv$", ("model", "data")),
    (r"/wcr$", ("data", "model")),
    # mamba (hymba)
    (r"/ssm/w_in$", ("data", "model")),
    (r"/ssm/w_out$", ("model", "data")),
    (r"/ssm/w_[BC]$", ("model", None)),
    (r"/ssm/A_log$", ("model", None)),
    (r"/ssm/conv_[wb]$", (None, "model")),
    (r"/ssm/D$", ("model",)),
]


def axis_sizes(mesh) -> dict:
    """``{axis name: ranks on it}``."""
    return dict(zip(mesh.axis_names, mesh.shape))


def spec_for_leaf(path: str, shape: tuple, mesh) -> Spec:
    """The spec of the leaf at ``path`` of ``shape`` on ``mesh``: the
    first rule whose pattern matches, each named dim kept where it
    divides its axis (FSDP spreads over ``("pod", "data")`` where a pod
    axis exists and the dim divides both), else ``()``."""
    axis_size = axis_sizes(mesh)
    for pat, dims in _RULES:
        if re.search(pat, path):
            nd = len(shape)
            full = (None,) * (nd - len(dims)) + tuple(dims)
            fixed = []
            for dim_size, ax in zip(shape, full):
                if ax is None or ax not in axis_size:
                    fixed.append(None)
                    continue
                if ax == "data" and "pod" in axis_size:
                    n2 = axis_size["data"] * axis_size["pod"]
                    if dim_size % n2 == 0:
                        fixed.append(("pod", "data"))
                        continue
                if dim_size % axis_size[ax] == 0:
                    fixed.append(ax)
                else:
                    fixed.append(None)   # divisibility fallback: replicate
            return tuple(fixed)
    return ()  # norms, scalars, small tensors: replicated


def params_shardings(state: Any, mesh) -> Any:
    """A tree of ``state``'s structure holding each leaf's spec (params,
    or a train state whose keys embed the param names: ``opt/m/...``).
    ``state``'s leaves need only a ``shape``: meta tensors will do
    (``launch.specs.state_specs``)."""
    return tree.rebuild(state, lambda key, x: spec_for_leaf(
        key, tuple(x.shape), mesh))


def _batch_axis(mesh):
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return baxes, (baxes if len(baxes) > 1 else
                   (baxes[0] if baxes else None))


def batch_shardings(batch: dict, mesh) -> dict:
    """The leading (global-batch) dim of each leaf over (pod, data);
    a 0-d leaf, or one whose leading dim does not divide, replicated."""
    baxes, ax = _batch_axis(mesh)
    sizes = axis_sizes(mesh)
    n = math.prod(sizes[a] for a in baxes) or 1

    def spec(leaf):
        if len(leaf.shape) == 0 or leaf.shape[0] % n != 0:
            return ()
        return (ax,) + (None,) * (len(leaf.shape) - 1)
    return {k: spec(v) for k, v in batch.items()}


def cache_shardings(cache: Any, mesh, *, seq_axis_min: int = 1024) -> Any:
    """Decode-cache specs: the batch dim (dim 1 of an ``[L, B, ...]``
    leaf) over data(+pod), the longest dim of at least ``seq_axis_min``
    past it over model."""
    baxes, bax = _batch_axis(mesh)
    sizes = axis_sizes(mesh)
    n_b = math.prod(sizes[a] for a in baxes) or 1
    n_m = sizes.get("model", 1)

    def spec(_, leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        dims: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % n_b == 0 and shape[1] > 1:
            dims[1] = bax
        cand = [i for i in range(2, len(shape))
                if shape[i] >= seq_axis_min and shape[i] % n_m == 0]
        if cand:
            dims[max(cand, key=lambda i: shape[i])] = "model"
        return tuple(dims)
    return tree.rebuild(cache, spec)


def state_shardings(cfg, mesh) -> Any:
    """The spec tree of ``cfg``'s ``TrainState`` on ``mesh``, from its
    meta-device stand-in (``specs.state_specs``: no allocation)."""
    return params_shardings(specs.state_specs(cfg)[0], mesh)
