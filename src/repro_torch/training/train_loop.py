"""Train-step factory: loss → grads (with microbatch accumulation) → AdamW.

The port of the JAX package's ``training/train_loop.py``, for every
config of ``configs.ARCHS``. The step runs eagerly on tensors: autograd
through ``transformer.loss_fn`` (each layer of every stack checkpointed
by ``remat_policy``; on the card rwkv6's ``wkv6`` forward is the CUDA
kernel and its backward the plain scan recomputed, while the other
families are plain PyTorch and launch no kernel of ``kernels/csrc``),
then ``optimizer.apply_updates`` in place. A step therefore updates the
state it is given and returns it (the JAX step, jitted with donated
buffers, would reuse them too): clone a state's tensors to keep it.

Over a ``(data, model)`` mesh (``launch/mesh.py``) the state is sharded
at rest by a spec tree that the caller gives with the mesh
(``launch/sharding.state_shardings``: the rules live in ``launch/``):
each rank holds its block of every param and of its AdamW m and v
(``init_train_state(..., mesh=, specs=)``). A step all-gathers the whole params, runs this data index's
rows of the global batch (each microbatch split over ``data``), sums
the gradients over the ``data`` group, takes the norm of the whole
reduced gradients, and runs AdamW on its own blocks. The ranks of one
model group compute the same rows: the products are not split over
``model`` (ROADMAP A11c), so the mesh step gives the one-device step's
result up to the order of the data reduction (at one data index, the
same bits).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt
from repro_torch.training import shards, tree


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState


def init_train_state(cfg: ModelConfig, generator: torch.Generator, *,
                     dtype=torch.bfloat16,
                     opt_cfg: Optional[opt.AdamWConfig] = None,
                     device: str | torch.device = "cuda",
                     mesh=None, specs: Any = None) -> TrainState:
    """Params from ``init_params`` (drawn from ``generator``) and a zero
    optimizer state, on ``device`` (the card unless told ``cpu``). With
    a ``mesh`` and ``specs`` (the state's spec tree) every rank draws
    the whole params from the same generator and keeps its blocks; m
    and v are zeros of the blocks' shapes."""
    _check_mesh(mesh, specs)
    params = tf.init_params(cfg, generator, dtype=dtype, device=device)
    if mesh is not None:
        params = shards.shard_tree(params, specs.params, mesh)
    ocfg = opt_cfg or opt.AdamWConfig()
    return TrainState(params=params, opt=opt.init_opt_state(ocfg, params))


# the stacks of per-layer params (``[L, ...]`` leaves at any nesting):
# every family's decoder ``layers`` (gemma2: its local/global pairs),
# the moe family's ``dense_layers``, whisper's ``enc_layers``
STACKS = ("layers", "dense_layers", "enc_layers")


def _check_mesh(mesh, specs) -> None:
    if (mesh is None) != (specs is None):
        raise ValueError("a mesh and its spec tree come together "
                         "(launch.sharding.state_shardings)")


def _stacked(key: str) -> bool:
    return key.split("/", 1)[0] in STACKS


def _loss_and_grads(cfg, params, batch, remat_policy, data=None):
    """``(loss, grads)``: grads a tree like ``params``, each leaf in its
    param's dtype and contiguous.

    Each layer's slice of a stacked ``[L, ...]`` param (every leaf of
    ``STACKS``) is a leaf of its own, so autograd hands back one gradient
    a layer and they are stacked once, as the reference's scan stacks
    them. (Through ``v[i]`` of the stack, every layer's backward would
    zero-fill a whole ``[L, ...]`` gradient and add it to the others:
    2.94 GB a layer for ``wck`` at rwkv6-3b's width.) A param the loss
    does not reach (qwen2-vl's ``embed`` beside ``embeds``, whisper's
    cross-attention biases) gets a zero gradient, as ``jax.grad`` gives
    it, so AdamW moves it by weight decay alone as the reference does.

    ``data``: ``batch`` is this rank's block of the global batch's rows
    on that data axis (``loss_fn``'s global mean and MoE routing, in
    the forward and in the backward's recompute)."""
    def live_leaf(key, p):
        if _stacked(key):
            return [x.detach().requires_grad_(True) for x in p]
        return p.detach().requires_grad_(True)

    live = tree.rebuild(params, live_leaf)
    leaves = []
    for key, leaf in tree.leaves(live):
        leaves.extend(leaf if _stacked(key) else [leaf])
    with torch.enable_grad():
        loss = tf.loss_fn(cfg, live, batch, remat_policy=remat_policy,
                          data=data)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    del live, leaves
    flat, at = {}, 0
    for key, p in tree.leaves(params):
        if _stacked(key):
            n = p.shape[0]
            flat[key] = torch.stack(grads[at:at + n])
            grads[at:at + n] = [None] * n
            at += n
        else:       # a tied embedding's holds the head's transposed part
            flat[key] = grads[at].contiguous()
            grads[at] = None
            at += 1
    return loss.detach(), tree.rebuild(params, lambda k, _: flat.pop(k))


def _accumulated(cfg, params, batch, accum_steps, remat_policy,
                 data=None):
    """``(loss, grads)`` of ``batch``: with ``accum_steps`` > 1 its
    leading dim splits into [accum, micro, ...] and the microbatches run
    one after another, losses summed, gradients summed in float32, both
    divided by ``accum_steps``, as the reference's ``lax.scan``."""
    if accum_steps == 1:
        return _loss_and_grads(cfg, params, batch, remat_policy, data)
    micro = {k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                          + tuple(x.shape[1:]))
             for k, x in batch.items()}
    loss = grads = flat = None
    for i in range(accum_steps):
        l, g = _loss_and_grads(cfg, params, {k: x[i] for k, x in
                                             micro.items()},
                               remat_policy, data)
        if grads is None:       # 0 + the first: itself, in f32
            loss = l
            grads = tree.rebuild(g, lambda _, x: x.to(torch.float32))
            flat = dict(tree.leaves(grads))
        else:
            loss = loss + l
            for k, gi in tree.leaves(g):
                flat[k] += gi
        del g
    loss = loss / accum_steps
    for x in flat.values():
        x /= accum_steps
    return loss, grads


def data_rows(batch: Dict[str, torch.Tensor], accum_steps: int,
              data) -> Dict[str, torch.Tensor]:
    """This data index's rows of the global ``batch``: each of the
    ``accum_steps`` microbatches (split first, as the one-device step
    splits them) cut into ``data.size`` contiguous blocks, block
    ``data.index`` of each kept, so local microbatch *i* holds rows of
    the global microbatch *i* (and an MoE layer routes them as that
    microbatch's)."""
    n, i = data.size, data.index
    out = {}
    for k, x in batch.items():
        mb = x.shape[0] // accum_steps
        if x.shape[0] % accum_steps or mb % n:
            raise ValueError(
                f"a global batch of {x.shape[0]} rows does not split into "
                f"{accum_steps} microbatches over {n} data ranks")
        b = mb // n
        xs = x.reshape((accum_steps, mb) + tuple(x.shape[1:]))
        out[k] = xs[:, i * b:(i + 1) * b].reshape(
            (accum_steps * b,) + tuple(x.shape[1:]))
    return out


def make_train_step(cfg: ModelConfig, *,
                    opt_cfg: Optional[opt.AdamWConfig] = None,
                    accum_steps: int = 1,
                    remat_policy: Optional[str] = "dots",
                    mesh=None, specs: Any = None) -> Callable:
    """Build ``train_step(state, batch) → (state, metrics)``.

    ``batch`` leaves are [global_batch, ...]; with ``accum_steps`` > 1
    the leading dim splits into [accum, micro, ...] and the microbatches
    run one after another: losses summed, gradients summed in float32,
    both divided by ``accum_steps`` before one optimizer update, as the
    reference's ``lax.scan``. ``metrics``: ``loss``, ``grad_norm``,
    ``lr`` (0-d float32 tensors).

    With a ``mesh`` and ``specs`` the state is this rank's shards
    (``init_train_state(..., mesh=, specs=)``) and ``batch`` the global
    batch, the same on every rank (module docstring). Every rank calls
    the step, and the metrics are the whole batch's on each.
    """
    _check_mesh(mesh, specs)
    ocfg = opt_cfg or opt.AdamWConfig()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, grads = _accumulated(cfg, state.params, batch, accum_steps,
                                   remat_policy)
        params, ostate, metrics = opt.apply_updates(
            ocfg, state.params, grads, state.opt)
        metrics = dict(metrics, loss=loss)
        return TrainState(params=params, opt=ostate), metrics

    if mesh is None:
        return train_step
    spec = dict(tree.leaves(specs.params))

    def mesh_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        whole = {k: shards.gather_leaf(x, spec[k], mesh)
                 for k, x in tree.leaves(state.params)}
        params = tree.rebuild(state.params, lambda k, _: whole.pop(k))
        loss, grads = _accumulated(
            cfg, params, data_rows(batch, accum_steps, mesh.data),
            accum_steps, remat_policy, mesh.data)
        del params
        loss = mesh.data.psum(loss)
        flat = {k: mesh.data.psum(g) for k, g in tree.leaves(grads)}
        grads = tree.rebuild(grads, lambda k, _: flat.pop(k))
        gnorm = opt.global_norm(grads)
        for k, g in tree.leaves(grads):     # this rank's blocks
            b = shards.shard_leaf(g, spec[k], mesh)
            flat[k] = b if b.shape == g.shape else \
                b.clone(memory_format=torch.contiguous_format)
        grads = tree.rebuild(grads, lambda k, _: flat.pop(k))
        params, ostate, metrics = opt.apply_updates(
            ocfg, state.params, grads, state.opt, gnorm=gnorm)
        metrics = dict(metrics, loss=loss)
        return TrainState(params=params, opt=ostate), metrics

    return mesh_step


def make_eval_step(cfg: ModelConfig,
                   remat_policy: Optional[str] = None) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return tf.loss_fn(cfg, params, batch, remat_policy=remat_policy)
    return eval_step
