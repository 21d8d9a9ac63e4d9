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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt
from repro_torch.training import tree


class TrainState(NamedTuple):
    params: Any
    opt: opt.OptState


def init_train_state(cfg: ModelConfig, generator: torch.Generator, *,
                     dtype=torch.bfloat16,
                     opt_cfg: Optional[opt.AdamWConfig] = None,
                     device: str | torch.device = "cuda") -> TrainState:
    """Params from ``init_params`` (drawn from ``generator``) and a zero
    optimizer state, on ``device`` (the card unless told ``cpu``)."""
    params = tf.init_params(cfg, generator, dtype=dtype, device=device)
    ocfg = opt_cfg or opt.AdamWConfig()
    return TrainState(params=params, opt=opt.init_opt_state(ocfg, params))


# the stacks of per-layer params (``[L, ...]`` leaves at any nesting):
# every family's decoder ``layers`` (gemma2: its local/global pairs),
# the moe family's ``dense_layers``, whisper's ``enc_layers``
STACKS = ("layers", "dense_layers", "enc_layers")


def _stacked(key: str) -> bool:
    return key.split("/", 1)[0] in STACKS


def _loss_and_grads(cfg, params, batch, remat_policy):
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
    it, so AdamW moves it by weight decay alone as the reference does."""
    def live_leaf(key, p):
        if _stacked(key):
            return [x.detach().requires_grad_(True) for x in p]
        return p.detach().requires_grad_(True)

    live = tree.rebuild(params, live_leaf)
    leaves = []
    for key, leaf in tree.leaves(live):
        leaves.extend(leaf if _stacked(key) else [leaf])
    with torch.enable_grad():
        loss = tf.loss_fn(cfg, live, batch, remat_policy=remat_policy)
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


def make_train_step(cfg: ModelConfig, *,
                    opt_cfg: Optional[opt.AdamWConfig] = None,
                    accum_steps: int = 1,
                    remat_policy: Optional[str] = "dots") -> Callable:
    """Build ``train_step(state, batch) → (state, metrics)``.

    ``batch`` leaves are [global_batch, ...]; with ``accum_steps`` > 1
    the leading dim splits into [accum, micro, ...] and the microbatches
    run one after another: losses summed, gradients summed in float32,
    both divided by ``accum_steps`` before one optimizer update, as the
    reference's ``lax.scan``. ``metrics``: ``loss``, ``grad_norm``,
    ``lr`` (0-d float32 tensors).
    """
    ocfg = opt_cfg or opt.AdamWConfig()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if accum_steps == 1:
            loss, grads = _loss_and_grads(cfg, state.params, batch,
                                          remat_policy)
        else:
            micro = {k: x.reshape((accum_steps, x.shape[0] // accum_steps)
                                  + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            loss = grads = flat = None
            for i in range(accum_steps):
                l, g = _loss_and_grads(cfg, state.params,
                                       {k: x[i] for k, x in micro.items()},
                                       remat_policy)
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
        params, ostate, metrics = opt.apply_updates(
            ocfg, state.params, grads, state.opt)
        metrics = dict(metrics, loss=loss)
        return TrainState(params=params, opt=ostate), metrics

    return train_step


def make_eval_step(cfg: ModelConfig,
                   remat_policy: Optional[str] = None) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return tf.loss_fn(cfg, params, batch, remat_policy=remat_policy)
    return eval_step
