"""The serving mesh over ``torch.distributed``: the counterpart of
``src/repro/launch/mesh.py``.

The reference builds a ``jax`` mesh of ``(data, model)`` axes over its
devices, and its engine's ``shard_map`` splits each batch over ``data``
and the tree over ``model``. Here the world is ``torch.distributed``'s:
each rank is one ``(data, model)`` coordinate, ``rank = data · n_model
+ model``, as ``jax.make_mesh`` lays out its devices.
``make_debug_mesh`` creates one model group per data index (the
engine's ``ModelAxis``) and one data group per model index.
``Mesh.step`` stands for the ``shard_map``'s ``P(data)`` in- and
out-specs: each data index serves its contiguous rows of the batch, and
the ``ServeStats`` are all-gathered over the data group, so every rank
holds the whole batch's stats. ``Mesh.shard`` pads a hybrid for the
model axis and keeps this rank's shard (``engine.shard_for_rank``).

There is no ``set_mesh``: the groups are explicit, held by the ``Mesh``
and passed to whatever runs on them. The reference's
``make_production_mesh`` (16×16 and 2×16×16 chips) belongs to its
dry-run, ROADMAP A13d, and is not here.

``init_from_env`` joins the world ``torch.distributed.run`` describes
(``env://``). Each rank takes ``cuda:(LOCAL_RANK % device_count)`` or
the CPU. The backend is ``nccl`` where every rank has a card of its own
and ``gloo`` where ranks share a card (NCCL refuses two ranks on one
device) or run on the CPU; a backend that fails to initialise raises.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import engine


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``(data, model)`` mesh over the whole
    ``torch.distributed`` world, and its two axes."""
    shape: tuple[int, int]       # (n_data, n_model)
    rank: int                    # the global rank
    model: engine.ModelAxis      # this rank's model group
    data: engine.ModelAxis       # this rank's data group
    device: torch.device         # where this rank's tensors live
    axis_names: tuple[str, ...] = ("data", "model")

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_model(self) -> int:
        return self.shape[1]

    def shard(self, h):
        """This rank's shard of hybrid ``h``, padded for the model axis
        (``engine.pad_tree_for_sharding`` → ``engine.shard_for_rank``)."""
        return engine.shard_for_rank(
            engine.pad_tree_for_sharding(h, self.n_model), self.model)

    def step(self, step: Callable) -> Callable:
        """``step`` (``(hybrid, queries [B, 4], *rest) → stats``) over the
        data axis: this data index serves rows ``[i·B/n, (i+1)·B/n)`` of
        the batch and every field of the stats is all-gathered over the
        data group in data-index order. ``B`` must split evenly (the
        scheduler's batches have a static size)."""
        if self.n_data == 1:
            return step

        def fn(h, queries: torch.Tensor, *rest):
            B = queries.shape[0]
            if B % self.n_data:
                raise ValueError(f"a batch of {B} rows does not split over "
                                 f"{self.n_data} data ranks")
            b, i = B // self.n_data, self.data.index
            out = step(h, queries[i * b:(i + 1) * b], *rest)
            return type(out)(*(self.data.all_gather(f, 0) for f in out))
        return fn

    def _object_device(self) -> torch.device:
        # nccl moves objects through the card; gloo through the host
        return (torch.device("cpu") if dist.get_backend() == "gloo"
                else self.device)

    def broadcast(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank of the world, its tensors moved
        to this rank's device (they travel through the host)."""
        box = [to_device(obj, "cpu") if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, device=self._object_device())
        return to_device(box[0], self.device)

    def agree_max(self, x: float) -> float:
        """The largest of every rank's ``x``: one value the ranks take the
        same decisions on (a host clock differs from rank to rank)."""
        t = torch.tensor([x], dtype=torch.float64,
                         device=self._object_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())


def to_device(obj: Any, device) -> Any:
    """``obj`` with every tensor inside it (in dataclasses, tuples,
    NamedTuples, lists and dicts) moved to ``device``; numpy arrays and
    other values are kept."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes the global batch splits over."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device: str | torch.device = "cpu") -> Mesh:
    """The ``(n_data, n_model)`` mesh over the initialised world, which
    must hold ``n_data · n_model`` ranks. Every rank calls it (the groups
    are created collectively, in one order); an axis of one rank has no
    group and identity collectives."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_debug_mesh needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    model_group = data_group = None
    if n_model > 1:
        for dd in range(n_data):
            g = dist.new_group([dd * n_model + mm for mm in range(n_model)])
            model_group = g if dd == d else model_group
    if n_data > 1:
        for mm in range(n_model):
            g = dist.new_group([dd * n_model + mm for dd in range(n_data)])
            data_group = g if mm == m else data_group
    return Mesh(shape=(n_data, n_model), rank=rank,
                model=engine.model_axis(n_model, model_group),
                data=engine.model_axis(n_data, data_group),
                device=torch.device(device))


def serve_mesh_shape(world: int) -> tuple[int, int]:
    """``repro.launch.serve``'s mesh for ``world`` devices: ``n_data =
    max(1, world // 2)`` and ``n_model = world // n_data``."""
    nd = max(1, world // 2)
    return nd, world // nd


@dataclasses.dataclass(frozen=True)
class World:
    """What ``init_from_env`` joined."""
    rank: int
    size: int
    device: torch.device
    backend: str
    ranks_per_card: int          # 0 on the CPU


def init_from_env(device: str = "cuda", *, timeout_s: float = 300.0
                  ) -> World:
    """Join the world ``torch.distributed.run`` describes (``env://``:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). ``device="cuda"`` puts this rank
    on ``cuda:(LOCAL_RANK % device_count)`` (no card raises) and takes
    ``nccl`` when each local rank has a card of its own, else ``gloo``;
    ``device="cpu"`` takes ``gloo``. ``init_process_group``'s own errors
    propagate."""
    size = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
    dev = resolve_device(device)
    backend, per_card = "gloo", 0
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
        per_card = -(-local_world // n_cards)
        backend = "nccl" if per_card == 1 else "gloo"
    dist.init_process_group(backend, init_method="env://",
                            timeout=timedelta(seconds=timeout_s))
    return World(rank=dist.get_rank(), size=dist.get_world_size(),
                 device=dev, backend=backend, ranks_per_card=per_card)
