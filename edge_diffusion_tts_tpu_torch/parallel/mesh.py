"""A logical device mesh over ``torch.distributed`` ranks, and the sharding
helpers (counterpart of ``edge_diffusion_tts_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over one controller's devices
and lets XLA insert the collectives.  Here every rank is a process: the
caller initializes the default process group (``torchrun`` +
``multihost.init_multihost``, or ``launch.spawn``) and ``make_mesh`` lays
the ranks out row-major over the named axes, with one subgroup per line of
each axis.  ``Mesh.axis(name)`` returns this rank's line along an axis,
whose methods are the collectives the parallel programs issue.

The backend is the caller's choice, made when the process group is
initialized: NCCL when every rank owns a card, gloo when asked (on the CPU,
and for two ranks that share one card).  Gloo moves CUDA tensors through
host copies: every collective on a gloo group stages a CUDA tensor through
a host tensor explicitly (gloo's own CUDA paths copy to the host as well,
and its send/recv take host tensors only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _require_process_group() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group is initialized: start the ranks with "
            "torchrun and call parallel.init_multihost(), or use parallel.launch.spawn")


class Axis:
    """This rank's line along one mesh axis: its ranks in axis order, its
    process group (None for a one-rank line) and the collectives over it.
    Every rank of the line must issue the same collectives in the same
    order."""

    def __init__(self, name: str, ranks: Sequence[int], group, rank: int):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)

    def _host_staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the axis, in place; returns ``t``."""
        if self.size == 1:
            return t
        if self._host_staged(t):
            h = t.detach().cpu()
            dist.all_reduce(h, group=self.group)
            return t.copy_(h)
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of the axis's ``src``-th rank on every rank, in place."""
        if self.size == 1:
            return t
        root = self.ranks[src]
        if self._host_staged(t):
            h = t.detach().cpu()
            dist.broadcast(h, src=root, group=self.group)
            return t.copy_(h)
        dist.broadcast(t, src=root, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in axis order."""
        if self.size == 1:
            return t
        src = t.detach().contiguous()
        staged = self._host_staged(src)
        if staged:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(t.device) if staged else out

    def send(self, t: torch.Tensor, to: int) -> None:
        """Point-to-point ``t`` to the axis's ``to``-th rank (blocking)."""
        t = t.detach().contiguous()
        if self._host_staged(t):
            # gloo's send takes host tensors only: stage through pinned memory.
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = h.copy_(t)
        dist.send(t, dst=self.ranks[to], group=self.group)

    def recv(self, like: torch.Tensor, frm: int) -> torch.Tensor:
        """A tensor shaped as ``like`` from the axis's ``frm``-th rank, on
        ``like``'s device (blocking)."""
        if self._host_staged(like):
            h = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            dist.recv(h, src=self.ranks[frm], group=self.group)
            return h.to(like.device)
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.recv(out, src=self.ranks[frm], group=self.group)
        return out


class Mesh:
    """Ranks ``0 .. world-1`` laid out row-major over ``axis_names``;
    ``shape[name]`` is an axis's size, ``axis(name)`` this rank's line."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        _require_process_group()
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axis names {axis_names}")
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} ranks, the "
                             f"process group has {world}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.rank, self.world_size = rank, world
        grid = np.arange(world).reshape(shape)
        self._axes: Dict[str, Axis] = {}
        # new_group is collective: every rank creates every line's group, in
        # the same order, members or not.
        for i, name in enumerate(axis_names):
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                ranks = [int(r) for r in line]
                if len(ranks) == 1:
                    group = None
                elif len(ranks) == world:
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(ranks)
                if rank in ranks:
                    self._axes[name] = Axis(name, ranks, group, rank)

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise ValueError(f"the mesh has no axis {name!r} (axes {self.axis_names})")
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS),
) -> Mesh:
    """A mesh over the initialized process group; by default every rank on
    the data axis and a model axis of 1.  ``prod(shape)`` must equal the
    world size."""
    _require_process_group()
    if shape is None:
        shape = (dist.get_world_size(),) + (1,) * (len(axis_names) - 1)
    return Mesh(shape, axis_names)


@dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh: ``spec[d]`` names the axis that dim ``d``
    is split over (None: whole), as a ``PartitionSpec``; ``()`` is
    replicated.  ``local(t)`` is this rank's piece."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...] = ()

    def local(self, t: torch.Tensor) -> torch.Tensor:
        for d, name in enumerate(self.spec):
            if name is None:
                continue
            ax = self.mesh.axis(name)
            n = t.shape[d]
            if n % ax.size:
                raise ValueError(f"dim {d} of size {n} does not divide over the "
                                 f"{ax.size}-rank {name!r} axis")
            t = t.narrow(d, ax.index * (n // ax.size), n // ax.size)
        return t


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> Placement:
    """The leading (batch) dimension split over ``axis``."""
    return Placement(mesh, (axis,))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def shard_batch(batch: dict, mesh: Mesh, axis: str = DATA_AXIS) -> dict:
    """This rank's rows of every array in ``batch``: the ``index``-th of
    ``size`` equal slices of the leading dim along ``axis``, in rank order.
    Numpy arrays stay numpy, tensors stay tensors."""
    place = batch_sharding(mesh, axis)
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        local = place.local(t)
        out[k] = local if torch.is_tensor(v) else local.numpy()
    return out


def replicate(tree, mesh: Mesh):
    """Broadcast ``tree`` (a module's parameters and buffers, a tensor, or a
    dict/list of tensors) in place from rank 0 to the whole mesh; returns
    ``tree``."""
    ax = Axis("world", range(mesh.world_size),
              dist.group.WORLD if mesh.world_size > 1 else None, mesh.rank)
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    elif torch.is_tensor(tree):
        tensors = [tree]
    elif isinstance(tree, dict):
        tensors = list(tree.values())
    else:
        tensors = list(tree)
    with torch.no_grad():
        for t in tensors:
            ax.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t)
    return tree
