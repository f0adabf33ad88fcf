"""Meshes: the reference's production, host and sweep meshes.

The reference is one process over many devices (``jax.device_count()``);
the port spreads work over ranks, one process a device, as ``torchrun``
starts them.  A :class:`Mesh` names its axes and extents, which is all
``sharding.rules`` resolves a spec against, and over a running process
group it also carries a ``torch.distributed`` ``DeviceMesh`` over the
group's ranks, in row-major order (the device at coordinate ``(i, j)`` of a
``(data, model)`` mesh is rank ``i * model + j``, as ``jax.make_mesh``
orders host devices).

* The production meshes (256 or 512 devices) stay descriptors: the dry run
  only resolves specs against them.
* ``make_host_mesh`` without a process group is a descriptor too (the rule
  tests resolve specs on it); over a group it needs exactly the group's
  ranks.
* ``make_sweep_mesh`` is one ``scenario`` axis over every rank (one device
  without a group).

Library code never starts a process group: entry points and tests do.
Host-side gathers go through a gloo group (:func:`host_group`).
``torch.distributed.tensor`` is imported where a mesh is built, so that
importing the package does not load it.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Any

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_mesh: Any = dataclasses.field(default=None, compare=False, repr=False)  # a DeviceMesh, over a group

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and extents {self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> extent, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, *, device: torch.device | str = "cuda") -> Mesh:
    """A small mesh, as the reference's tests build over host devices.
    Over a process group it holds a ``DeviceMesh`` of the ranks' ``device``
    type, and its size must be the group's."""
    names, sizes = (("pod", "data", "model"), (pod, data, model)) if pod else (("data", "model"), (data, model))
    if not dist.is_initialized():
        return Mesh(names, sizes)
    if math.prod(sizes) != world_size():
        raise ValueError(f"a {dict(zip(names, sizes))} mesh has {math.prod(sizes)} devices; "
                         f"the process group has {world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    return Mesh(names, sizes, init_device_mesh(resolve_device(device).type, sizes, mesh_dim_names=names))


@lru_cache(maxsize=4)
def _gloo_group(world: Any) -> Any:
    return dist.new_group(backend="gloo")


def host_group() -> Any:
    """A gloo group over every rank, for collectives on host tensors: the
    default group where it is gloo, else one made once per process group
    (every rank must reach the first call)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return _gloo_group(dist.group.WORLD)


@lru_cache(maxsize=4)
def _sweep_mesh(world: Any) -> Mesh:
    from torch.distributed.device_mesh import DeviceMesh

    return Mesh(("scenario",), (world_size(),),
                DeviceMesh.from_group(host_group(), "cpu", mesh_dim_names=("scenario",)))


def make_sweep_mesh() -> Mesh:
    """1-D ``scenario`` mesh over every rank, for scenario-parallel sweep
    groups (one device without a process group).

    The sweep engines shard only the scenario (lane) axis: lanes never
    interact, so each rank runs its share and the ranks meet once a group,
    to gather the lanes' results on the host (hence a host mesh over
    :func:`host_group`).  Cached per process group: callers key their
    programs on this object."""
    if not dist.is_initialized():
        return Mesh(("scenario",), (1,))
    return _sweep_mesh(dist.group.WORLD)
