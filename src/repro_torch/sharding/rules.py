"""Logical-axis -> mesh-axis rules, with divisibility and reuse guards.

One rule table serves every architecture: a rule maps a logical axis name
("mlp", "heads", "kv_seq", ...) to a mesh axis or tuple of mesh axes.  When a
spec is resolved, an axis is dropped (replicated) if (a) the dimension size
is not divisible by the mesh extent, or (b) any of its mesh axes was already
consumed by an earlier dimension of the same tensor.

The tables and ``MeshRules._resolve`` are the reference's, value for value.
A resolved spec is a tuple, one entry per dimension (``None``, an axis
name, or a tuple of names), with trailing ``None``s dropped as
``jax.sharding.PartitionSpec`` drops them: a :class:`Sharding`, which
compares as that plain tuple and keeps its mesh, as the reference's
``NamedSharding`` does.  On a mesh over a process group a spec becomes
DTensor placements (:meth:`MeshRules.placements`): mesh dim ``i`` is
``Shard(d)`` where tensor dim ``d`` names its axis, else ``Replicate()``.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh
from ..models.common import ParamSpec, tree_map

Rules = Mapping[str, Any]  # logical name -> mesh axis | tuple of axes | None
Spec = tuple  # per dimension: None | axis name | tuple of axis names


class Sharding(tuple):
    """A resolved spec on its mesh.  It is the plain tuple spec to ``==``,
    ``hash`` and ``repr``; ``mesh`` is what it was resolved against."""

    mesh: Mesh

    def __new__(cls, entries: Sequence[Any], mesh: Mesh) -> "Sharding":
        self = super().__new__(cls, entries)
        self.mesh = mesh
        return self

    def __getnewargs__(self) -> tuple:
        return tuple(self), self.mesh

    def __repr__(self) -> str:
        return tuple.__repr__(self)


def placements(mesh: Mesh, spec: Spec) -> list:
    """DTensor placements of a resolved ``spec``, one per mesh dim:
    ``Shard(d)`` where tensor dim ``d``'s entry names that mesh axis, else
    ``Replicate()``.  DTensor nests the shards of one tensor dim in mesh-dim
    order, so a tuple entry must name its axes in mesh order to shard as the
    reference's major-to-minor order does."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.axis_names
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,) if entry is not None else ()
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}: a DTensor would nest its "
                             "shards in another order than the reference")
        owner.update((a, d) for a in axes)
    return [Shard(owner[a]) if a in owner else Replicate() for a in names]


# Batch always spans the pod axis first so cross-pod traffic is pure DP.
def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def train_rules(mesh: Mesh, *, fsdp: bool = True) -> dict[str, Any]:
    b = batch_axes(mesh)
    return {
        "batch": b,
        "embed": "data" if fsdp else None,  # FSDP/ZeRO-3 shard of the non-TP dim
        "embed_tp": "model",  # input-embedding D dim (gather stays local)
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "vocab": "model",
        "expert": "model",  # EP
        "seq": None,
        "act_seq": "model",  # Megatron-SP style activation sharding between blocks
        "kv_seq": "model",
        "long_kv_seq": b[-1:] + ("model",) if b else ("model",),
        "conv_out": "model",
        "conv_in": None,
        "layers": None,
        "patch": None,
        "channels": None,
        "spatial": None,
    }


def serve_rules(mesh: Mesh) -> dict[str, Any]:
    r = train_rules(mesh, fsdp=False)
    r["embed"] = None
    return r


def sweep_rules(mesh: Mesh) -> dict[str, Any]:
    """Scenario-grid sweeps: one logical axis, the (padded) lane batch.

    On the dedicated sweep mesh this is the ``scenario`` axis; on a
    production mesh the lane batch spans the pure-DP batch axes instead, so
    the same rule table serves both topologies.  The divisibility guard in
    :meth:`MeshRules._resolve` is the enforcement point for the engines'
    padding invariant — an unpadded lane count that does not divide the
    mesh resolves to replicated, never to a wrong shard.
    """
    b = batch_axes(mesh)
    if "scenario" in mesh.axis_names:
        b = b + ("scenario",)
    return {"scenario": b}


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Mesh
    rules: Rules

    def _resolve(self, sizes: Sequence[int], axes: Sequence[str | None]) -> Spec:
        used: set[str] = set()
        out: list[Any] = []
        for size, name in zip(sizes, axes):
            entry = self.rules.get(name) if name else None
            if entry is None:
                out.append(None)
                continue
            mesh_axes = entry if isinstance(entry, tuple) else (entry,)
            mesh_axes = tuple(a for a in mesh_axes if a in self.mesh.axis_names and a not in used)
            if not mesh_axes:
                out.append(None)
                continue
            extent = math.prod(self.mesh.shape[a] for a in mesh_axes)
            if extent <= 1 or size % extent != 0:
                out.append(None)
                continue
            used.update(mesh_axes)
            out.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def spec_sharding(self, s: ParamSpec) -> Sharding:
        return Sharding(self._resolve(s.shape, s.axes), self.mesh)

    def tree_shardings(self, specs) -> Any:
        return tree_map(self.spec_sharding, specs)

    def logical(self, sizes: Sequence[int], axes: Sequence[str | None]) -> Sharding:
        return Sharding(self._resolve(sizes, axes), self.mesh)

    def placements(self, spec: Spec) -> list:
        return placements(self.mesh, spec)

    def constrain(self, x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
        """``x`` laid out as ``axes`` resolve on this mesh, values unchanged:
        a DTensor is redistributed; a plain tensor passes as it is over a
        one-device mesh, where every spec resolves to replicated, and is
        refused over a larger one, where it would silently stay whole."""
        tensor_mod = sys.modules.get("torch.distributed.tensor")  # no DTensor exists before it is loaded
        if tensor_mod is not None and isinstance(x, tensor_mod.DTensor):
            if self.mesh.device_mesh is None:
                raise ValueError(f"constrain({tuple(axes)}) of a DTensor on a mesh without devices {self.mesh.shape}")
            return redistribute(x, self.placements(self.logical(x.shape, axes)))
        if self.mesh.size != 1:
            raise ValueError(f"constrain({tuple(axes)}) of a plain tensor over a {self.mesh.shape} mesh: "
                             "place it on the mesh first (a DTensor)")
        return x


def redistribute(x, target: Sequence) -> Any:
    """``x.redistribute`` to ``target`` placements on its mesh.  gloo's functional
    collectives, which DTensor uses, crash on CUDA tensors (torch 2.11:
    a segfault in ``wait_tensor``; gloo carries CUDA ranks that share a
    card, where NCCL refuses two ranks on one device), so a CUDA DTensor on
    gloo groups redistributes a host copy over the same groups and comes
    back to its card."""
    mesh = x.device_mesh
    if mesh.device_type != "cuda" or dist.get_backend(mesh.get_group(0)) != "gloo":
        return x.redistribute(mesh, target)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    host_mesh = DeviceMesh.from_group([mesh.get_group(i) for i in range(mesh.ndim)], "cpu", mesh=mesh.mesh,
                                      mesh_dim_names=mesh.mesh_dim_names)
    host = DTensor.from_local(x.to_local().cpu(), host_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())
    local = host.redistribute(host_mesh, target).to_local().to(x.device)
    return DTensor.from_local(local, mesh, target, run_check=False, shape=x.shape, stride=x.stride())
