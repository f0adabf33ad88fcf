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

A step over ranks computes on each rank's local shards and meets the other
ranks only through this module: :func:`redistribute` (what ``constrain``,
and so ``models.common.shard``, does to a DTensor) and the explicit
collectives :func:`all_sum`, :func:`all_max` and :func:`all_gather` over
named mesh axes.  Each of them stages a CUDA tensor through the host where
the group is gloo, and adds what it issued to :data:`COLLECTIVES`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh
from ..models.common import ParamSpec, is_dtensor, tree_map

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

    def local_shape(self, s: ParamSpec) -> tuple[int, ...]:
        """The shape of this rank's slice of a leaf of spec ``s``."""
        shape = list(s.shape)
        for entry, d in ((e, d) for d, e in enumerate(self.spec_sharding(s)) if e is not None):
            shape[d] //= math.prod(self.mesh.shape[a] for a in (entry if isinstance(entry, tuple) else (entry,)))
        return tuple(shape)

    def place(self, x: torch.Tensor, s: ParamSpec) -> torch.Tensor:
        """``x``, every rank's whole copy of a leaf of spec ``s``, laid out as
        ``s`` resolves: a DTensor of this rank's slice, copied so that ``x``
        can be freed (no collective: every rank holds the whole); ``x``
        itself over a mesh without devices, which must be one device."""
        dm = self.mesh.device_mesh
        if dm is None:
            if self.mesh.size != 1:
                raise ValueError(f"place() over a {self.mesh.shape} mesh without devices: start a process group")
            return x
        from torch.distributed.tensor import DTensor

        target = self.placements(self.spec_sharding(s))
        coord, local = dm.get_coordinate(), x
        for i, p in enumerate(target):  # mesh dim 0 outermost, as DTensor nests shards
            if p.is_shard():
                local = local.chunk(dm.size(i), p.dim)[coord[i]]
        return DTensor.from_local(local.clone(memory_format=torch.contiguous_format), dm, target, run_check=False)

    def constant(self, s: ParamSpec, device: torch.device | str) -> torch.Tensor:
        """A leaf of spec ``s`` whose ``init`` is "zeros" or "ones", made as
        this rank's slice only (a DTensor; the whole leaf over a mesh
        without devices)."""
        fill = {"zeros": torch.zeros, "ones": torch.ones}[s.init]
        if self.mesh.device_mesh is None:
            return fill(s.shape, dtype=s.dtype, device=device)
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(fill(self.local_shape(s), dtype=s.dtype, device=device), self.mesh.device_mesh,
                                  self.placements(self.spec_sharding(s)), run_check=False)

    def constrain(self, x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
        """``x`` laid out as ``axes`` resolve on this mesh, values unchanged:
        a DTensor is redistributed; a plain tensor passes as it is over a
        one-device mesh, where every spec resolves to replicated, and is
        refused over a larger one, where it would silently stay whole."""
        if is_dtensor(x):
            if self.mesh.device_mesh is None:
                raise ValueError(f"constrain({tuple(axes)}) of a DTensor on a mesh without devices {self.mesh.shape}")
            return redistribute(x, self.placements(self.logical(x.shape, axes)))
        if self.mesh.size != 1:
            raise ValueError(f"constrain({tuple(axes)}) of a plain tensor over a {self.mesh.shape} mesh: "
                             "place it on the mesh first (a DTensor)")
        return x


# Collectives issued through this module since the process started, by kind
# ("sum", "max", "gather": one per mesh axis of extent > 1;
# "redistribute": one per call that moves data).
COLLECTIVES: collections.Counter = collections.Counter()


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective of ``x`` over ``group`` goes through a host copy:
    a CUDA tensor on a gloo group (see :func:`redistribute`)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _axes(mesh, axes) -> list[str]:
    """The mesh axes of ``axes`` (a name or a tuple of names) that have more
    than one rank: the others need no collective."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return [a for a in axes if mesh.size(mesh.mesh_dim_names.index(a)) > 1] if axes else []


def _reduce(x: torch.Tensor, mesh, axes, op, kind: str) -> torch.Tensor:
    for a in _axes(mesh, axes):
        group = mesh.get_group(a)
        buf = x.cpu() if _staged(x, group) else x.contiguous().clone()
        dist.all_reduce(buf, op=op, group=group)
        x = buf.to(x.device)
        COLLECTIVES[kind] += 1
    return x


def all_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the local tensor ``x`` over the ranks along mesh ``axes``
    of the ``DeviceMesh`` ``mesh`` (``x`` itself where no axis splits)."""
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM, "sum")


def all_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks along mesh ``axes``."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MAX, "max")


def all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The local tensors of the ranks along mesh ``axes`` joined on ``dim``,
    nested as a DTensor nests a dim sharded over them (the first axis
    outermost): the inverse of a ``Shard(dim)`` on each."""
    for a in reversed(_axes(mesh, axes)):
        group = mesh.get_group(a)
        src = x.cpu() if _staged(x, group) else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        x = torch.cat(parts, dim).to(x.device)
        COLLECTIVES["gather"] += 1
    return x


def redistribute(x, target: Sequence) -> Any:
    """``x.redistribute`` to ``target`` placements on its mesh; ``x`` itself
    where it is laid out so already.  gloo's functional
    collectives, which DTensor uses, crash on CUDA tensors (torch 2.11:
    a segfault in ``wait_tensor``; gloo carries CUDA ranks that share a
    card, where NCCL refuses two ranks on one device), so a CUDA DTensor on
    gloo groups redistributes a host copy over the same groups and comes
    back to its card.  A move that only splits replicated dims needs no
    collective and stays on the card."""
    mesh = x.device_mesh
    moved = [(a, b) for a, b in zip(x.placements, target) if a != b]
    if not moved:
        return x
    if all(a.is_replicate() for a, _ in moved):
        return x.redistribute(mesh, target)
    COLLECTIVES["redistribute"] += 1
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
