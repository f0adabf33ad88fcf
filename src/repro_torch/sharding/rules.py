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
named mesh axes.  Each of them stages a CUDA
tensor through the host where the group is gloo, and adds what it issued to
:data:`COLLECTIVES`.

Autograd sees each of them, with its adjoint (a training step over ranks):
every tensor that the ranks hold whole carries its whole gradient on every
rank, a split one its part, a partial sum the sum's.  So a sum's backward
is the identity, a gather's is the rank's part of the gradient (an FSDP
leaf's gather reduce-scatters it), and where a whole tensor feeds a computation
that differs by rank, :func:`grad_sum` (Megatron's "f") sums its
gradient over the ranks.  Backward collectives go through the same three
primitives (``_reduce``, ``_gather``, ``_moved``), so every rank issues
them in the order autograd visits the graph, the same on every rank.
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
# "redistribute": one per call that moves data), those of a backward pass
# under the kind with "/backward" after it.
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


# The three primitives below issue every collective of this module, forward
# and backward; the autograd functions after them pair each with its adjoint.


def _reduce(x: torch.Tensor, mesh, axes, op, kind: str) -> torch.Tensor:
    for a in _axes(mesh, axes):
        group = mesh.get_group(a)
        buf = x.cpu() if _staged(x, group) else x.contiguous().clone()
        dist.all_reduce(buf, op=op, group=group)
        x = buf.to(x.device)
        COLLECTIVES[kind] += 1
    return x


def _gather(x: torch.Tensor, dim: int, mesh, axes, kind: str = "gather") -> torch.Tensor:
    for a in reversed(_axes(mesh, axes)):
        group = mesh.get_group(a)
        src = x.cpu() if _staged(x, group) else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        x = torch.cat(parts, dim).to(x.device)
        COLLECTIVES[kind] += 1
    return x


def _own(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's part of dim ``dim`` of ``x`` split over mesh ``axes``
    (the first axis outermost, as :func:`all_gather` joins them)."""
    index, n = 0, 1
    for a in _axes(mesh, axes):
        i = mesh.mesh_dim_names.index(a)
        index, n = index * mesh.size(i) + mesh.get_coordinate()[i], n * mesh.size(i)
    return x if n == 1 else x.chunk(n, dim)[index]


def _grad_kind(kind: str) -> str:
    return f"{kind}/backward"


class _Sum(torch.autograd.Function):
    """A sum of partials into a value every rank then uses whole: the
    gradient of each rank's partial is the value's, unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes, dist.ReduceOp.SUM, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Max(torch.autograd.Function):
    """The elementwise max over ranks; its gradient goes to the ranks that
    hold the max, shared equally among ties."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        y = _reduce(x, mesh, axes, dist.ReduceOp.MAX, "max")
        ctx.mesh, ctx.axes = mesh, axes
        ctx.save_for_backward(x == y)
        return y

    @staticmethod
    def backward(ctx, g):
        (at,) = ctx.saved_tensors
        at = at.to(g.dtype)
        return g * at / _reduce(at, ctx.mesh, ctx.axes, dist.ReduceOp.SUM, _grad_kind("sum")), None, None


class _GradSum(torch.autograd.Function):
    """The identity forward; the sum over ranks backward (Megatron's "f"):
    where a tensor every rank holds whole feeds a computation that differs
    by rank (its heads, MLP columns or experts, its rows of a split
    sequence), each rank's gradient is a partial of the whole one."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM, _grad_kind("sum")), None, None


class _Gather(torch.autograd.Function):
    """The ranks' parts joined on ``dim``; backward, this rank's part of the
    gradient (``scatter``: the gradient summed over the ranks first, a
    reduce-scatter, where each rank used the whole differently)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes, scatter):
        ctx.args = dim, mesh, axes, scatter
        return _gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axes, scatter = ctx.args
        if scatter:
            g = _reduce(g, mesh, axes, dist.ReduceOp.SUM, _grad_kind("reduce_scatter"))
        return _own(g, dim, mesh, axes), None, None, None, None


def all_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of the local tensor ``x`` over the ranks along mesh ``axes``
    of the ``DeviceMesh`` ``mesh`` (``x`` itself where no axis splits).
    Backward the identity: every rank uses the sum whole."""
    return _Sum.apply(x, mesh, tuple(_axes(mesh, axes))) if mesh is not None and _axes(mesh, axes) else x


def all_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks along mesh ``axes``."""
    return _Max.apply(x, mesh, tuple(_axes(mesh, axes))) if mesh is not None and _axes(mesh, axes) else x


def all_gather(x: torch.Tensor, dim: int, mesh, axes, *, scatter_grad: bool = False) -> torch.Tensor:
    """The local tensors of the ranks along mesh ``axes`` joined on ``dim``,
    nested as a DTensor nests a dim sharded over them (the first axis
    outermost): the inverse of a ``Shard(dim)`` on each.  Backward, this
    rank's part of the gradient, or with ``scatter_grad`` (each rank used
    the whole on its own rows: an FSDP leaf) the gradient's sum over the
    ranks, reduce-scattered."""
    if mesh is None or not _axes(mesh, axes):
        return x
    return _Gather.apply(x, dim, mesh, tuple(_axes(mesh, axes)), scatter_grad)


def grad_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x``, whose gradient is summed over the ranks along mesh ``axes`` in
    the backward pass (Megatron's "f"); ``x`` itself where no gradient is
    built or no axis splits."""
    if mesh is None or not (torch.is_grad_enabled() and x.requires_grad) or not _axes(mesh, axes):
        return x
    return _GradSum.apply(x, mesh, tuple(_axes(mesh, axes)))


def whole(x: Any) -> Any:
    """A DTensor's global value as a plain tensor on every rank, gathered
    through :func:`all_gather` dim by dim (a host copy on gloo groups);
    anything else as it is."""
    if not is_dtensor(x):
        return x
    mesh, t, dims = x.device_mesh, x.to_local(), {}
    for i, p in enumerate(x.placements):
        if p.is_shard():
            dims.setdefault(p.dim, []).append(mesh.mesh_dim_names[i])
    for d, axes in dims.items():
        t = all_gather(t, d, mesh, tuple(axes))
    return t


def _moved(local: torch.Tensor, mesh, source, target, shape, stride, kind: str) -> torch.Tensor:
    """This rank's local tensor of a DTensor of global ``shape`` moved from
    ``source`` to ``target`` placements on ``mesh``.  gloo's functional
    collectives, which DTensor uses, crash on CUDA tensors (torch 2.11:
    a segfault in ``wait_tensor``; gloo carries CUDA ranks that share a
    card, where NCCL refuses two ranks on one device), so a CUDA tensor on
    gloo groups moves as a host copy over the same groups and comes back to
    its card.  A move that only splits replicated dims needs no collective
    and stays on the card."""
    from torch.distributed.tensor import DTensor

    moved = [(a, b) for a, b in zip(source, target) if a != b]
    if not moved:
        return local
    x = DTensor.from_local(local, mesh, source, run_check=False, shape=shape, stride=stride)
    if all(a.is_replicate() for a, _ in moved):
        return x.redistribute(mesh, target).to_local()
    COLLECTIVES[kind] += 1
    if mesh.device_type != "cuda" or dist.get_backend(mesh.get_group(0)) != "gloo":
        return x.redistribute(mesh, target).to_local()
    from torch.distributed.device_mesh import DeviceMesh

    host_mesh = DeviceMesh.from_group([mesh.get_group(i) for i in range(mesh.ndim)], "cpu", mesh=mesh.mesh,
                                      mesh_dim_names=mesh.mesh_dim_names)
    host = DTensor.from_local(local.cpu(), host_mesh, source, run_check=False, shape=shape, stride=stride)
    return host.redistribute(host_mesh, target).to_local().to(local.device)


class _Redistribute(torch.autograd.Function):
    """A layout move of a DTensor's local tensor; backward, the gradient's
    move back (a gather's is this rank's part, a split's a gather)."""

    @staticmethod
    def forward(ctx, local, mesh, source, target, shape, stride):
        ctx.args = mesh, source, target, shape, stride
        return _moved(local, mesh, source, target, shape, stride, "redistribute")

    @staticmethod
    def backward(ctx, g):
        mesh, source, target, shape, stride = ctx.args
        return _moved(g.contiguous(), mesh, target, source, shape, stride, _grad_kind("redistribute")), *[None] * 5


def redistribute(x, target: Sequence) -> Any:
    """``x`` (a DTensor) laid out as ``target`` placements on its mesh, by
    :func:`_moved`; ``x`` itself where it is laid out so already.  Under
    autograd the move's adjoint moves the gradient back."""
    from torch.distributed.tensor import DTensor

    target = list(target)
    if list(x.placements) == target:
        return x
    mesh = x.device_mesh
    local = _Redistribute.apply(x.to_local(), mesh, tuple(x.placements), tuple(target), x.shape, x.stride())
    return DTensor.from_local(local, mesh, target, run_check=False, shape=x.shape, stride=x.stride())
