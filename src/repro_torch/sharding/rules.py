"""Logical-axis -> mesh-axis rules, with divisibility and reuse guards.

One rule table serves every architecture: a rule maps a logical axis name
("mlp", "heads", "kv_seq", ...) to a mesh axis or tuple of mesh axes.  When a
spec is resolved, an axis is dropped (replicated) if (a) the dimension size
is not divisible by the mesh extent, or (b) any of its mesh axes was already
consumed by an earlier dimension of the same tensor.

The tables and ``MeshRules._resolve`` are the reference's, value for value.
A resolved spec is a plain tuple, one entry per dimension (``None``, an
axis name, or a tuple of names), with trailing ``None``s dropped as
``jax.sharding.PartitionSpec`` drops them.  The port runs on one card: a
mesh is a descriptor (``launch/mesh``), and ``constrain`` over a mesh of
more than one device, ``sweep_rules`` and a step built with rules wait for
the multi-device path (ROADMAP item 8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from ..launch.mesh import Mesh
from ..models.common import ParamSpec, tree_map

Rules = Mapping[str, Any]  # logical name -> mesh axis | tuple of axes | None
Spec = tuple  # per dimension: None | axis name | tuple of axis names


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

    def spec_sharding(self, s: ParamSpec) -> Spec:
        return self._resolve(s.shape, s.axes)

    def tree_shardings(self, specs) -> Any:
        return tree_map(self.spec_sharding, specs)

    def logical(self, sizes: Sequence[int], axes: Sequence[str | None]) -> Spec:
        return self._resolve(sizes, axes)

    def constrain(self, x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
        """The identity on a one-device mesh, where every spec resolves to
        replicated."""
        if self.mesh.size != 1:
            raise NotImplementedError(
                f"constrain over a {self.mesh.shape} mesh: the port runs on one card (ROADMAP item 8)")
        return x
