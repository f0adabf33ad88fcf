"""Mesh descriptors: the reference's production and host meshes as axis
names and extents.

The port runs a step on one card, so a mesh here holds no devices and
starts nothing: it is what ``sharding.rules`` resolves a spec against, so
the reference's rule tables give the same specs on the same meshes
(``tests/test_torch_rules.py``).  Spreading a step over a mesh, and the
sweep mesh over every local device, wait for the multi-device path
(ROADMAP item 8).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0) -> Mesh:
    """A small mesh, as the reference's tests build over host devices."""
    if pod:
        return Mesh(("pod", "data", "model"), (pod, data, model))
    return Mesh(("data", "model"), (data, model))
