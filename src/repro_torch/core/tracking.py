"""Workload description: what the stream's frames *are*.

Only :class:`WorkloadSpec` is ported so far, so that ``ScenarioSpec`` parses
and round-trips the ``workload`` field with the reference's JSON schema.  The
detect+track planners and their decay tables are not ported yet; the port's
serving path plans the paper's independent-frame ``classify`` workload.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

WORKLOAD_KINDS = ("classify", "track")

DEFAULT_DECAY = 0.15
DEFAULT_DENSITY = 1.0


@dataclass(frozen=True)
class WorkloadSpec:
    """``kind="classify"`` (default) is the paper's independent-frame
    workload; ``kind="track"`` makes frames temporally coupled (a tracked
    frame scores ``det_acc * retention ** age``)."""

    kind: str = "classify"
    decay: float = DEFAULT_DECAY
    density: float = DEFAULT_DENSITY

    def __post_init__(self) -> None:
        if self.kind not in WORKLOAD_KINDS:
            raise ValueError(
                f"unknown workload kind {self.kind!r}; expected one of {WORKLOAD_KINDS}"
            )
        for name, lo, hi in (("decay", 0.0, 1.0), ("density", 0.0, None)):
            v = getattr(self, name)
            bad = (
                not isinstance(v, (int, float))
                or isinstance(v, bool)
                or v < lo
                or (hi is not None and v > hi)
            )
            if bad:
                rng = f"[{lo}, {hi}]" if hi is not None else f">= {lo}"
                raise ValueError(f"workload {name} must be a number {rng}, got {v!r}")

    @property
    def is_track(self) -> bool:
        return self.kind == "track"

    def to_json(self) -> dict[str, Any]:
        return {"kind": self.kind, "decay": self.decay, "density": self.density}

    @staticmethod
    def from_json(data: Mapping[str, Any]) -> "WorkloadSpec":
        if not isinstance(data, Mapping) or "kind" not in data:
            raise ValueError(f"not a WorkloadSpec payload: {data!r}")
        return WorkloadSpec(
            kind=str(data["kind"]),
            decay=float(data.get("decay", DEFAULT_DECAY)),
            density=float(data.get("density", DEFAULT_DENSITY)),
        )
