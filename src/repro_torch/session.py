"""The front door: declarative scenarios + one Session facade.

A :class:`ScenarioSpec` describes a whole experiment — stream shape, model
profiles, network trace, scheduling policy (a registry ``PolicySpec``), and
optional multi-tenant fleet options — and round-trips through JSON with the
reference's schema, so one spec file runs in either package.
:class:`Session` routes a spec to an execution engine behind a uniform
:class:`RunReport`:

    run_sim      single stream through the audited simulator (§VI figures)
    run_multi    N streams on a shared fluid uplink + edge server
    run_online   the OnlineController with *estimated* bandwidth, audited
                 against the true trace (the deployable configuration)
    run_serving  real models on the card behind the controller (launch/serve)
    run_sweep    a whole (bandwidth x deadline x fps x policy-param) grid in
                 one call — lane-batched on the device for ``batched=True``
                 policies (core/sim_batch), fleet grids of
                 ``batched_multi=True`` policies (core/sim_multi_batch) and,
                 with ``mode="online"``, ``batched_online=True`` policies
                 (core/sim_online_batch); the per-point loop otherwise

Policies that plan with tensor ops (``jax_accuracy``, ``jax_utility``) and
the batched sweep engines run on the Session's device.

    from repro_torch.core.registry import PolicySpec
    from repro_torch.session import ScenarioSpec, Session

    spec = ScenarioSpec(policy=PolicySpec("max_accuracy"), n_frames=120)
    report = Session(spec).run_sim()          # device="cuda" by default
    print(report.stats.mean_accuracy)

or from the shell::

    PYTHONPATH=src python -m repro_torch.session scenario.json --mode sim --device cpu
    PYTHONPATH=src python -m repro_torch.session sweep scenario.json --grid grid.json --device cpu
    PYTHONPATH=src python -m repro_torch.session sweep scenario.json --grid grid.json --mode online
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import logging
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import torch
import torch.distributed as dist

from .core import sim_batch, sim_multi_batch, sim_online_batch
from .core.audit import AUDIT_TOL, apply_round, audit_round
from .core.compile_cache import default_cache_dir, enable_compile_cache
from .core.controller import BandwidthEstimator, OnlineController
from .core.edge_server import ALLOCATION_POLICIES, EdgeServerScheduler, make_fleet
from .core.profiles import PAPER_MODELS, ModelProfile, StreamSpec
from .core.registry import PolicySpec, available_policies, get_policy
from .core.schedule import StreamStats
from .core.simulator import Trace, simulate, simulate_multi
from .core.tracking import WorkloadSpec
from .device import resolve_device

__all__ = [
    "FleetSpec",
    "RunReport",
    "ScenarioSpec",
    "Session",
    "SweepGrid",
    "SweepPoint",
    "SweepReport",
    "SweepSummary",
    "TraceSpec",
    "WorkloadSpec",
]

_PRESET_MODELS: dict[str, ModelProfile] = {m.name: m for m in PAPER_MODELS}
_LOG = logging.getLogger("repro_torch.session")


# ---------------------------------------------------------------------------
# Serializable pieces
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TraceSpec:
    """Declarative network trace: constant or piecewise bandwidth over time."""

    kind: str = "constant"  # "constant" | "piecewise"
    mbps: float = 2.5
    rtt_ms: float = 100.0
    points: tuple[tuple[float, float], ...] = ()  # [(t_start_s, mbps), ...]

    def __post_init__(self) -> None:
        if self.kind not in ("constant", "piecewise"):
            raise ValueError(f"unknown trace kind {self.kind!r}; want constant|piecewise")
        if self.kind == "piecewise" and not self.points:
            raise ValueError("piecewise trace needs at least one (t_start, mbps) point")
        # Normalize fields the active kind does not use, so equality (and the
        # JSON round-trip, which only serializes the active fields) is exact.
        if self.kind == "constant":
            object.__setattr__(self, "points", ())
        else:
            object.__setattr__(self, "mbps", 2.5)
            pts = tuple((float(t), float(v)) for t, v in self.points)
            # Same validation as Trace.piecewise, surfaced at spec time (and
            # as CLI exit 2) instead of as a nonsense lookup mid-simulation.
            for (t0, _), (t1, _) in zip(pts, pts[1:]):
                if t1 <= t0:
                    raise ValueError(
                        f"piecewise trace time points must be strictly "
                        f"increasing, got t={t1!r} after t={t0!r}"
                    )
            for ts, v in pts:
                if v < 0:
                    raise ValueError(
                        f"piecewise trace bandwidth must be >= 0 Mbps, "
                        f"got {v!r} at t={ts!r}"
                    )
            object.__setattr__(self, "points", pts)

    def build(self) -> Trace:
        if self.kind == "piecewise":
            return Trace.piecewise(list(self.points), rtt_ms=self.rtt_ms)
        return Trace.constant(self.mbps, rtt_ms=self.rtt_ms)

    def segments(self) -> tuple[tuple[float, float], ...]:
        """Lower to ``(t_start_s, bandwidth_bps)`` segments — the batched
        engine's trace representation (a constant trace is one segment at
        t=0), with ``Trace.piecewise``'s bps conversion."""
        if self.kind == "piecewise":
            return tuple((float(t), float(v) * 1e6) for t, v in self.points)
        return ((0.0, float(self.mbps) * 1e6),)

    @property
    def rtt_s(self) -> float:
        return self.rtt_ms / 1e3

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {"kind": self.kind, "rtt_ms": self.rtt_ms}
        if self.kind == "constant":
            out["mbps"] = self.mbps
        else:
            out["points"] = [list(p) for p in self.points]
        return out

    @staticmethod
    def from_json(data: Mapping[str, Any]) -> "TraceSpec":
        return TraceSpec(
            kind=str(data.get("kind", "constant")),
            mbps=float(data.get("mbps", 2.5)),
            rtt_ms=float(data.get("rtt_ms", 100.0)),
            points=tuple((float(t), float(v)) for t, v in data.get("points", ())),
        )


@dataclass(frozen=True)
class FleetSpec:
    """Multi-tenant options for ``run_multi``: N clients, one edge server."""

    n_clients: int = 2
    allocation: str = "weighted_fair"  # see edge_server.ALLOCATION_POLICIES
    capacity: int = 4
    backlog_limit: float = 0.0
    weights: tuple[float, ...] | None = None
    priorities: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        if self.n_clients < 1:
            raise ValueError("fleet needs n_clients >= 1")
        if self.allocation not in ALLOCATION_POLICIES:
            raise ValueError(
                f"unknown allocation {self.allocation!r}; want one of {ALLOCATION_POLICIES}"
            )
        for name in ("weights", "priorities"):
            v = getattr(self, name)
            if v is not None:
                v = tuple(v)
                object.__setattr__(self, name, v)
                if len(v) != self.n_clients:
                    raise ValueError(f"{name} must have n_clients={self.n_clients} entries")

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "n_clients": self.n_clients,
            "allocation": self.allocation,
            "capacity": self.capacity,
            "backlog_limit": self.backlog_limit,
        }
        if self.weights is not None:
            out["weights"] = list(self.weights)
        if self.priorities is not None:
            out["priorities"] = list(self.priorities)
        return out

    @staticmethod
    def from_json(data: Mapping[str, Any]) -> "FleetSpec":
        return FleetSpec(
            n_clients=int(data.get("n_clients", 2)),
            allocation=str(data.get("allocation", "weighted_fair")),
            capacity=int(data.get("capacity", 4)),
            backlog_limit=float(data.get("backlog_limit", 0.0)),
            weights=tuple(data["weights"]) if data.get("weights") is not None else None,
            priorities=tuple(data["priorities"]) if data.get("priorities") is not None else None,
        )


def _model_to_json(m: ModelProfile) -> Any:
    """Presets serialize by name; custom profiles serialize in full."""
    preset = _PRESET_MODELS.get(m.name)
    if preset == m:
        return m.name
    return {
        "name": m.name,
        "t_npu_ms": m.t_npu * 1e3 if m.t_npu != float("inf") else None,
        "t_server_ms": m.t_server * 1e3 if m.t_server != float("inf") else None,
        "acc_server": {str(r): a for r, a in m.acc_server.items()},
        "acc_npu": {str(r): a for r, a in m.acc_npu.items()},
    }


def _model_from_json(data: Any) -> ModelProfile:
    if isinstance(data, ModelProfile):
        return data
    if isinstance(data, str):
        try:
            return _PRESET_MODELS[data]
        except KeyError:
            raise ValueError(
                f"unknown model preset {data!r}; presets: {sorted(_PRESET_MODELS)}"
            ) from None
    if not isinstance(data, Mapping) or "name" not in data:
        raise ValueError(f"not a model payload: {data!r}")
    t_npu = data.get("t_npu_ms")
    t_server = data.get("t_server_ms")
    return ModelProfile(
        name=str(data["name"]),
        t_npu=float(t_npu) / 1e3 if t_npu is not None else float("inf"),
        t_server=float(t_server) / 1e3 if t_server is not None else float("inf"),
        acc_server={int(r): float(a) for r, a in (data.get("acc_server") or {}).items()},
        acc_npu={int(r): float(a) for r, a in (data.get("acc_npu") or {}).items()},
    )


def _stream_to_json(s: StreamSpec) -> dict[str, Any]:
    return {
        "fps": s.fps,
        "deadline_ms": s.deadline * 1e3,
        "resolutions": list(s.resolutions),
        "png_ratio": s.png_ratio,
    }


def _stream_from_json(data: Mapping[str, Any]) -> StreamSpec:
    base = StreamSpec()
    return StreamSpec(
        fps=float(data.get("fps", base.fps)),
        deadline=float(data.get("deadline_ms", base.deadline * 1e3)) / 1e3,
        resolutions=tuple(int(r) for r in data.get("resolutions", base.resolutions)),
        png_ratio=float(data.get("png_ratio", base.png_ratio)),
    )


@dataclass(frozen=True)
class ScenarioSpec:
    """One experiment, declaratively: who streams what, over which network,
    scheduled by which policy.  JSON round-trippable (``to_json``/``from_json``)
    so benchmark sweeps and CI smoke runs are reproducible artifacts.

    ``models`` entries may be preset names (``"resnet-50"``/``"squeezenet"``),
    payload dicts or full :class:`ModelProfile` objects; they normalize to
    profiles.  ``run_serving`` reads only each model's name, which selects a
    classifier of ``repro_torch.configs`` (``resnet-50``, ``squeezenet``,
    ``vit-s16``, ``efficientnet-b7``, ``swin-b``): ``{"name": "swin-b"}``
    serves Swin-B.
    ``fleet`` is only consulted by ``run_multi``; ``seed`` only by serving.
    ``workload`` selects the frame semantics (classification by default,
    detect+track with ``WorkloadSpec(kind="track")``) and must be one the
    policy declares it can plan (``PolicyEntry.workloads``).
    """

    policy: PolicySpec
    n_frames: int = 120
    stream: StreamSpec = field(default_factory=StreamSpec)
    models: tuple[ModelProfile, ...] = ("resnet-50", "squeezenet")  # type: ignore[assignment]
    trace: TraceSpec = field(default_factory=TraceSpec)
    fleet: FleetSpec | None = None
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    strict: bool = True
    seed: int = 0
    label: str = ""

    def __post_init__(self) -> None:
        if isinstance(self.policy, (str, Mapping)):
            spec = (
                PolicySpec(self.policy)
                if isinstance(self.policy, str)
                else PolicySpec.from_json(self.policy)
            )
            object.__setattr__(self, "policy", spec)
        if self.n_frames < 1:
            raise ValueError("n_frames must be >= 1")
        object.__setattr__(
            self, "models", tuple(_model_from_json(m) for m in self.models)
        )
        if not self.models:
            raise ValueError("scenario needs at least one model")
        if isinstance(self.workload, str):
            object.__setattr__(self, "workload", WorkloadSpec(kind=self.workload))
        elif isinstance(self.workload, Mapping):
            object.__setattr__(self, "workload", WorkloadSpec.from_json(self.workload))
        entry = get_policy(self.policy.name)
        if self.workload.kind not in entry.workloads:
            raise ValueError(
                f"policy {self.policy.name!r} plans "
                f"{'/'.join(entry.workloads)} workloads, not "
                f"{self.workload.kind!r}"
            )

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "policy": self.policy.to_json(),
            "n_frames": self.n_frames,
            "stream": _stream_to_json(self.stream),
            "models": [_model_to_json(m) for m in self.models],
            "trace": self.trace.to_json(),
            "strict": self.strict,
            "seed": self.seed,
        }
        if self.fleet is not None:
            out["fleet"] = self.fleet.to_json()
        if self.workload != WorkloadSpec():
            out["workload"] = self.workload.to_json()
        if self.label:
            out["label"] = self.label
        return out

    @staticmethod
    def from_json(data: Mapping[str, Any] | str) -> "ScenarioSpec":
        if isinstance(data, str):
            data = json.loads(data)
        if not isinstance(data, Mapping) or "policy" not in data:
            raise ValueError("not a ScenarioSpec payload (missing 'policy')")
        return ScenarioSpec(
            policy=PolicySpec.from_json(data["policy"]),
            n_frames=int(data.get("n_frames", 120)),
            stream=_stream_from_json(data.get("stream") or {}),
            models=tuple(data.get("models") or ("resnet-50", "squeezenet")),
            trace=TraceSpec.from_json(data.get("trace") or {}),
            fleet=FleetSpec.from_json(data["fleet"]) if data.get("fleet") else None,
            workload=(
                WorkloadSpec.from_json(data["workload"])
                if data.get("workload")
                else WorkloadSpec()
            ),
            strict=bool(data.get("strict", True)),
            seed=int(data.get("seed", 0)),
            label=str(data.get("label", "")),
        )


# ---------------------------------------------------------------------------
# Uniform result wrapper
# ---------------------------------------------------------------------------


@dataclass
class RunReport:
    """What every run mode returns: audited per-stream stats + metadata."""

    mode: str
    spec: ScenarioSpec
    streams: list[StreamStats]
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def stats(self) -> StreamStats:
        """The single stream's stats (modes sim/online; first client in multi)."""
        return self.streams[0]

    @property
    def aggregate_accuracy(self) -> float:
        total = sum(s.frames_total for s in self.streams)
        return sum(s.accuracy_sum for s in self.streams) / total if total else 0.0

    @property
    def max_miss_rate(self) -> float:
        return max(
            (s.frames_missed_deadline / s.frames_total for s in self.streams if s.frames_total),
            default=0.0,
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "mode": self.mode,
            "label": self.spec.label,
            "policy": self.spec.policy.to_json(),
            "streams": [dataclasses.asdict(s) for s in self.streams],
            "aggregate_accuracy": self.aggregate_accuracy,
            "max_miss_rate": self.max_miss_rate,
            "meta": self.meta,
        }


# ---------------------------------------------------------------------------
# Sweep grids: many scenarios in one call (JSON schema shared with the
# reference, so a grid or report written by one package loads in the other)
# ---------------------------------------------------------------------------


def _axis_values(name: str, values: Any) -> tuple:
    """Normalize one grid axis to a tuple, rejecting scalars and strings —
    ``"fifo"`` must not silently become the 4-point axis ('f','i','f','o')."""
    if isinstance(values, (str, bytes)) or not hasattr(values, "__iter__"):
        raise ValueError(
            f"SweepGrid axis {name!r} must be a list of values, got {values!r}"
        )
    return tuple(values)


@dataclass(frozen=True)
class SweepGrid:
    """A cartesian scenario grid over one base :class:`ScenarioSpec`.

    Scenario axes override spec fields; ``params`` axes override the policy's
    parameters (e.g. ``{"alpha": (50.0, 200.0)}``).  Empty axes are simply
    absent from the product — an all-empty grid is the single base scenario.
    """

    bandwidth_mbps: tuple[float, ...] = ()
    deadline_ms: tuple[float, ...] = ()
    fps: tuple[float, ...] = ()
    rtt_ms: tuple[float, ...] = ()
    n_clients: tuple[int, ...] = ()
    allocation: tuple[str, ...] = ()
    params: Mapping[str, tuple] = field(default_factory=dict)

    SCENARIO_AXES = ("bandwidth_mbps", "deadline_ms", "fps", "rtt_ms", "n_clients", "allocation")

    def __post_init__(self) -> None:
        for name in self.SCENARIO_AXES:
            object.__setattr__(self, name, _axis_values(name, getattr(self, name)))
        if not isinstance(self.params, Mapping):
            raise ValueError(
                f"SweepGrid params must be a mapping of axis name -> values, "
                f"got {self.params!r}"
            )
        params = {str(k): _axis_values(k, v) for k, v in self.params.items()}
        for k in params:
            if k in self.SCENARIO_AXES:
                raise ValueError(f"param axis {k!r} shadows a scenario axis")
            if not params[k]:
                raise ValueError(f"param axis {k!r} is empty")
        object.__setattr__(self, "params", params)

    def axes(self) -> list[tuple[str, tuple]]:
        """Non-empty (name, values) axes, scenario axes first."""
        out = [(n, getattr(self, n)) for n in self.SCENARIO_AXES if getattr(self, n)]
        out.extend(self.params.items())
        return out

    def iter_points(self) -> Iterator[dict[str, Any]]:
        """Lazily yield every grid point as an override dict, in row-major
        axis order — the streaming twin of :meth:`points`."""
        axes = self.axes()
        if not axes:
            yield {}
            return
        names = [n for n, _ in axes]
        for combo in itertools.product(*(vals for _, vals in axes)):
            yield dict(zip(names, combo))

    def points(self) -> list[dict[str, Any]]:
        """Every grid point as an override dict, in row-major axis order."""
        return list(self.iter_points())

    def __len__(self) -> int:
        n = 1
        for _, vals in self.axes():
            n *= len(vals)
        return n

    def to_json(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            n: list(getattr(self, n)) for n in self.SCENARIO_AXES if getattr(self, n)
        }
        if self.params:
            out["params"] = {k: list(v) for k, v in self.params.items()}
        return out

    @staticmethod
    def from_json(data: Mapping[str, Any] | str) -> "SweepGrid":
        if isinstance(data, str):
            data = json.loads(data)
        if not isinstance(data, Mapping):
            raise ValueError(f"not a SweepGrid payload: {data!r}")
        unknown = set(data) - set(SweepGrid.SCENARIO_AXES) - {"params"}
        if unknown:
            raise ValueError(
                f"unknown SweepGrid axes {sorted(unknown)}; "
                f"scenario axes: {SweepGrid.SCENARIO_AXES} (policy params go under 'params')"
            )
        return SweepGrid(
            **{n: data.get(n, ()) for n in SweepGrid.SCENARIO_AXES},
            params=data.get("params") or {},
        )


def _apply_point(base: ScenarioSpec, pt: Mapping[str, Any]) -> ScenarioSpec:
    """Materialize one grid point: base spec + axis overrides."""
    stream_kw: dict[str, Any] = {}
    if "deadline_ms" in pt:
        stream_kw["deadline"] = float(pt["deadline_ms"]) / 1e3
    if "fps" in pt:
        stream_kw["fps"] = float(pt["fps"])
    stream = dataclasses.replace(base.stream, **stream_kw) if stream_kw else base.stream

    trace = base.trace
    if "bandwidth_mbps" in pt:  # a bandwidth axis implies a constant trace
        trace = TraceSpec(
            kind="constant",
            mbps=float(pt["bandwidth_mbps"]),
            rtt_ms=float(pt.get("rtt_ms", base.trace.rtt_ms)),
        )
    elif "rtt_ms" in pt:
        trace = dataclasses.replace(trace, rtt_ms=float(pt["rtt_ms"]))

    fleet = base.fleet
    if "n_clients" in pt or "allocation" in pt:
        fleet = fleet if fleet is not None else FleetSpec()
        if "n_clients" in pt and (fleet.weights is not None or fleet.priorities is not None):
            raise ValueError(
                "an n_clients grid axis cannot resize a fleet with explicit "
                "per-client weights/priorities"
            )
        fleet_kw: dict[str, Any] = {}
        if "n_clients" in pt:
            fleet_kw["n_clients"] = int(pt["n_clients"])
        if "allocation" in pt:
            fleet_kw["allocation"] = str(pt["allocation"])
        fleet = dataclasses.replace(fleet, **fleet_kw)

    param_over = {k: v for k, v in pt.items() if k not in SweepGrid.SCENARIO_AXES}
    policy = base.policy
    if param_over:
        policy = PolicySpec(policy.name, {**policy.params, **param_over})

    return dataclasses.replace(base, policy=policy, stream=stream, trace=trace, fleet=fleet)


@dataclass
class SweepPoint:
    """One audited grid point: its axis overrides + per-stream stats."""

    overrides: dict[str, Any]
    streams: list[StreamStats]
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def stats(self) -> StreamStats:
        return self.streams[0]

    @property
    def aggregate_accuracy(self) -> float:
        total = sum(s.frames_total for s in self.streams)
        return sum(s.accuracy_sum for s in self.streams) / total if total else 0.0

    @property
    def max_miss_rate(self) -> float:
        return max(
            (s.frames_missed_deadline / s.frames_total for s in self.streams if s.frames_total),
            default=0.0,
        )

    def to_json(self) -> dict[str, Any]:
        return {
            "overrides": dict(self.overrides),
            "streams": [dataclasses.asdict(s) for s in self.streams],
            "meta": self.meta,
        }

    @staticmethod
    def from_json(data: Mapping[str, Any]) -> "SweepPoint":
        return SweepPoint(
            overrides=dict(data.get("overrides") or {}),
            streams=[StreamStats(**s) for s in data.get("streams") or []],
            meta=dict(data.get("meta") or {}),
        )


@dataclass
class SweepSummary:
    """Streaming reduction of a sweep's per-point stats.

    ``run_sweep`` folds each executed chunk into one of these, so a large
    grid can report aggregate frames/accuracy/miss extremes without keeping
    every :class:`SweepPoint` on the host (``keep_points=False``).  Attached
    to ``SweepReport.meta["summary"]`` as plain JSON whenever the sweep ran
    chunked or point-free."""

    n_points: int = 0
    n_streams: int = 0
    frames_total: int = 0
    frames_processed: int = 0
    frames_missed_deadline: int = 0
    frames_offloaded: int = 0
    accuracy_sum: float = 0.0
    best_accuracy: float = 0.0
    best_point: dict[str, Any] | None = None
    max_miss_rate: float = 0.0
    worst_point: dict[str, Any] | None = None

    def update(self, point: SweepPoint) -> None:
        self.n_points += 1
        self.n_streams += len(point.streams)
        for s in point.streams:
            self.frames_total += s.frames_total
            self.frames_processed += s.frames_processed
            self.frames_missed_deadline += s.frames_missed_deadline
            self.frames_offloaded += s.frames_offloaded
            self.accuracy_sum += s.accuracy_sum
        acc = point.aggregate_accuracy
        if self.best_point is None or acc > self.best_accuracy:
            self.best_accuracy, self.best_point = acc, dict(point.overrides)
        miss = point.max_miss_rate
        if self.worst_point is None or miss > self.max_miss_rate:
            self.max_miss_rate, self.worst_point = miss, dict(point.overrides)

    @property
    def mean_accuracy(self) -> float:
        return self.accuracy_sum / self.frames_total if self.frames_total else 0.0

    def to_json(self) -> dict[str, Any]:
        out = dataclasses.asdict(self)
        out["mean_accuracy"] = self.mean_accuracy
        return out

    @staticmethod
    def from_json(data: Mapping[str, Any]) -> "SweepSummary":
        fields = {f.name for f in dataclasses.fields(SweepSummary)}
        return SweepSummary(**{k: v for k, v in data.items() if k in fields})


@dataclass
class SweepReport:
    """What ``Session.run_sweep`` returns: the base spec, the grid, which
    engine actually ran (``backend``), and one :class:`SweepPoint` per grid
    point in ``grid.points()`` order.  ``to_json``/``from_json`` round-trip
    losslessly, so a sweep is a replayable artifact.

    Chunked/streamed sweeps (``chunk_size=``/``keep_points=False``) carry
    their incremental :class:`SweepSummary` in ``meta["summary"]``; with
    ``keep_points=False`` the summary is the whole artifact and ``points``
    is empty."""

    base: ScenarioSpec
    grid: SweepGrid
    backend: str  # "reference" | "batched" — the engine that actually ran
    points: list[SweepPoint]
    meta: dict[str, Any] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self) -> Iterator[SweepPoint]:
        return iter(self.points)

    def to_json(self) -> dict[str, Any]:
        return {
            "base": self.base.to_json(),
            "grid": self.grid.to_json(),
            "backend": self.backend,
            "points": [p.to_json() for p in self.points],
            "meta": self.meta,
        }

    @staticmethod
    def from_json(data: Mapping[str, Any] | str) -> "SweepReport":
        if isinstance(data, str):
            data = json.loads(data)
        if not isinstance(data, Mapping) or "base" not in data or "grid" not in data:
            raise ValueError("not a SweepReport payload (missing 'base'/'grid')")
        return SweepReport(
            base=ScenarioSpec.from_json(data["base"]),
            grid=SweepGrid.from_json(data["grid"]),
            backend=str(data.get("backend", "reference")),
            points=[SweepPoint.from_json(p) for p in data.get("points") or []],
            meta=dict(data.get("meta") or {}),
        )


# ---------------------------------------------------------------------------
# Session facade
# ---------------------------------------------------------------------------

class Session:
    """Routes one :class:`ScenarioSpec` to an execution engine on ``device``
    (``"cuda"`` by default; asking for the card where there is none raises)."""

    MODES = ("sim", "multi", "online", "serving")

    def __init__(self, spec: ScenarioSpec, *, device: torch.device | str = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)

    def run(self, mode: str = "sim") -> RunReport:
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}; want one of {self.MODES}")
        return getattr(self, f"run_{mode}")()

    # -- mode: audited single-stream simulation ----------------------------
    def run_sim(self) -> RunReport:
        spec = self.spec
        stats = simulate(
            spec.policy.build(device=self.device),
            list(spec.models),
            spec.stream,
            spec.trace.build(),
            spec.n_frames,
            strict=spec.strict,
            workload=spec.workload,
        )
        return RunReport("sim", spec, [stats], meta={"policy": spec.policy.name})

    # -- mode: N streams, shared fluid uplink + edge server ----------------
    def run_multi(self) -> RunReport:
        spec = self.spec
        fleet = spec.fleet if spec.fleet is not None else FleetSpec()
        clients = make_fleet(
            fleet.n_clients,
            stream=spec.stream,
            models=list(spec.models),
            policy=spec.policy,
            weights=fleet.weights,
            priorities=fleet.priorities,
            device=self.device,
        )
        sched = EdgeServerScheduler(
            clients,
            policy=fleet.allocation,
            capacity=fleet.capacity,
            backlog_limit=fleet.backlog_limit,
        )
        ms = simulate_multi(
            sched,
            spec.trace.build(),
            spec.n_frames,
            strict=spec.strict,
            workload=spec.workload,
        )
        return RunReport(
            "multi",
            spec,
            ms.per_client,
            meta={
                "allocation": fleet.allocation,
                "server_jobs": ms.server_jobs,
                "server_utilization": ms.server_utilization,
                "grants": sched.audit.grants,
                "denials": sched.audit.denials,
            },
        )

    # -- mode: online controller with estimated bandwidth ------------------
    def run_online(self) -> RunReport:
        """Drive :class:`OnlineController` over the trace: the policy sees
        only the EWMA estimator's belief (fed back from the uploads the plans
        actually perform), while the audit uses the *true* trace — offload
        finish times are recomputed at real bandwidth, so an optimistic
        estimate shows up as deadline misses, exactly as in deployment."""
        spec = self.spec
        if spec.workload.is_track:
            raise ValueError(
                "mode 'online' does not execute the tracking workload yet; "
                "use run_sim/run_multi"
            )
        models = list(spec.models)
        stream = spec.stream
        trace = spec.trace.build()
        gamma, deadline = stream.gamma, stream.deadline
        controller = OnlineController(
            models=models,
            stream=stream,
            policy=spec.policy,
            estimator=BandwidthEstimator(init_bps=trace.at(0.0).bandwidth_bps),
            device=self.device,
        )
        controller.estimator.observe_rtt(trace.at(0.0).rtt)
        stats = StreamStats(frames_total=spec.n_frames, elapsed=spec.n_frames * gamma)
        head = 0
        net_free_abs = 0.0  # true-link serial occupancy
        while head < spec.n_frames:
            t0 = head * gamma
            true_net = trace.at(t0)
            wall = time.perf_counter()
            plan = controller.next_plan(head)
            stats.schedule_time += time.perf_counter() - wall
            stats.schedule_calls += 1

            horizon, bad = audit_round(
                plan, gamma=gamma, deadline=deadline, strict=spec.strict, npu_only=True
            )

            def offload(d, m, *, t0=t0, true_net=true_net):
                nonlocal net_free_abs
                arrival_abs = t0 + d.frame * gamma
                nbytes = stream.frame_bytes(d.resolution)
                t_up = true_net.upload_time(nbytes)
                start = max(net_free_abs, t0 + max(d.start, 0.0))
                finish = start + t_up + true_net.rtt + m.t_server
                net_free_abs = start + t_up
                controller.report_upload(nbytes, t_up)
                controller.report_rtt(true_net.rtt)
                if finish <= arrival_abs + deadline + AUDIT_TOL:
                    stats.frames_processed += 1
                    stats.frames_offloaded += 1
                    stats.accuracy_sum += m.accuracy(d.resolution, where="server")
                else:
                    stats.frames_missed_deadline += 1

            apply_round(
                stats,
                plan,
                models=models,
                stream=stream,
                head=head,
                n_frames=spec.n_frames,
                horizon=horizon,
                bad_frames=bad,
                on_offload=offload,
            )
            head += horizon
        return RunReport(
            "online",
            spec,
            [stats],
            meta={
                "rounds": controller.rounds,
                "estimated_bps": controller.estimator.state().bandwidth_bps,
            },
        )

    # -- mode: a whole scenario grid in one call ---------------------------
    BACKENDS = ("auto", "reference", "batched")
    SWEEP_MODES = ("auto", "online")

    def run_sweep(
        self,
        grid: SweepGrid,
        *,
        backend: str = "auto",
        mode: str = "auto",
        chunk_size: int | None = None,
        keep_points: bool = True,
        compile_cache: str | None = None,
    ) -> SweepReport:
        """Run the base scenario across every point of ``grid``.

        Backend routing is the reference's: single-stream grids of policies
        registered ``batched=True`` run lane-batched on the Session's device
        (``core/sim_batch``; the network-aware planners replay constant and
        piecewise traces there), and grids with a fleet at every point of
        policies registered ``batched_multi=True`` on the fleet engine
        (``core/sim_multi_batch``: the interacting clients' shared uplink
        and edge server); anything else runs the per-point engines
        (``run_sim``, or ``run_multi`` when the point has a fleet).
        Requesting ``backend="batched"`` for a policy/grid combination
        without a batched engine logs a warning and falls back to the
        per-point loop, recorded in ``meta["fallback"]``.

        ``chunk_size`` plans the grid as a lazy iterator of chunks instead
        of materializing every spec upfront.  Chunking is result-invariant
        (shape groups are per-scenario and padding is inert), and each
        chunk's stats fold into an incremental :class:`SweepSummary` in
        ``meta["summary"]``.  ``keep_points=False`` drops per-point results
        after folding them into the summary.  A shape group's lane program
        (on the card, its captured CUDA graph) is kept for the life of the
        process (``core/sweep_shard``), so later chunks and later sweeps of
        the same shapes reuse it.  ``compile_cache`` (or
        ``$REPRO_COMPILE_CACHE``) names the reference's persistent cache
        directory: the port writes nothing there, since a CUDA graph cannot
        outlive its process, and records ``{"dir": ..., "persistent":
        False, "scope": "process"}`` in ``meta["compile_cache"]``.

        ``mode="online"`` sweeps the observe->replan->execute world of
        ``run_online`` instead of the oracle-bandwidth simulator: each grid
        point plans against an EWMA bandwidth belief and is audited against
        the true trace.  Policies registered ``batched_online=True`` run the
        whole grid through ``core/sim_online_batch``; every other policy
        runs ``run_online`` point by point.  Online sweeps are
        single-stream.

        Under a process group of W ranks (``torchrun``, each rank calling
        ``run_sweep`` on the same grid), every batched shape group spreads
        its lanes over the ranks (``core/sweep_shard.run_sharded``) and
        every rank returns the whole report, equal to one rank's.
        """
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; want one of {self.BACKENDS}")
        if mode not in self.SWEEP_MODES:
            raise ValueError(f"unknown sweep mode {mode!r}; want one of {self.SWEEP_MODES}")
        if chunk_size is not None and int(chunk_size) < 1:
            raise ValueError(f"chunk_size must be a positive int, got {chunk_size!r}")
        cache_dir = compile_cache if compile_cache is not None else default_cache_dir()
        entry = get_policy(self.spec.policy.name)
        n_points = len(grid)
        chunk = n_points if chunk_size is None else int(chunk_size)
        # A bandwidth_mbps axis *replaces* the base trace; on a piecewise
        # base that discards the time-varying profile — surface it (logged
        # once, recorded per point below).
        clobbers = bool(grid.bandwidth_mbps) and self.spec.trace.kind == "piecewise"
        if clobbers:
            _LOG.warning(
                "sweep axis 'bandwidth_mbps' replaces the piecewise base trace "
                "with a constant trace at %d grid point(s); drop the axis (or "
                "use a constant base trace) if the time-varying profile matters",
                n_points,
            )
        meta: dict[str, Any] = {"requested_backend": backend, "grid_points": n_points,
                                "device": str(self.device)}
        if mode != "auto":
            meta["mode"] = mode
        if cache_dir:
            meta["compile_cache"] = enable_compile_cache(cache_dir)
        streaming = chunk_size is not None or not keep_points
        summary = SweepSummary() if streaming else None
        out_points: list[SweepPoint] = []
        groups: list[dict[str, Any]] = []
        use_batched: bool | None = None  # decided on the first chunk
        t0 = time.perf_counter()
        it = grid.iter_points()
        n_chunks = 0
        while True:
            pts = list(itertools.islice(it, chunk))
            if not pts:
                break
            n_chunks += 1
            specs = [_apply_point(self.spec, p) for p in pts]
            if mode == "online" and any(s.fleet is not None for s in specs):
                raise ValueError(
                    "sweep mode 'online' is single-stream (run_online has no "
                    "fleet engine); drop the fleet or use mode='auto'"
                )
            if mode == "online" and any(s.workload.is_track for s in specs):
                raise ValueError(
                    "mode 'online' does not execute the tracking workload "
                    "yet; use run_sim/run_multi/run_sweep"
                )
            if use_batched is None:
                capable, why = self._batched_capability(entry, specs, mode=mode)
                use_batched = capable if backend == "auto" else backend == "batched"
                if use_batched and not capable:
                    _LOG.warning(
                        "%s; run_sweep falling back to the reference loop "
                        "(batched policies: %s; batched fleet policies: %s; "
                        "batched online policies: %s)", why,
                        sim_batch.batched_policies(), sim_multi_batch.multi_batched_policies(),
                        sim_online_batch.batched_online_policies(),
                    )
                    meta["fallback"] = why
                    use_batched = False
                if use_batched:
                    if mode == "online":
                        meta["engine"] = "sim_online_batch"
                    else:
                        meta["engine"] = ("sim_multi_batch" if any(s.fleet is not None for s in specs)
                                          else "sim_batch")
            if use_batched and meta["engine"] == "sim_online_batch":
                points = self._sweep_batched_online(specs, pts, groups)
            elif use_batched and meta["engine"] == "sim_multi_batch":
                points = self._sweep_batched_multi(specs, pts, groups)
            elif use_batched:
                points = self._sweep_batched(specs, pts, groups)
            else:
                points = [self._sweep_reference(s, p, mode=mode) for s, p in zip(specs, pts)]
            if clobbers:
                for point in points:
                    point.meta["trace_override"] = (
                        "bandwidth_mbps axis replaced the piecewise base trace "
                        "with a constant trace"
                    )
            if summary is not None:
                for point in points:
                    summary.update(point)
            if keep_points:
                out_points.extend(points)
        meta["wall_s"] = time.perf_counter() - t0
        if chunk_size is not None:
            meta["chunks"] = n_chunks
            meta["chunk_size"] = chunk
        if summary is not None:
            meta["summary"] = summary.to_json()
        if not keep_points:
            meta["points_streamed"] = n_points
        if groups:  # the batched engine's shape groups: lanes, rounds, host reads, reruns
            meta["groups"] = [{**g, "key": list(g["key"]) if isinstance(g["key"], tuple) else g["key"]}
                              for g in groups]
        return SweepReport(
            base=self.spec,
            grid=grid,
            backend="batched" if use_batched else "reference",
            points=out_points,
            meta=meta,
        )

    def _batched_capability(
        self, entry, specs: Sequence[ScenarioSpec], mode: str = "auto"
    ) -> tuple[bool, str]:
        """Does the reference run this (policy, grid) on a batched engine?

        Single-stream grids need ``batched=True`` (``sim_batch``; the trace
        kind never gates routing).  Fleet grids need ``batched_multi=True``
        (every such policy has a fleet planner in ``sim_multi_batch``) and a
        fleet at every grid point (the engines do not mix fleet and
        single-stream lanes in one program); online sweeps need
        ``batched_online=True``."""
        if mode == "online":
            if entry.batched_online:
                return True, ""
            return False, f"policy {entry.name!r} has no batched online backend"
        fleet_pts = sum(1 for s in specs if s.fleet is not None)
        if fleet_pts == 0:
            if entry.batched:
                return True, ""
            return False, f"policy {entry.name!r} has no batched backend"
        if not entry.batched_multi:
            return False, f"policy {entry.name!r} has no batched fleet backend"
        if fleet_pts < len(specs):
            return False, (
                f"fleet backend for {entry.name!r} needs a fleet at every "
                "grid point (grid mixes fleet and single-stream points)"
            )
        return True, ""

    def _sweep_reference(
        self, spec: ScenarioSpec, pt: Mapping[str, Any], mode: str = "auto"
    ) -> SweepPoint:
        session = Session(spec, device=self.device)
        if mode == "online":
            rep = session.run("online")
        else:
            rep = session.run("multi" if spec.fleet is not None else "sim")
        return SweepPoint(overrides=dict(pt), streams=rep.streams, meta=dict(rep.meta))

    def _sweep_batched(
        self, specs: list[ScenarioSpec], pts: list[dict[str, Any]], groups: list[dict[str, Any]]
    ) -> list[SweepPoint]:
        base = self.spec
        scens = [
            sim_batch.BatchScenario(
                stream=s.stream,
                n_frames=s.n_frames,
                params=s.policy.params,
                rtt=s.trace.rtt_s,
                bw_segments=s.trace.segments(),
                workload=s.workload,
            )
            for s in specs
        ]
        stats = sim_batch.simulate_batch(
            base.policy.name, list(base.models), scens, strict=base.strict, device=self.device,
            groups=groups,
        )
        return [
            SweepPoint(overrides=dict(pt), streams=[st], meta={"policy": spec.policy.name})
            for spec, pt, st in zip(specs, pts, stats)
        ]

    def _sweep_batched_online(
        self, specs: list[ScenarioSpec], pts: list[dict[str, Any]], groups: list[dict[str, Any]]
    ) -> list[SweepPoint]:
        """An online grid through the lane-batched estimator loop; per-point
        meta is what ``run_online`` reports (round count, final believed
        bandwidth)."""
        base = self.spec
        scens = [
            sim_online_batch.OnlineScenario(
                stream=s.stream,
                n_frames=s.n_frames,
                params=s.policy.params,
                rtt=s.trace.rtt_s,
                bw_segments=s.trace.segments(),
            )
            for s in specs
        ]
        results = sim_online_batch.simulate_online_batch(
            base.policy.name, list(base.models), scens, strict=base.strict, device=self.device,
            groups=groups,
        )
        return [
            SweepPoint(overrides=dict(pt), streams=[st], meta={"policy": spec.policy.name, **lane_meta})
            for spec, pt, (st, lane_meta) in zip(specs, pts, results)
        ]

    def _sweep_batched_multi(
        self, specs: list[ScenarioSpec], pts: list[dict[str, Any]], groups: list[dict[str, Any]]
    ) -> list[SweepPoint]:
        """A fleet grid through the lane-batched fleet engine: every point's
        interacting fleet (shared uplink + server queue) runs on the device;
        per-point meta is what ``run_multi`` reports."""
        base = self.spec
        scens = [
            sim_multi_batch.FleetScenario(
                stream=s.stream,
                n_frames=s.n_frames,
                bw_segments=s.trace.segments(),
                rtt=s.trace.rtt_s,
                n_clients=s.fleet.n_clients,
                allocation=s.fleet.allocation,
                capacity=s.fleet.capacity,
                backlog_limit=s.fleet.backlog_limit,
                weights=s.fleet.weights,
                priorities=s.fleet.priorities,
                params=s.policy.params,
                workload=s.workload,
            )
            for s in specs
        ]
        results = sim_multi_batch.simulate_multi_batch(
            base.policy.name, list(base.models), scens, strict=base.strict, device=self.device,
            groups=groups,
        )
        return [
            SweepPoint(overrides=dict(pt), streams=ms.per_client,
                       meta={"policy": spec.policy.name, "allocation": spec.fleet.allocation,
                             "server_jobs": ms.server_jobs, "server_utilization": ms.server_utilization,
                             **sched_meta})
            for spec, pt, (ms, sched_meta) in zip(specs, pts, results)
        ]

    # -- mode: real models behind the controller ---------------------------
    def run_serving(self) -> RunReport:
        """Stand up the real-model serving stack (launch/serve) for this
        scenario: trains/quantizes the classifier pair on the device, profiles
        it live, and runs the controller over a synthetic labeled video."""
        if self.spec.workload.is_track:
            raise ValueError("mode 'serving' does not execute the tracking workload yet")
        from .launch.serve import run_scenario  # heavy deps; import lazily

        summary = run_scenario(self.spec, device=self.device)
        frames = int(summary.get("frames", 0))
        stats = StreamStats(
            frames_total=self.spec.n_frames,
            frames_processed=frames,
            frames_missed_deadline=int(round((1.0 - summary.get("deadline_met_frac", 1.0)) * frames)),
            frames_offloaded=int(summary.get("edge_frames", 0)),
            accuracy_sum=float(summary.get("accuracy", 0.0)) * frames,
            elapsed=self.spec.n_frames * self.spec.stream.gamma,
            schedule_calls=int(summary.get("scheduler_rounds", 0)),
        )
        return RunReport("serving", self.spec, [stats], meta=summary)


# ---------------------------------------------------------------------------
# CLI:  python -m repro_torch.session spec.json [--mode sim|multi|online|serving]
#       python -m repro_torch.session sweep spec.json --grid grid.json
# Malformed specs/grids (bad JSON, unknown policy, invalid parameters) and a
# missing card exit 2 with a one-line ``error: ...`` on stderr — never a
# traceback.
# ---------------------------------------------------------------------------

_EXAMPLE = ScenarioSpec(
    policy=PolicySpec("max_accuracy"),
    n_frames=90,
    trace=TraceSpec(mbps=2.5),
    label="example",
)

_EXAMPLE_GRID = SweepGrid(bandwidth_mbps=(1.0, 2.5), deadline_ms=(150.0, 200.0, 250.0))


def _read(path: str) -> str:
    return sys.stdin.read() if path == "-" else open(path).read()


def _fail(exc: Exception) -> int:
    print(f"error: {exc}", file=sys.stderr)
    return 2


def _join_ranks(device: str) -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1), join the process group its
    environment describes, and say whether this process did.  Device
    collectives run on NCCL where each rank on a host has its own card, else
    on gloo (NCCL refuses two ranks on one card); the sweep's host gathers
    take a gloo group either way (``launch.mesh.host_group``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return False
    on_card = device.split(":")[0] == "cuda" and torch.cuda.is_available()
    own_card = on_card and int(os.environ.get("LOCAL_WORLD_SIZE", world)) <= torch.cuda.device_count()
    dist.init_process_group("nccl" if own_card else "gloo")
    if on_card:
        torch.cuda.set_device(resolve_device("cuda"))
    return True


def _sweep_main(argv: Sequence[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.session sweep",
        description="Run one ScenarioSpec across a SweepGrid; print a SweepReport JSON.",
    )
    ap.add_argument("spec", nargs="?", help="path to ScenarioSpec JSON, or '-' for stdin")
    ap.add_argument("--grid", help="path to SweepGrid JSON (see --example-grid)")
    ap.add_argument("--backend", default="auto", choices=Session.BACKENDS)
    ap.add_argument("--mode", default="auto", choices=Session.SWEEP_MODES,
                    help="'online' sweeps the estimated-bandwidth controller "
                    "loop (run_online) instead of the oracle simulator")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", help="write the SweepReport JSON here; print a summary instead")
    ap.add_argument("--chunk-size", type=int, default=None, metavar="N",
                    help="stream the grid in chunks of N points (equal to "
                    "unchunked; adds an incremental summary to meta)")
    ap.add_argument("--summary-only", action="store_true",
                    help="drop per-point stats, keep only the streaming summary")
    ap.add_argument("--compile-cache", metavar="DIR",
                    help="the reference's persistent compile cache directory; "
                    "the port keeps its captured programs in the process and "
                    "writes nothing there (recorded in meta)")
    ap.add_argument("--example-grid", action="store_true",
                    help="print an example grid JSON and exit")
    args = ap.parse_args(argv)

    if args.example_grid:
        print(json.dumps(_EXAMPLE_GRID.to_json(), indent=2))
        return 0
    if not args.spec or not args.grid:
        ap.error("need a spec path and --grid (or --example-grid)")
    joined = _join_ranks(args.device)
    code = _sweep_run(args)
    if joined:
        # Every rank leaves together, and now: gloo's teardown during
        # interpreter exit aborts a rank now and then ("terminate called
        # without an active exception").
        dist.barrier()
        dist.destroy_process_group()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code


def _sweep_run(args: argparse.Namespace) -> int:
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:  # no card, or an unknown device
        return _fail(exc)
    try:
        spec = ScenarioSpec.from_json(_read(args.spec))
        grid = SweepGrid.from_json(_read(args.grid))
        report = Session(spec, device=device).run_sweep(
            grid,
            backend=args.backend,
            mode=args.mode,
            chunk_size=args.chunk_size,
            keep_points=not args.summary_only,
            compile_cache=args.compile_cache,
        )
        if dist.is_initialized() and dist.get_rank() != 0:
            return 0  # every rank holds the whole report; rank 0 writes it
        payload = json.dumps(report.to_json(), indent=2)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(payload + "\n")
    except (OSError, TypeError, ValueError) as exc:
        return _fail(exc)
    if args.out:
        print(
            f"{len(report)} points via {report.backend} backend in "
            f"{report.meta.get('wall_s', 0.0):.2f}s -> {args.out}"
        )
    else:
        print(payload)
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["sweep"]:
        return _sweep_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.session",
        description="Run a declarative FastVA scenario (ScenarioSpec JSON). "
        "Use the 'sweep' subcommand to run a whole scenario grid.",
    )
    ap.add_argument("spec", nargs="?", help="path to ScenarioSpec JSON, or '-' for stdin")
    ap.add_argument("--mode", default="sim", choices=Session.MODES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--list-policies", action="store_true", help="list registered policies and exit")
    ap.add_argument("--example", action="store_true", help="print an example spec JSON and exit")
    args = ap.parse_args(argv)

    if args.list_policies:
        for name in available_policies():
            print(name)
        return 0
    if args.example:
        print(json.dumps(_EXAMPLE.to_json(), indent=2))
        return 0
    if not args.spec:
        ap.error("need a spec path (or --list-policies / --example)")
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:  # no card, or an unknown device
        return _fail(exc)
    try:
        spec = ScenarioSpec.from_json(_read(args.spec))
        report = Session(spec, device=device).run(args.mode)
    except (OSError, TypeError, ValueError) as exc:
        return _fail(exc)
    print(json.dumps(report.to_json(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
