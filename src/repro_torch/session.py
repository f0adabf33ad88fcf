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

Policies that plan with tensor ops (``jax_accuracy``, ``jax_utility``) run
on the Session's device.  The sweep engine is not ported yet: ``run_sweep``
raises ``NotImplementedError`` naming the ROADMAP.md item that ports it.

    from repro_torch.core.registry import PolicySpec
    from repro_torch.session import ScenarioSpec, Session

    spec = ScenarioSpec(policy=PolicySpec("max_accuracy"), n_frames=120)
    report = Session(spec).run_sim()          # device="cuda" by default
    print(report.stats.mean_accuracy)

or from the shell::

    PYTHONPATH=src python -m repro_torch.session scenario.json --mode sim --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import torch

from .core.audit import AUDIT_TOL, apply_round, audit_round
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
    "TraceSpec",
    "WorkloadSpec",
]

_PRESET_MODELS: dict[str, ModelProfile] = {m.name: m for m in PAPER_MODELS}


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

    ``models`` entries may be preset names (``"resnet-50"``/``"squeezenet"``)
    or full :class:`ModelProfile` objects; they normalize to profiles.
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
# Session facade
# ---------------------------------------------------------------------------

_SWEEP_NOT_PORTED = (
    "Session.run_sweep is not ported to repro_torch yet; see ROADMAP.md, "
    "'Modules to port', item 5 (the float64 jax_sched DPs, bucketing, sim_batch, run_sweep)"
)


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

    def run_sweep(self, *args, **kwargs):
        raise NotImplementedError(_SWEEP_NOT_PORTED)

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
# Malformed specs (bad JSON, unknown policy, invalid parameters) exit 2 with
# a one-line ``error: ...`` on stderr — never a traceback.
# ---------------------------------------------------------------------------

_EXAMPLE = ScenarioSpec(
    policy=PolicySpec("max_accuracy"),
    n_frames=90,
    trace=TraceSpec(mbps=2.5),
    label="example",
)


def _read(path: str) -> str:
    return sys.stdin.read() if path == "-" else open(path).read()


def _fail(exc: Exception) -> int:
    print(f"error: {exc}", file=sys.stderr)
    return 2


def main(argv: Sequence[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["sweep"]:
        return _fail(NotImplementedError(_SWEEP_NOT_PORTED))
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.session",
        description="Run a declarative FastVA scenario (ScenarioSpec JSON).",
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
