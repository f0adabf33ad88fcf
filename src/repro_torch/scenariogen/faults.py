"""Fault injection: mid-round edge-server failures as first-class scenarios.

The FastVA tie-in (see :mod:`repro_torch.runtime.fault_tolerance`): the serving
tier treats an edge-pool failure like the paper treats a network outage.  Two
renderings of the same event, composable:

  * **Network view** — :func:`edge_failure` drives the *dormant*
    :class:`~repro_torch.runtime.fault_tolerance.HeartbeatMonitor` with an injected
    clock over a deterministic heartbeat schedule, reads off when the monitor
    actually declares the pool DEAD (detection lags the crash by the dead
    grace window) and when the first post-recovery heartbeat lands, then
    splices that *detected* outage window into a bandwidth trace via
    :func:`degrade`.  The result is a plain TraceSpec: every engine replays
    the outage with no fault-specific code paths.
  * **Profile view** — :func:`dead_edge_models` degrades the model table
    instead (``t_server -> inf``), for scenarios where the edge pool is gone
    for the whole run and the schedulers must route everything to the NPU.

A degraded window defaults to a *small positive* bandwidth rather than zero:
the online engines model the uplink as serially occupied (``net_free = start
+ t_up``), so a genuinely 0-bandwidth upload pins the link busy forever —
faithful to ``run_online``, but it makes "recovery" meaningless.  Pass
``to_mbps=0.0`` only when that is the story you want to tell.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from ..core.profiles import ModelProfile
from ..runtime.fault_tolerance import HeartbeatMonitor, WorkerState
from ..session import TraceSpec

__all__ = ["OutageReport", "edge_failure", "degrade", "dead_edge_models"]


@dataclasses.dataclass(frozen=True)
class OutageReport:
    """An injected edge failure, as the monitor saw it.

    ``detected_at_s``/``recovered_at_s`` bound the *detected* outage (what
    :func:`degrade` splices into the trace); ``fail_at_s`` is when the pool
    actually crashed — the gap is the monitor's detection lag.  ``events``
    logs every state change the sweeps observed, in order.
    """

    trace: TraceSpec
    fail_at_s: float
    detected_at_s: float
    recovered_at_s: float
    events: tuple[tuple[float, str], ...]


def _value_at(points: Sequence[tuple[float, float]], t: float) -> float:
    """Piecewise-constant lookup matching ``Trace.at``: last point with
    t_start <= t wins; the first value extends backward."""
    v = points[0][1]
    for ts, val in points:
        if ts <= t:
            v = val
        else:
            break
    return v


def degrade(
    trace: TraceSpec,
    windows: Iterable[tuple[float, float]],
    *,
    to_mbps: float = 0.05,
) -> TraceSpec:
    """Splice outage windows into ``trace``: bandwidth is ``to_mbps`` during
    each ``[start, end)`` window and the base trace's own value resumes at
    ``end``.  Windows must be non-overlapping (shared endpoints are fine)."""
    if float(to_mbps) < 0.0:
        raise ValueError(f"to_mbps must be >= 0, got {to_mbps!r}")
    wins = sorted((float(a), float(b)) for a, b in windows)
    for a, b in wins:
        if not a < b:
            raise ValueError(f"degradation window must have start < end, got ({a!r}, {b!r})")
    for (_, b0), (a1, _) in zip(wins, wins[1:]):
        if a1 < b0:
            raise ValueError(
                f"degradation windows overlap: one ends at {b0!r}, next starts at {a1!r}"
            )
    base = (
        list(trace.points)
        if trace.kind == "piecewise"
        else [(0.0, float(trace.mbps))]
    )
    merged: dict[float, float] = {
        ts: v for ts, v in base if not any(a <= ts < b for a, b in wins)
    }
    for a, b in wins:
        merged[max(a, 0.0)] = float(to_mbps)
        merged[b] = _value_at(base, b)
    pts = tuple(sorted(merged.items()))
    return TraceSpec(kind="piecewise", points=pts, rtt_ms=trace.rtt_ms)


def edge_failure(
    *,
    fail_at_s: float = 4.0,
    recover_at_s: float = 8.0,
    duration_s: float = 16.0,
    base_mbps: float = 3.5,
    degraded_mbps: float = 0.05,
    rtt_ms: float = 100.0,
    interval_s: float = 0.25,
    suspect_after: float = 2.0,
    dead_after: float = 4.0,
) -> OutageReport:
    """Simulate an edge pool crashing mid-run and derive the outage trace.

    The pool heartbeats every ``interval_s`` until it crashes at
    ``fail_at_s`` and resumes at ``recover_at_s``; a deterministic injected
    clock drives :class:`HeartbeatMonitor` through the whole schedule.  The
    degraded window of the returned trace is the *detected* outage — it
    opens when the monitor declares the pool DEAD (``dead_after`` intervals
    of silence), not when the crash happened, exactly the lag a deployed
    controller would experience.
    """
    fail = float(fail_at_s)
    recover = float(recover_at_s)
    duration = float(duration_s)
    if not 0.0 <= fail < recover:
        raise ValueError(
            f"need 0 <= fail_at_s < recover_at_s, got ({fail!r}, {recover!r})"
        )
    if recover >= duration:
        raise ValueError(
            f"recover_at_s ({recover!r}) must precede duration_s ({duration!r})"
        )
    now = 0.0
    monitor = HeartbeatMonitor(
        interval_s=float(interval_s),
        suspect_after=float(suspect_after),
        dead_after=float(dead_after),
        clock=lambda: now,
    )
    monitor.register("edge-pool")
    events: list[tuple[float, str]] = []
    detected: float | None = None
    recovered: float | None = None
    k = 0
    while k * float(interval_s) <= duration:
        now = k * float(interval_s)
        alive = now < fail or now >= recover
        if alive:
            was_dead = monitor.workers["edge-pool"].state is WorkerState.DEAD
            monitor.beat("edge-pool")
            if was_dead:  # beat() is the one legitimate resurrection path
                events.append((now, "healthy"))
                if recovered is None:
                    recovered = now
        for _, state in monitor.sweep().items():
            events.append((now, state.value))
            if state is WorkerState.DEAD and detected is None:
                detected = now
        k += 1
    if detected is None or recovered is None:
        raise ValueError(
            "outage too short for the monitor to detect: widen "
            "fail_at_s..recover_at_s or lower dead_after/interval_s"
        )
    trace = degrade(
        TraceSpec(kind="constant", mbps=float(base_mbps), rtt_ms=float(rtt_ms)),
        [(detected, recovered)],
        to_mbps=float(degraded_mbps),
    )
    return OutageReport(
        trace=trace,
        fail_at_s=fail,
        detected_at_s=detected,
        recovered_at_s=recovered,
        events=tuple(events),
    )


def dead_edge_models(models: Sequence[ModelProfile]) -> tuple[ModelProfile, ...]:
    """The profile view of a dead edge pool: every model's ``t_server -> inf``
    (``runs_server`` becomes False), so the schedulers can only use the NPU
    path — the degradation :mod:`repro_torch.runtime.fault_tolerance` describes."""
    return tuple(
        dataclasses.replace(m, t_server=float("inf")) for m in models
    )
