"""Trace generators: the adversarial network conditions FastVA must survive.

Every generator returns a plain :class:`repro_torch.session.TraceSpec` — the
same declarative, JSON-round-trippable object every engine already consumes —
so a generated scenario runs through the front door (``run_sim`` /
``run_online`` / ``run_multi``) with zero special-casing.  Generators are pure
functions of their parameters (``flash_crowd`` takes an explicit ``seed``), so
a scenario catalog entry pins its trace bit-for-bit.

The shapes:

  mobility_square  walking in/out of coverage: bandwidth toggles between a
                   high and a low level with a fixed period and duty cycle —
                   the canonical estimator-convergence stressor.
  mobility_ramp    drive-through handoff: staircase up to peak, hold (with a
                   short mid-hold handoff dip), staircase back down.
  diurnal          slow load curve: cosine staircase around a base level,
                   amplitude-bounded so bandwidth never goes negative.
  flash_crowd      seeded bursts of contention: n non-overlapping events
                   during which available bandwidth collapses to crowd_mbps.
"""
from __future__ import annotations

import math

import numpy as np

from ..session import TraceSpec

__all__ = ["mobility_square", "mobility_ramp", "diurnal", "flash_crowd"]


def _positive(name: str, v: float) -> float:
    v = float(v)
    if not v > 0.0:
        raise ValueError(f"{name} must be > 0, got {v!r}")
    return v


def _bandwidth(name: str, v: float) -> float:
    v = float(v)
    if v < 0.0:
        raise ValueError(f"{name} must be >= 0 Mbps, got {v!r}")
    return v


def mobility_square(
    *,
    high_mbps: float = 3.5,
    low_mbps: float = 0.8,
    period_s: float = 2.0,
    duty: float = 0.5,
    duration_s: float = 16.0,
    rtt_ms: float = 100.0,
) -> TraceSpec:
    """Square wave: ``duty`` of each period at ``high_mbps``, the rest low.

    Starts high at t=0 (the paper's mobile begins in good coverage); the
    trace holds its last level past ``duration_s``, matching ``Trace.at``.
    """
    high = _bandwidth("high_mbps", high_mbps)
    low = _bandwidth("low_mbps", low_mbps)
    period = _positive("period_s", period_s)
    duration = _positive("duration_s", duration_s)
    duty = float(duty)
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty!r}")
    points: list[tuple[float, float]] = []
    k = 0
    while k * period < duration:
        points.append((k * period, high))
        fall = k * period + duty * period
        if fall < duration:
            points.append((fall, low))
        k += 1
    return TraceSpec(kind="piecewise", points=tuple(points), rtt_ms=float(rtt_ms))


def mobility_ramp(
    *,
    low_mbps: float = 0.8,
    high_mbps: float = 4.0,
    ramp_s: float = 4.0,
    hold_s: float = 4.0,
    steps: int = 4,
    dip_mbps: float = 0.2,
    dip_s: float = 0.5,
    rtt_ms: float = 100.0,
) -> TraceSpec:
    """Staircase up, hold at peak with a mid-hold handoff dip, staircase down.

    The dip models a cell handoff at the coverage peak: ``dip_s`` seconds at
    ``dip_mbps``, centered in the hold window (it must fit inside it).  Total
    duration is ``2 * ramp_s + hold_s``.
    """
    low = _bandwidth("low_mbps", low_mbps)
    high = _bandwidth("high_mbps", high_mbps)
    dip = _bandwidth("dip_mbps", dip_mbps)
    ramp = _positive("ramp_s", ramp_s)
    hold = _positive("hold_s", hold_s)
    dip_len = _positive("dip_s", dip_s)
    steps = int(steps)
    if steps < 2:
        raise ValueError(f"steps must be >= 2, got {steps!r}")
    if dip_len >= hold:
        raise ValueError(
            f"handoff dip ({dip_len!r}s) must fit inside the hold window ({hold!r}s)"
        )
    levels = [low + (high - low) * i / (steps - 1) for i in range(steps)]
    points: list[tuple[float, float]] = []
    for i, v in enumerate(levels[:-1]):  # up-ramp; the peak opens the hold
        points.append((i * ramp / (steps - 1), v))
    dip_at = ramp + (hold - dip_len) / 2.0
    points.append((ramp, high))
    points.append((dip_at, dip))
    points.append((dip_at + dip_len, high))
    for i, v in enumerate(reversed(levels[:-1])):  # down-ramp back to low
        points.append((ramp + hold + i * ramp / (steps - 1), v))
    return TraceSpec(kind="piecewise", points=tuple(points), rtt_ms=float(rtt_ms))


def diurnal(
    *,
    base_mbps: float = 2.5,
    amplitude_mbps: float = 1.5,
    period_s: float = 24.0,
    steps: int = 12,
    duration_s: float | None = None,
    rtt_ms: float = 100.0,
) -> TraceSpec:
    """Cosine staircase: bandwidth peaks at t=0 and bottoms out mid-period
    (the network is loaded when everyone is awake).  ``steps`` levels per
    period; amplitude must not exceed the base so bandwidth stays >= 0."""
    base = _bandwidth("base_mbps", base_mbps)
    amp = float(amplitude_mbps)
    if not 0.0 <= amp <= base:
        raise ValueError(
            f"amplitude_mbps must be in [0, base_mbps={base!r}], got {amp!r}"
        )
    period = _positive("period_s", period_s)
    steps = int(steps)
    if steps < 2:
        raise ValueError(f"steps must be >= 2, got {steps!r}")
    duration = period if duration_s is None else _positive("duration_s", duration_s)
    dt = period / steps
    points: list[tuple[float, float]] = []
    k = 0
    while k * dt < duration:
        t = k * dt
        points.append((t, base + amp * math.cos(2.0 * math.pi * t / period)))
        k += 1
    return TraceSpec(kind="piecewise", points=tuple(points), rtt_ms=float(rtt_ms))


def flash_crowd(
    *,
    base_mbps: float = 3.5,
    crowd_mbps: float = 0.5,
    n_events: int = 3,
    event_s: float = 1.0,
    duration_s: float = 16.0,
    seed: int = 0,
    rtt_ms: float = 100.0,
) -> TraceSpec:
    """Seeded bursts of contention: ``n_events`` non-overlapping windows of
    ``event_s`` seconds at ``crowd_mbps``, arrival times drawn uniformly over
    the trace (``numpy.random.default_rng(seed)`` — same seed, same trace).
    Events that no longer fit after de-overlapping are dropped, never
    truncated, so every emitted event has its full duration."""
    base = _bandwidth("base_mbps", base_mbps)
    crowd = _bandwidth("crowd_mbps", crowd_mbps)
    event = _positive("event_s", event_s)
    duration = _positive("duration_s", duration_s)
    n_events = int(n_events)
    if n_events < 1:
        raise ValueError(f"n_events must be >= 1, got {n_events!r}")
    if event >= duration:
        raise ValueError(
            f"event_s ({event!r}) must be shorter than duration_s ({duration!r})"
        )
    rng = np.random.default_rng(int(seed))
    raw = sorted(float(t) for t in rng.uniform(0.0, duration - event, size=n_events))
    gap = 1e-3  # keeps restore/collapse points strictly increasing
    starts: list[float] = []
    prev_end = -math.inf
    for s in raw:
        s = max(s, prev_end + gap)
        if s + event > duration:
            break
        starts.append(s)
        prev_end = s + event
    points: dict[float, float] = {0.0: base}
    for s in starts:
        points[s] = crowd
        points[s + event] = base
    pts = tuple(sorted(points.items()))
    return TraceSpec(kind="piecewise", points=pts, rtt_ms=float(rtt_ms))
