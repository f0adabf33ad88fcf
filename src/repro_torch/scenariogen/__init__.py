"""Scenario generators: adversarial network + fault conditions, front-door ready.

The library closes the loop between the paper's evaluation narrative ("what
happens when the user walks out of coverage / the edge pool dies mid-run?")
and the engines: every generator lowers to the same declarative
:class:`~repro_torch.session.TraceSpec` / :class:`~repro_torch.session.ScenarioSpec`
objects the engines already consume, so one generated scenario runs unchanged
through ``run_sim``, ``run_online`` and ``run_multi`` — and, as JSON, through
the reference package's engines.

Catalog:

    >>> from repro_torch import scenariogen
    >>> scenariogen.trace_kinds()
    ('diurnal', 'edge_failure', 'flash_crowd', 'mobility_ramp', 'mobility_square')
    >>> spec = scenariogen.make_scenario(
    ...     "mobility_square", policy="max_accuracy", period_s=2.0)
    >>> Session(spec, device="cpu").run_online()   # doctest: +SKIP

``make_trace(kind, **params)`` returns just the TraceSpec; ``make_scenario``
wraps it into a full ScenarioSpec.  The fault generator's richer report
(detection lag, monitor event log) is available via
:func:`scenariogen.faults.edge_failure` directly.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

from ..session import ScenarioSpec, TraceSpec
from . import faults, traces
from .faults import OutageReport, dead_edge_models, degrade, edge_failure

__all__ = [
    "OutageReport",
    "TRACE_KINDS",
    "dead_edge_models",
    "degrade",
    "edge_failure",
    "make_scenario",
    "make_trace",
    "trace_kinds",
]

#: kind name -> generator; every entry returns a plain TraceSpec.
TRACE_KINDS: Mapping[str, Callable[..., TraceSpec]] = {
    "mobility_square": traces.mobility_square,
    "mobility_ramp": traces.mobility_ramp,
    "diurnal": traces.diurnal,
    "flash_crowd": traces.flash_crowd,
    "edge_failure": lambda **params: faults.edge_failure(**params).trace,
}


def trace_kinds() -> tuple[str, ...]:
    """Registered generator kinds, sorted (the catalog's table of contents)."""
    return tuple(sorted(TRACE_KINDS))


def make_trace(kind: str, **params: Any) -> TraceSpec:
    """Build the ``kind`` generator's TraceSpec; unknown kinds raise."""
    try:
        gen = TRACE_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown scenario kind {kind!r}; registered: {trace_kinds()}"
        ) from None
    return gen(**params)


def make_scenario(
    kind: str,
    *,
    policy: Any,
    n_frames: int = 120,
    fps: float = 30.0,
    deadline_ms: float = 200.0,
    resolutions: tuple[int, ...] = (224, 320, 448),
    models: tuple = ("resnet-50", "squeezenet"),
    strict: bool = True,
    label: str = "",
    **trace_params: Any,
) -> ScenarioSpec:
    """One front-door scenario around :func:`make_trace`.

    ``policy`` is anything :class:`ScenarioSpec` accepts (a PolicySpec, a
    name, or a ``{"name": ..., "params": ...}`` payload); remaining keyword
    arguments go to the trace generator.  The result is an ordinary spec —
    JSON round-trippable, runnable on every engine.
    """
    from ..core.profiles import StreamSpec  # local: keep import surface small

    return ScenarioSpec(
        policy=policy,
        n_frames=n_frames,
        stream=StreamSpec(
            fps=float(fps),
            deadline=float(deadline_ms) / 1e3,
            resolutions=tuple(int(r) for r in resolutions),
        ),
        models=models,
        trace=make_trace(kind, **trace_params),
        strict=strict,
        label=label or kind,
    )
