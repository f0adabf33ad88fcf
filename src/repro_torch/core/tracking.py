"""Detect+track workload class: temporally coupled frames (FastMOT-style).

The classification workload treats every frame independently; real edge
video pipelines do not.  The dominant pattern (FastMOT; "Distributed
Edge-based Video Analytics on the Move") runs a *cheap local tracker on
every frame* and a *heavy detector every k frames*: tracked frames inherit
the last detection's accuracy, decayed by staleness and crowd density.
This module makes that workload a first-class citizen of the scheduler:

  retention        r = (1 - decay) ** density          (per-frame survival)
  tracked frame f  accuracy = det_acc * r ** (f - det_frame)

so the per-round decision space gains a *detector interval* axis ``k``
alongside the paper's offload/NPU placement: a detection placed on the NPU
occupies it for ``T_j^npu`` (forcing k >= ceil(T_j^npu / gamma)); a
detection offloaded at resolution ``rho`` occupies the uplink for
``t_up`` (forcing k >= floor(t_up / gamma) + 1); every frame inside the
interval is carried by the tracker and scores the decayed accuracy.

Execution semantics (the audit contract's tracking extension) live in
:mod:`repro_torch.core.audit` (``TrackState`` / ``apply_track_round``);
this module owns the workload description (:class:`WorkloadSpec`), the
decay tables (:func:`retention_powers` / :func:`interval_means` — host
Python arithmetic, so every engine multiplies the *same* float64
constants), the registered planners (``track_accuracy``, ``track_fixed``),
and the exhaustive oracle (:func:`exhaustive_track_best`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

from .profiles import ModelProfile, NetworkState, StreamSpec, best_server_model
from .registry import Param, register_policy
from .schedule import Decision, RoundPlan, Where

__all__ = [
    "WORKLOAD_KINDS",
    "WorkloadSpec",
    "exhaustive_track_best",
    "interval_means",
    "npu_interval",
    "retention",
    "retention_powers",
    "upload_interval",
]

WORKLOAD_KINDS = ("classify", "track")

# Default decay curve: calibrated to FastMOT's FPS-vs-#targets table shape —
# a moderate scene loses ~15% of its tracked accuracy per frame of staleness.
DEFAULT_DECAY = 0.15
DEFAULT_DENSITY = 1.0
DEFAULT_K_MAX = 8


def retention(decay: float, density: float) -> float:
    """Per-frame accuracy retention ``(1 - decay) ** density``.

    ``decay`` is the per-frame fractional loss for a unit-density scene;
    ``density`` scales it for crowd size (FastMOT: more targets decay
    faster).  Host Python arithmetic — every backend consumes this value.
    """
    return (1.0 - float(decay)) ** float(density)


def retention_powers(ret: float, n: int) -> list[float]:
    """``[ret ** age for age in 0..n-1]`` — the tracked-frame scoring table.

    Computed with Python ``**`` on the host, so a table lookup scores the
    same float as the loop's direct ``ret ** age``.
    """
    return [ret**age for age in range(max(n, 1))]


def interval_means(ret: float, k_max: int) -> list[float]:
    """``out[k-1]`` = mean retention over a k-frame detector interval.

    A detection refreshed every ``k`` frames yields per-frame accuracy
    ``det_acc * (1 + ret + ... + ret^(k-1)) / k``; planners score a
    candidate (placement, k) as ``det_acc * out[k-1]``.  Monotone
    non-increasing in ``k`` (each new term is <= the running mean), which
    is why the minimum feasible interval is optimal per placement.
    """
    out: list[float] = []
    s = 0.0
    for k in range(1, max(k_max, 1) + 1):
        s += ret ** (k - 1)
        out.append(s / k)
    return out


def npu_interval(t_npu: float, gamma: float) -> int:
    """Minimum detector interval for an NPU detection: the NPU is busy for
    ``t_npu``, so the next detection cannot be planned before it frees."""
    return max(int(math.ceil(t_npu / gamma)), 1)


def upload_interval(t_up: float, gamma: float) -> int:
    """Minimum detector interval for an offloaded detection: the paper's
    ``n_l = floor(t_up / gamma)`` frames arrive while the link is busy,
    plus the head frame itself."""
    return int(math.floor(t_up / gamma)) + 1


@dataclass(frozen=True)
class WorkloadSpec:
    """What the stream's frames *are* — the world truth the executor scores.

    ``kind="classify"`` (default) is the paper's independent-frame
    workload; ``kind="track"`` makes frames temporally coupled with the
    decay model above.  Planner parameters (``decay``/``density`` on
    ``track_accuracy``) are the planner's *belief* and default to the same
    values, mirroring how ``run_online`` separates estimator from truth;
    the executor always scores with this spec.
    """

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

    @property
    def retention(self) -> float:
        return retention(self.decay, self.density)

    # -- serialization -----------------------------------------------------
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


# ---------------------------------------------------------------------------
# Candidate enumeration shared by both planners and the oracle.
# ---------------------------------------------------------------------------


def _npu_candidates(
    models: Sequence[ModelProfile], stream: StreamSpec
) -> list[tuple[int, float, float]]:
    """``(j, t_npu, accuracy)`` for every locally runnable model, j ascending."""
    return [
        (j, m.t_npu, m.accuracy(stream.r_max, where="npu"))
        for j, m in enumerate(models)
        if m.runs_local
    ]


def _server_candidates(
    models: Sequence[ModelProfile], stream: StreamSpec, net: NetworkState
) -> list[tuple[int, int, float, float, float]]:
    """``(r, j, t_up, t_server, accuracy)`` per feasible resolution, r ascending.

    Feasible means the upload + RTT leave a positive server budget and some
    server model fits it (paper §IV.B.1 candidate structure).
    """
    out: list[tuple[int, int, float, float, float]] = []
    T = stream.deadline
    for r in stream.resolutions:
        t_up = net.upload_time(stream.frame_bytes(r))
        budget = T - t_up - net.rtt
        if budget <= 0:
            continue
        found = best_server_model(models, r, budget)
        if found is None:
            continue
        j, acc = found
        out.append((r, j, t_up, models[j].t_server, acc))
    return out


def _skip_plan(npu_free: float, horizon: int = 1) -> RoundPlan:
    return RoundPlan(
        decisions=[Decision(0, Where.SKIP)], horizon=horizon, npu_busy_until=npu_free
    )


def _detect_plan(
    kind: Where,
    *,
    j: int,
    k: int,
    acc: float,
    score: float,
    npu_free: float,
    start: float,
    finish: float,
    resolution: int = -1,
) -> RoundPlan:
    busy = finish if kind is Where.NPU else npu_free
    return RoundPlan(
        decisions=[
            Decision(0, kind, j, resolution, start=start, finish=finish)
        ],
        horizon=k,
        expected_accuracy_sum=score * k,
        npu_busy_until=busy,
    )


_TRACK_PARAMS = (
    Param.number(
        "decay",
        DEFAULT_DECAY,
        lo=0.0,
        hi=1.0,
        doc="believed per-frame fractional accuracy loss of tracked frames",
    ),
    Param.number(
        "density",
        DEFAULT_DENSITY,
        lo=0.0,
        doc="believed target density scaling the decay (FastMOT FPS-vs-#targets)",
    ),
    Param.integer(
        "k_max",
        DEFAULT_K_MAX,
        lo=1,
        doc="largest detector interval the planner may choose",
    ),
)


@register_policy(
    "track_accuracy",
    params=_TRACK_PARAMS,
    doc=(
        "Detect+track DP: jointly picks the detector interval k and the "
        "detection placement (NPU model / offload resolution+model) that "
        "maximize mean decayed accuracy per frame under the deadline."
    ),
    batched=True,
    batched_multi=True,
    workloads=("track",),
)
def plan_track_accuracy(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    npu_free: float = 0.0,
    decay: float = DEFAULT_DECAY,
    density: float = DEFAULT_DENSITY,
    k_max: int = DEFAULT_K_MAX,
) -> RoundPlan:
    """One round: choose the detection whose interval-mean accuracy is best.

    For each placement the minimum feasible interval is optimal (the
    interval mean is non-increasing in k, see :func:`interval_means`), so
    the joint (placement, k) search reduces to scoring each placement at
    its own minimum k.  Candidate order is NPU models ascending then
    offload resolutions ascending; strict ``>`` keeps the first maximum.
    """
    T = stream.deadline
    gamma = stream.gamma
    ret = retention(decay, density)
    im = interval_means(ret, k_max)
    free = max(npu_free, 0.0)
    best_score = -1.0
    best: RoundPlan | None = None

    for j, t_npu, acc in _npu_candidates(models, stream):
        finish = free + t_npu
        if finish > T:
            continue
        k = npu_interval(t_npu, gamma)
        if k > k_max:
            continue
        score = acc * im[k - 1]
        if score > best_score:
            best_score = score
            best = _detect_plan(
                Where.NPU, j=j, k=k, acc=acc, score=score,
                npu_free=free, start=free, finish=finish,
            )

    for r, j, t_up, t_server, acc in _server_candidates(models, stream, net):
        k = upload_interval(t_up, gamma)
        if k > k_max:
            continue
        score = acc * im[k - 1]
        if score > best_score:
            best_score = score
            best = _detect_plan(
                Where.SERVER, j=j, k=k, acc=acc, score=score,
                npu_free=free, start=0.0, finish=t_up + net.rtt + t_server,
                resolution=r,
            )

    return best if best is not None else _skip_plan(free)


@register_policy(
    "track_fixed",
    params=(
        Param.integer(
            "k",
            lo=1,
            doc="fixed detector interval: one detection attempt every k frames",
        ),
    ),
    doc=(
        "Fixed-interval detect+track baseline: every k frames, run the "
        "highest-accuracy detection that fits inside the interval and the "
        "deadline; the tracker carries the other frames."
    ),
    batched=True,
    batched_multi=True,
    workloads=("track",),
)
def plan_track_fixed(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    npu_free: float = 0.0,
    k: int = 1,
) -> RoundPlan:
    """One round of the classical fixed-k tracker: the interval is given,
    only the detection placement is chosen (highest fresh accuracy that
    fits; NPU models then offload resolutions, strict ``>`` first-wins).
    The round always consumes ``k`` frames — even when no detection fits,
    the tracker coasts on the stale state for the whole interval.
    """
    T = stream.deadline
    gamma = stream.gamma
    free = max(npu_free, 0.0)
    best_acc = -1.0
    best: RoundPlan | None = None

    for j, t_npu, acc in _npu_candidates(models, stream):
        finish = free + t_npu
        if finish > T or npu_interval(t_npu, gamma) > k:
            continue
        if acc > best_acc:
            best_acc = acc
            best = _detect_plan(
                Where.NPU, j=j, k=k, acc=acc, score=acc,
                npu_free=free, start=free, finish=finish,
            )

    for r, j, t_up, t_server, acc in _server_candidates(models, stream, net):
        if upload_interval(t_up, gamma) > k:
            continue
        if acc > best_acc:
            best_acc = acc
            best = _detect_plan(
                Where.SERVER, j=j, k=k, acc=acc, score=acc,
                npu_free=free, start=0.0, finish=t_up + net.rtt + t_server,
                resolution=r,
            )

    return best if best is not None else _skip_plan(free, horizon=k)


# ---------------------------------------------------------------------------
# Exhaustive oracle (bound test) — enumerates every executor-accepted action.
# ---------------------------------------------------------------------------


def exhaustive_track_best(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    n_frames: int,
    *,
    retention: float,
    k_max: int = DEFAULT_K_MAX,
) -> float:
    """Optimal accuracy sum over ALL detect+track executions (constant net).

    Plain recursion over ``(head, npu_free, det_acc, det_frame)``: at each
    round boundary the executor accepts SKIP (horizon 1), an NPU detection
    with any interval ``k in 1..k_max`` (the NPU occupancy carries into the
    next round when ``k`` undercuts ``ceil(t_npu / gamma)``), or an
    offloaded detection with any ``k in 1..k_max``.  This is a superset of
    what the registered planners emit, so it upper-bounds every tracking
    heuristic.
    """
    gamma = stream.gamma
    T = stream.deadline
    ret = retention
    npu_cands = _npu_candidates(models, stream)
    # For offloads, every interval choice leaves the same carry state, so
    # only the highest-accuracy feasible (resolution, model) pair matters.
    srv_accs = [acc for (_, _, _, _, acc) in _server_candidates(models, stream, net)]
    best_srv = max(srv_accs) if srv_accs else None
    memo: dict[tuple, float] = {}

    def tracked_sum(acc: float, head: int, lo: int, k: int) -> float:
        # ages lo..k-1 relative to a detection at `head`, clipped to stream end
        return sum(
            acc * ret**i for i in range(lo, k) if head + i < n_frames
        )

    def rec(head: int, npu_free: float, det_acc: float, det_frame: int) -> float:
        if head >= n_frames:
            return 0.0
        key = (head, round(npu_free, 9), det_acc, det_frame)
        if key in memo:
            return memo[key]
        # SKIP, horizon 1: the tracker coasts one frame on the stale state.
        best = det_acc * ret ** (head - det_frame) + rec(
            head + 1, max(npu_free - gamma, 0.0), det_acc, det_frame
        )
        for _, t_npu, acc in npu_cands:
            finish = max(npu_free, 0.0) + t_npu
            if finish > T + 1e-12:
                continue
            for k in range(1, k_max + 1):
                v = (
                    acc
                    + tracked_sum(acc, head, 1, k)
                    + rec(head + k, max(finish - k * gamma, 0.0), acc, head)
                )
                if v > best:
                    best = v
        if best_srv is not None:
            for k in range(1, k_max + 1):
                v = (
                    best_srv
                    + tracked_sum(best_srv, head, 1, k)
                    + rec(
                        head + k, max(npu_free - k * gamma, 0.0), best_srv, head
                    )
                )
                if v > best:
                    best = v
        memo[key] = best
        return best

    return rec(0, 0.0, 0.0, -1)
