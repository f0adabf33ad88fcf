"""Max-Utility scheduling (paper §V, Algorithm 2).

Round shape mirrors Max-Accuracy: the head frame I_0 is offloaded with the
(j, r) maximizing ``min(B/S(I_0,r), f) + alpha * a(j, r)`` subject to the
deadline (the rate term is capped at the stream fps — an uncapped B/S would
reward resolutions smaller than the camera can even produce).  The n_l frames
buffered during the upload go through a dominance-pruned DP over triples
(t, u, m): time the NPU frees, utility accrued, frames processed.  Frames may
be SKIPPED — that is the whole point of Max-Utility (paper Eq. 12/13).

Differences from the paper's pseudocode, both robustness fixes:
  * backtracking uses explicit parent pointers instead of float-equality
    matching (lines 19-27 of Algorithm 2);
  * ``n_l = floor(S/(B*gamma))`` — Algorithm 2 line 9 says ``S/B`` which is a
    time, not a frame count; §IV and the text define the frame count form.

docs/scheduling.md explains the weighted objective and the Pareto pruning in
prose, alongside the edge-server admission logic that wraps this solver.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .profiles import ModelProfile, NetworkState, StreamSpec
from .registry import Param, register_policy
from .schedule import Decision, RoundPlan, Where

NEG = -1e18


@dataclass
class Triple:
    t: float  # NPU free time
    u: float  # utility accrued over the local window
    m: int  # frames processed so far
    parent: "Triple | None" = None
    action: tuple[int, int] = (-1, -1)  # (frame k, model j); j=-1 => skip


def _prune(cands: list[Triple], cap: int = 256) -> list[Triple]:
    """Keep the Pareto front: (t', u') dominates (t, u) iff t' <= t and u' >= u."""
    cands.sort(key=lambda c: (c.t, -c.u))
    front: list[Triple] = []
    best_u = NEG
    for c in cands:
        if c.u > best_u + 1e-12:
            front.append(c)
            best_u = c.u
    if len(front) > cap:
        # Safety net (the Pareto set is tiny for realistic profiles): keep the
        # highest-utility cap entries, preserving t-order.
        front = sorted(front, key=lambda c: -c.u)[:cap]
        front.sort(key=lambda c: c.t)
    return front


@dataclass(frozen=True)
class LocalUtilityResult:
    utility: float
    decisions: list[tuple[int, int]]  # (frame k, model j) for processed frames
    npu_free: float
    processed: int
    feasible: bool = True


def local_utility_dp(
    models: Sequence[ModelProfile],
    *,
    n_frames: int,
    gamma: float,
    deadline: float,
    alpha: float,
    npu_free: float,
    first_arrival: float,
    window: float,
) -> LocalUtilityResult:
    """Dominance-pruned DP over (t, u, m) triples; frames may be skipped.

    ``window`` is the paper's ``n_l * gamma`` normalizer for the rate term.
    """
    if n_frames <= 0:
        return LocalUtilityResult(0.0, [], npu_free, 0)
    local = [(j, m) for j, m in enumerate(models) if m.runs_local]
    acc = {j: (m.acc_npu[max(m.acc_npu)] if m.acc_npu else 0.0) for j, m in local}
    window = max(window, gamma)

    U: list[Triple] = [Triple(t=max(npu_free, 0.0), u=0.0, m=0)]
    for k in range(n_frames):
        arrival = first_arrival + k * gamma
        cands: list[Triple] = list(U)  # "no processing": carry every triple over
        for tri in U:
            for j, mod in local:
                t2 = max(tri.t, arrival) + mod.t_npu
                if t2 > arrival + deadline + 1e-12:
                    continue
                m = tri.m
                # Paper's running update: strip the old rate term, average in
                # the new accuracy, re-add the rate term for m+1 frames.
                mean_acc_term = (m / (m + 1)) * (tri.u - m / window) + alpha * acc[j] / (m + 1)
                u2 = mean_acc_term + (m + 1) / window
                cands.append(Triple(t=t2, u=u2, m=m + 1, parent=tri, action=(k, j)))
        U = _prune(cands)

    best = max(U, key=lambda c: c.u)
    decisions: list[tuple[int, int]] = []
    node: Triple | None = best
    while node is not None and node.parent is not None:
        decisions.append(node.action)
        node = node.parent
    decisions.reverse()
    return LocalUtilityResult(best.u, decisions, best.t, best.m)


def _round_utility(
    decisions: Sequence[Decision], models, stream: StreamSpec, horizon: int, alpha: float
) -> float:
    """The true round objective: processed rate + alpha * mean processed acc."""
    processed = [d for d in decisions if d.is_processed()]
    if not processed:
        return 0.0
    acc = 0.0
    for d in processed:
        m = models[d.model]
        acc += (
            m.accuracy(d.resolution, where="server")
            if d.where is Where.SERVER
            else m.accuracy(stream.r_max, where="npu")
        )
    return len(processed) / (max(horizon, 1) * stream.gamma) + alpha * acc / len(processed)


def _local_decisions(
    models,
    stream: StreamSpec,
    dp: LocalUtilityResult,
    *,
    n_frames: int,
    first_frame_id: int,
    first_arrival: float,
    npu_free: float,
) -> tuple[list[Decision], float]:
    processed_local = {k: j for k, j in dp.decisions}
    decisions: list[Decision] = []
    free = max(npu_free, 0.0)
    npu_last = free
    for k in range(n_frames):
        frame_id = k + first_frame_id
        arrival = first_arrival + k * stream.gamma
        if k in processed_local:
            j = processed_local[k]
            start = max(free, arrival)
            free = start + models[j].t_npu
            npu_last = free
            decisions.append(
                Decision(frame_id, Where.NPU, j, stream.r_max, start=start, finish=free)
            )
        else:
            decisions.append(Decision(frame_id, Where.SKIP))
    return decisions, npu_last


@register_policy(
    "max_utility",
    params=(Param.number("alpha", doc="paper Eq. (9) accuracy weight (required)"),),
    doc="Paper §V Algorithm 2: per-round Max-Utility (rate + alpha * accuracy).",
    batched=True,
    batched_multi=True,
    batched_online=True,
)
def plan_round(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    alpha: float,
    npu_free: float = 0.0,
) -> RoundPlan:
    """One Max-Utility round for head frame I_0 arriving at t=0.

    Two candidates compete on the true round objective (rate + alpha * mean
    processed accuracy): the paper's offload round (offload phase + local DP
    for the buffered frames) and a pure-local round.  Without the latter,
    Max-Utility would offload low-accuracy frames it should keep on the NPU
    whenever *any* offload is feasible, and lose to the Local baseline at low
    bandwidth — contradicting Fig. 9.
    """
    gamma, T, f = stream.gamma, stream.deadline, stream.fps

    # --- offload phase: argmax_{j,r} capped-rate + alpha * a(j, r) ---
    best_off: tuple[float, int, int, float] | None = None  # (u', j, r, t_up)
    for r in stream.resolutions:
        t_up = net.upload_time(stream.frame_bytes(r))
        for j, m in enumerate(models):
            if not m.runs_server:
                continue
            if t_up + m.t_server + net.rtt > T:
                continue
            u = min(1.0 / max(t_up, 1e-9), f) + alpha * m.accuracy(r, where="server")
            if best_off is None or u > best_off[0]:
                best_off = (u, j, r, t_up)

    candidates: list[RoundPlan] = []

    n_w = max(int(np.floor(T / gamma)), 1)
    if best_off is not None:
        _, j0, r0, t_up = best_off
        # Paper Algorithm 2 sizes the local phase to the link-busy frames
        # (n_l); we extend it to the full deadline window so the rate term of
        # a short-upload round is not inflated by a 1-frame horizon — a
        # beyond-paper fix that makes Max-Utility dominate Local per-round
        # (EXPERIMENTS.md §Paper-repro discusses both variants).
        n_l = int(np.floor(t_up / gamma))
        n_plan = max(n_l, n_w - 1)
        dp = local_utility_dp(
            models,
            n_frames=n_plan,
            gamma=gamma,
            deadline=T,
            alpha=alpha,
            npu_free=npu_free,
            first_arrival=gamma,
            window=max(n_plan, 1) * gamma,
        )
        local_dec, npu_last = _local_decisions(
            models, stream, dp, n_frames=n_plan, first_frame_id=1, first_arrival=gamma,
            npu_free=npu_free,
        )
        decisions = [
            Decision(0, Where.SERVER, j0, r0, start=0.0, finish=t_up + net.rtt + models[j0].t_server)
        ] + local_dec
        horizon = n_plan + 1
        candidates.append(
            RoundPlan(
                decisions=decisions,
                horizon=horizon,
                expected_utility=_round_utility(decisions, models, stream, horizon, alpha),
                npu_busy_until=npu_last,
                net_busy_until=t_up,
            )
        )

    # Pure-local candidate over one deadline window.
    dp_l = local_utility_dp(
        models,
        n_frames=n_w,
        gamma=gamma,
        deadline=T,
        alpha=alpha,
        npu_free=npu_free,
        first_arrival=0.0,
        window=n_w * gamma,
    )
    dec_l, npu_last_l = _local_decisions(
        models, stream, dp_l, n_frames=n_w, first_frame_id=0, first_arrival=0.0, npu_free=npu_free
    )
    candidates.append(
        RoundPlan(
            decisions=dec_l,
            horizon=n_w,
            expected_utility=_round_utility(dec_l, models, stream, n_w, alpha),
            npu_busy_until=npu_last_l,
        )
    )

    best = max(candidates, key=lambda p: p.expected_utility)
    if not any(d.is_processed() for d in best.decisions):
        return RoundPlan(decisions=[Decision(0, Where.SKIP)], horizon=1, npu_busy_until=npu_free)
    return best
