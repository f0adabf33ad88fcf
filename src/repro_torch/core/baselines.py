"""Baseline policies from paper §VI.C: Offload and Local.

Each exposes ``plan_round(models, stream, net, *, npu_free, ...) -> RoundPlan``
with the same round contract as Max-Accuracy/Max-Utility, so the controller
treats every policy identically.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .max_utility import local_utility_dp
from .profiles import ModelProfile, NetworkState, StreamSpec, best_server_model
from .registry import Param, register_policy
from .schedule import Decision, RoundPlan, Where

# alpha is the shared mode switch of every baseline: None = accuracy mode
# (paper Fig. 5-8), a float = utility mode with that weight (paper Fig. 9-11).
_ALPHA = Param.number("alpha", None, nullable=True, doc="None = accuracy mode; float = utility weight")


@register_policy(
    "offload",
    params=(_ALPHA,),
    doc="§VI.C Offload baseline: always ship to the edge, resize to keep up.",
)
def offload_plan_round(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    npu_free: float = 0.0,
    alpha: float | None = None,
) -> RoundPlan:
    """Offload-only: resize each frame so it uploads before the next arrives
    (S/B <= gamma), then let the server pick its most accurate deadline-feasible
    model.  If even the smallest resolution cannot keep up, the frame is
    dropped — this is what makes Offload collapse below ~1.5 Mbps (Fig. 5b).
    """
    gamma, T = stream.gamma, stream.deadline
    best: tuple[float, int, int, float] | None = None  # (score, j, r, t_up)
    for r in stream.resolutions:
        t_up = net.upload_time(stream.frame_bytes(r))
        if t_up > gamma:  # cannot sustain the stream at this resolution
            continue
        budget = T - t_up - net.rtt
        pick = best_server_model(models, r, budget)
        if pick is None:
            continue
        j, a = pick
        score = a if alpha is None else min(1.0 / max(t_up, 1e-9), stream.fps) + alpha * a
        if best is None or score > best[0]:
            best = (score, j, r, t_up)
    if best is None:
        return RoundPlan(decisions=[Decision(0, Where.SKIP)], horizon=1, npu_busy_until=npu_free)
    _, j, r, t_up = best
    fin = t_up + net.rtt + models[j].t_server
    return RoundPlan(
        decisions=[Decision(0, Where.SERVER, j, r, start=0.0, finish=fin)],
        horizon=1,
        expected_accuracy_sum=models[j].accuracy(r, where="server"),
        npu_busy_until=npu_free,
        net_busy_until=t_up,
    )


@register_policy(
    "local",
    params=(
        _ALPHA,
        Param.integer("window_frames", None, nullable=True, doc="DP window; default floor(T/gamma)"),
    ),
    doc="§VI.C Local baseline: NPU-only schedule via the paper's DP.",
)
def local_plan_round(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    npu_free: float = 0.0,
    alpha: float | None = None,
    window_frames: int | None = None,
) -> RoundPlan:
    """Local-only: the paper's Local baseline ("uses the proposed dynamic
    programming technique to find the optimal schedule decision for local
    processing").  With ``alpha`` set it optimizes utility (skips allowed),
    else accuracy (all frames processed; falls back to best-effort skip of the
    head frame if infeasible)."""
    gamma, T = stream.gamma, stream.deadline
    n = window_frames if window_frames is not None else max(int(np.floor(T / gamma)), 1)
    if alpha is None:
        from .max_accuracy import local_window_plan

        plan = local_window_plan(models, stream, npu_free=npu_free, window_frames=n)
        if plan is None:
            return RoundPlan(decisions=[Decision(0, Where.SKIP)], horizon=1, npu_busy_until=npu_free)
        return plan
    dp = local_utility_dp(
        models,
        n_frames=n,
        gamma=gamma,
        deadline=T,
        alpha=alpha,
        npu_free=npu_free,
        first_arrival=0.0,
        window=n * gamma,
    )
    chosen = {k: j for k, j in dp.decisions}
    decisions = []
    free = max(npu_free, 0.0)
    npu_last = free
    for k in range(n):
        if k in chosen:
            j = chosen[k]
            start = max(free, k * gamma)
            free = start + models[j].t_npu
            npu_last = free
            decisions.append(Decision(k, Where.NPU, j, stream.r_max, start=start, finish=free))
        else:
            decisions.append(Decision(k, Where.SKIP))
    return RoundPlan(
        decisions=decisions, horizon=n, expected_utility=dp.utility, npu_busy_until=npu_last
    )
