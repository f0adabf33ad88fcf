"""Max-Accuracy scheduling (paper §IV, Algorithm 1).

Per round: try every offload resolution r for the head frame I_0, pick the
highest-accuracy feasible server model (offload phase), then schedule the
n_l = floor(S(I_0,r)/(B*gamma)) frames that arrive during the upload on the
NPU with an exact dynamic program over a discretized time grid (local phase).
The candidate with the best *normalized* accuracy A'/(n_l+1) wins.  A pure
local candidate (process I_0 on the NPU, horizon 1) is always in the running,
which is what makes Max-Accuracy degrade gracefully to the Local policy when
the network is poor (paper Fig. 5).

Implementation notes vs the paper's pseudocode:
  * Line 7-10 of Algorithm 1 adds every feasible server model; the prose
    ("the model with the highest accuracy ... will be selected") makes clear
    only the best one is meant — we implement the prose.
  * The DP uses conservative rounding (durations ceil'd to the grid, deadlines
    floor'd) so any extracted schedule is feasible in continuous time; the
    final Decision timestamps are recomputed exactly.

A prose walkthrough of the DP grid (and how the multi-tenant edge server
reuses this solver as its inner loop) lives in docs/scheduling.md.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .profiles import ModelProfile, NetworkState, StreamSpec, best_server_model
from .registry import Param, register_policy
from .schedule import Decision, RoundPlan, Where

NEG = -1e18


@dataclass(frozen=True)
class LocalDPResult:
    """Result of the local-phase DP over frames 1..n (or 0..n-1)."""

    total_accuracy: float
    models: list[int]  # chosen model index per frame, aligned with frame ids
    finish_times: list[float]
    feasible: bool


def local_dp(
    models: Sequence[ModelProfile],
    *,
    n_frames: int,
    gamma: float,
    deadline: float,
    npu_free: float,
    first_arrival: float,
    accuracies: Sequence[float] | None = None,
    grid: float = 1e-3,
) -> LocalDPResult:
    """Exact DP: H(k, t) = max_j H(k-1, t - T_j^npu) + a(j, r_max)  (Eq. 7/8).

    Frame k (0-based here) arrives at ``first_arrival + k*gamma`` and must
    finish by ``arrival + deadline``.  All frames must be processed; if any
    frame admits no model, the instance is infeasible (Max-Accuracy does not
    skip frames).
    """
    local = [(j, m) for j, m in enumerate(models) if m.runs_local]
    if n_frames <= 0:
        return LocalDPResult(0.0, [], [], True)
    if not local:
        return LocalDPResult(NEG, [], [], False)

    if accuracies is None:
        acc = {j: m.acc_npu[max(m.acc_npu)] if m.acc_npu else 0.0 for j, m in local}
    else:
        acc = {j: accuracies[j] for j, _ in local}

    horizon = first_arrival + (n_frames - 1) * gamma + deadline
    nbins = int(np.ceil(horizon / grid)) + 2
    dur_bins = {j: int(np.ceil(m.t_npu / grid)) for j, m in local}

    # H[b]: best accuracy sum with the NPU freeing exactly at bin b.
    H = np.full(nbins, NEG)
    start_bin = int(np.ceil(max(npu_free, 0.0) / grid))
    if start_bin >= nbins:
        return LocalDPResult(NEG, [], [], False)
    H[start_bin] = 0.0

    choice = np.full((n_frames, nbins), -1, dtype=np.int32)
    parent = np.full((n_frames, nbins), -1, dtype=np.int32)

    for k in range(n_frames):
        arrival = first_arrival + k * gamma
        arr_bin = int(np.ceil(arrival / grid))
        dl_bin = int(np.floor((arrival + deadline) / grid))
        Hn = np.full(nbins, NEG)
        # Prefix max of H up to arr_bin: any earlier-free NPU starts at arrival.
        pre = np.maximum.accumulate(H[: arr_bin + 1]) if arr_bin >= 0 else None
        pre_arg = None
        if pre is not None and arr_bin < nbins:
            pre_arg = np.zeros(arr_bin + 1, dtype=np.int32)
            best = H[0]
            bi = 0
            for b in range(arr_bin + 1):
                if H[b] > best:
                    best, bi = H[b], b
                pre_arg[b] = bi
        for j, _m in local:
            d = dur_bins[j]
            a = acc[j]
            # Case A: NPU free at or before arrival -> finish at arr_bin + d.
            fb = arr_bin + d
            if pre is not None and fb < nbins and fb <= dl_bin:
                cand = pre[arr_bin] + a
                if cand > Hn[fb]:
                    Hn[fb] = cand
                    choice[k, fb] = j
                    parent[k, fb] = pre_arg[arr_bin]
            # Case B: NPU free after arrival -> finish = free + d (shift).
            lo = arr_bin + 1
            hi = min(nbins - d, dl_bin - d + 1)
            if hi > lo:
                seg = H[lo:hi] + a
                tgt = slice(lo + d, hi + d)
                better = seg > Hn[tgt]
                idx = np.nonzero(better)[0]
                if idx.size:
                    Hn[tgt.start + idx] = seg[idx]
                    choice[k, tgt.start + idx] = j
                    parent[k, tgt.start + idx] = lo + idx
        H = Hn
        if not np.any(H > NEG / 2):
            return LocalDPResult(NEG, [], [], False)

    end_bin = int(np.argmax(H))
    total = float(H[end_bin])
    if total <= NEG / 2:
        return LocalDPResult(NEG, [], [], False)

    # Backtrack, then recompute exact continuous-time finishes.
    chosen = []
    b = end_bin
    for k in range(n_frames - 1, -1, -1):
        chosen.append(int(choice[k, b]))
        b = int(parent[k, b])
    chosen.reverse()

    finishes: list[float] = []
    free = max(npu_free, 0.0)
    for k, j in enumerate(chosen):
        arrival = first_arrival + k * gamma
        start = max(free, arrival)
        free = start + models[j].t_npu
        finishes.append(free)
        if free > arrival + deadline + 1e-9:
            return LocalDPResult(NEG, [], [], False)  # conservative rounding prevents this
    return LocalDPResult(total, chosen, finishes, True)


def local_window_plan(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    *,
    npu_free: float = 0.0,
    grid: float = 1e-3,
    window_frames: int | None = None,
) -> RoundPlan | None:
    """Optimal all-local plan over a deadline-sized window (shared by the
    Local baseline and Max-Accuracy's local candidate — planning whole
    windows, not single frames, is what keeps Max-Accuracy >= Local)."""
    gamma, T = stream.gamma, stream.deadline
    n = window_frames if window_frames is not None else max(int(np.floor(T / gamma)), 1)
    for nn in range(n, 0, -1):
        dp = local_dp(
            models, n_frames=nn, gamma=gamma, deadline=T, npu_free=npu_free,
            first_arrival=0.0, grid=grid,
        )
        if dp.feasible:
            decisions = [
                Decision(k, Where.NPU, j, stream.r_max, start=fin - models[j].t_npu, finish=fin)
                for k, (j, fin) in enumerate(zip(dp.models, dp.finish_times))
            ]
            return RoundPlan(
                decisions=decisions,
                horizon=nn,
                expected_accuracy_sum=dp.total_accuracy,
                npu_busy_until=dp.finish_times[-1] if dp.finish_times else npu_free,
            )
    return None


@register_policy(
    "max_accuracy",
    params=(Param.number("grid", 1e-3, doc="local-phase DP time grid (s)"),),
    doc="Paper §IV Algorithm 1: per-round Max-Accuracy offload + local DP.",
)
def plan_round(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    npu_free: float = 0.0,
    grid: float = 1e-3,
) -> RoundPlan:
    """One Max-Accuracy round for head frame I_0 arriving at t=0."""
    gamma, T = stream.gamma, stream.deadline
    best_plan: RoundPlan | None = None
    best_norm = NEG

    # --- offload candidates: one per resolution r (Algorithm 1 outer loop) ---
    for r in stream.resolutions:
        t_up = net.upload_time(stream.frame_bytes(r))
        budget = T - t_up - net.rtt
        if budget <= 0:
            continue
        pick = best_server_model(models, r, budget)
        if pick is None:
            continue
        j0, a0 = pick
        n_l = int(np.floor(t_up / gamma))
        dp = local_dp(
            models,
            n_frames=n_l,
            gamma=gamma,
            deadline=T,
            npu_free=npu_free,
            first_arrival=gamma,
            grid=grid,
        )
        if not dp.feasible:
            continue
        total = a0 + dp.total_accuracy
        norm = total / (n_l + 1)
        if norm > best_norm:
            decisions = [
                Decision(0, Where.SERVER, j0, r, start=0.0, finish=t_up + net.rtt + models[j0].t_server)
            ]
            for k, (j, fin) in enumerate(zip(dp.models, dp.finish_times)):
                decisions.append(
                    Decision(k + 1, Where.NPU, j, stream.r_max, start=fin - models[j].t_npu, finish=fin)
                )
            best_norm = norm
            best_plan = RoundPlan(
                decisions=decisions,
                horizon=n_l + 1,
                expected_accuracy_sum=total,
                npu_busy_until=dp.finish_times[-1] if dp.finish_times else npu_free,
                net_busy_until=t_up,
            )

    # --- pure local candidate: optimal plan over a full deadline window ---
    lp = local_window_plan(models, stream, npu_free=npu_free, grid=grid)
    if lp is not None and lp.expected_accuracy_sum / lp.horizon > best_norm:
        best_norm = lp.expected_accuracy_sum / lp.horizon
        best_plan = lp

    if best_plan is None:
        # Nothing can make the deadline: drop the head frame and move on.
        best_plan = RoundPlan(decisions=[Decision(0, Where.SKIP)], horizon=1, npu_busy_until=npu_free)
    return best_plan
