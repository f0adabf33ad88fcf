"""Offline Optimal oracle (paper §VI.C "Optimal").

The paper replays the trace and searches all schedules offline.  Exhaustive
enumeration is O((n_c * n_r)^n); we provide

  * ``exhaustive_best`` — the literal search, exact in continuous time, for
    tiny instances (property-test oracle);
  * ``optimal_accuracy`` / ``optimal_utility`` — an equivalent *joint-resource
    dynamic program* over (frame, NPU-free offset, link-free offset[, count])
    on a discretized grid: exact up to the grid, tractable for whole traces.

The two contended resources are the NPU (serial) and the uplink (serial);
the edge server is parallel, as in the paper.  Durations are ceil'd to the
grid and deadlines floor'd, so the DP value is a *feasible* (lower-bound)
optimum; with grid -> 0 it converges to the true optimum from below.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .profiles import ModelProfile, NetworkState, StreamSpec
from .registry import Param, register_policy
from .schedule import Decision, RoundPlan, Where

NEG = -1e18


@dataclass(frozen=True)
class Action:
    kind: str  # "npu" | "net"
    dur: float  # serial occupancy of the resource
    budget: float  # latest resource-free offset (vs arrival) that still meets T
    acc: float


def enumerate_actions(
    models: Sequence[ModelProfile], stream: StreamSpec, net: NetworkState
) -> list[Action]:
    T = stream.deadline
    acts: list[Action] = []
    for m in models:
        if m.runs_local and m.t_npu <= T:
            acts.append(Action("npu", m.t_npu, T - m.t_npu, m.accuracy(stream.r_max, where="npu")))
    for r in stream.resolutions:
        t_up = net.upload_time(stream.frame_bytes(r))
        for m in models:
            if not m.runs_server:
                continue
            slack = T - t_up - net.rtt - m.t_server
            if slack < 0:
                continue
            acts.append(Action("net", t_up, slack, m.accuracy(r, where="server")))
    return acts


# ---------------------------------------------------------------------------
# Exact exhaustive search (tiny n) — the test oracle.
# ---------------------------------------------------------------------------


def exhaustive_best(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    n_frames: int,
    *,
    alpha: float | None = None,
) -> float:
    """Exact optimum by trying every (skip | action) per frame.

    Returns mean accuracy over all frames (alpha=None) or utility.
    Exponential — keep n_frames <= ~6 in tests.
    """
    gamma = stream.gamma
    acts = enumerate_actions(models, stream, net)
    best = {"v": 0.0}

    def rec(i: int, npu_free: float, net_free: float, acc_sum: float, m: int) -> None:
        if i == n_frames:
            if alpha is None:
                best["v"] = max(best["v"], acc_sum / n_frames)
            elif m > 0:
                best["v"] = max(best["v"], m / (n_frames * gamma) + alpha * acc_sum / m)
            return
        arrival = i * gamma
        rec(i + 1, npu_free, net_free, acc_sum, m)  # skip
        for a in acts:
            free = npu_free if a.kind == "npu" else net_free
            start = max(free, arrival)
            if start - arrival > a.budget + 1e-12:
                continue
            if a.kind == "npu":
                rec(i + 1, start + a.dur, net_free, acc_sum + a.acc, m + 1)
            else:
                rec(i + 1, npu_free, start + a.dur, acc_sum + a.acc, m + 1)

    rec(0, 0.0, 0.0, 0.0, 0)
    return best["v"]


# ---------------------------------------------------------------------------
# Grid DP — whole-trace Optimal.
# ---------------------------------------------------------------------------


def _dp_tables(acts: list[Action], grid: float, nb: int):
    table = []
    for a in acts:
        d = max(int(np.ceil(a.dur / grid - 1e-12)), 0)
        bmax = int(np.floor((a.budget + 1e-12) / grid))
        table.append((a.kind, d, min(bmax, nb - 1), a.acc))
    return table


def _decay(V: np.ndarray, k: int) -> np.ndarray:
    """Advance one frame: both resource offsets shrink by k bins (clamp at 0).

    V's last two axes are (npu_off, net_off); leading axes pass through.
    """
    if k == 0:
        return V
    nb = V.shape[-1]
    out = np.full_like(V, NEG)
    kk = min(k, nb)
    if kk < nb:
        out[..., : nb - kk, : nb - kk] = V[..., kk:, kk:]
        out[..., 0, : nb - kk] = np.maximum(
            out[..., 0, : nb - kk], V[..., :kk, kk:].max(axis=-2)
        )
        out[..., : nb - kk, 0] = np.maximum(
            out[..., : nb - kk, 0], V[..., kk:, :kk].max(axis=-1)
        )
    out[..., 0, 0] = np.maximum(out[..., 0, 0], V[..., :kk, :kk].max(axis=(-2, -1)))
    return out


def optimal_accuracy(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    n_frames: int,
    *,
    grid: float = 2e-3,
) -> float:
    """Mean accuracy of the (grid-)optimal offline schedule."""
    gamma, T = stream.gamma, stream.deadline
    nb = int(np.floor(T / grid)) + 1
    acts = enumerate_actions(models, stream, net)
    if not acts:
        return 0.0
    table = _dp_tables(acts, grid, nb)
    k = int(np.floor(gamma / grid))

    V = np.full((nb, nb), NEG)
    V[0, 0] = 0.0
    for _ in range(n_frames):
        Vn = V.copy()  # skip
        for kind, d, bmax, acc in table:
            if kind == "npu":
                for b in range(bmax + 1):
                    tgt = min(b + d, nb - 1)
                    Vn[tgt, :] = np.maximum(Vn[tgt, :], V[b, :] + acc)
            else:
                for b in range(bmax + 1):
                    tgt = min(b + d, nb - 1)
                    Vn[:, tgt] = np.maximum(Vn[:, tgt], V[:, b] + acc)
        V = _decay(Vn, k)
    return float(V.max()) / n_frames


def optimal_utility(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    n_frames: int,
    *,
    alpha: float,
    grid: float = 5e-3,
) -> float:
    """Optimal offline utility: rate + alpha * mean accuracy over processed."""
    gamma, T = stream.gamma, stream.deadline
    nb = int(np.floor(T / grid)) + 1
    acts = enumerate_actions(models, stream, net)
    if not acts:
        return 0.0
    table = _dp_tables(acts, grid, nb)
    k = int(np.floor(gamma / grid))

    V = np.full((n_frames + 1, nb, nb), NEG)  # [processed count m, npu, net]
    V[0, 0, 0] = 0.0
    for _ in range(n_frames):
        Vn = V.copy()  # skip
        for kind, d, bmax, acc in table:
            if kind == "npu":
                for b in range(bmax + 1):
                    tgt = min(b + d, nb - 1)
                    Vn[1:, tgt, :] = np.maximum(Vn[1:, tgt, :], V[:-1, b, :] + acc)
            else:
                for b in range(bmax + 1):
                    tgt = min(b + d, nb - 1)
                    Vn[1:, :, tgt] = np.maximum(Vn[1:, :, tgt], V[:-1, :, b] + acc)
        V = _decay(Vn, k)

    best = 0.0
    elapsed = n_frames * gamma
    for m in range(1, n_frames + 1):
        s = float(V[m].max())
        if s <= NEG / 2:
            continue
        best = max(best, m / elapsed + alpha * s / m)
    return best


# ---------------------------------------------------------------------------
# Oracle as a *policy*: a windowed grid DP with path recovery, so the oracle
# can be swept through the registry / Session front door like any heuristic.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _PlanAction:
    """An action with identity (model, resolution), unlike :class:`Action`."""

    kind: str  # "npu" | "net"
    model: int
    resolution: int
    dur: float  # serial occupancy of the resource (t_npu or t_up), seconds
    tail: float  # post-occupancy latency: 0 for npu, rtt + t_server for net
    acc: float


def _window_actions(
    models: Sequence[ModelProfile], stream: StreamSpec, net: NetworkState
) -> list[_PlanAction]:
    T = stream.deadline
    acts: list[_PlanAction] = []
    for j, m in enumerate(models):
        if m.runs_local and m.t_npu <= T:
            acts.append(
                _PlanAction("npu", j, stream.r_max, m.t_npu, 0.0,
                            m.accuracy(stream.r_max, where="npu"))
            )
    for r in stream.resolutions:
        t_up = net.upload_time(stream.frame_bytes(r))
        for j, m in enumerate(models):
            if not m.runs_server or T - t_up - net.rtt - m.t_server < 0:
                continue
            acts.append(
                _PlanAction("net", j, r, t_up, net.rtt + m.t_server,
                            m.accuracy(r, where="server"))
            )
    return acts


@register_policy(
    "brute_force",
    params=(
        Param.number("alpha", None, nullable=True, doc="None = accuracy mode; float = utility weight"),
        Param.integer("window_frames", None, nullable=True, doc="DP window; default floor(T/gamma)"),
        Param.number("grid", 5e-3, doc="DP time grid (s); finer = closer to the true optimum"),
    ),
    doc="§VI.C Optimal oracle as a policy: windowed joint-resource grid DP.",
)
def plan_round(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    npu_free: float = 0.0,
    alpha: float | None = None,
    window_frames: int | None = None,
    grid: float = 5e-3,
) -> RoundPlan:
    """One oracle round: grid-optimal (skip | npu | offload) per window frame.

    Same discretization contract as :func:`optimal_accuracy` — durations are
    ceil'd to the grid and budgets floor'd, so any extracted schedule is
    feasible in continuous time; Decision timestamps are recomputed exactly
    during extraction.  State is (frame, npu-free offset, link-free offset)
    with per-count accuracy vectors so one DP serves both objectives.
    """
    gamma, T = stream.gamma, stream.deadline
    n = window_frames if window_frames is not None else max(int(np.floor(T / gamma)), 1)
    acts = _window_actions(models, stream, net)
    if not acts:
        return RoundPlan(decisions=[Decision(0, Where.SKIP)], horizon=1, npu_busy_until=npu_free)

    nb = int(np.floor(T / grid)) + 1
    kdec = int(np.floor(gamma / grid))
    table = []  # (action, dur_bins, latest-start bin)
    for a in acts:
        d = max(int(np.ceil(a.dur / grid - 1e-12)), 0)
        bmax = int(np.floor((T - a.dur - a.tail + 1e-12) / grid))
        table.append((a, d, min(bmax, nb - 1)))

    memo: dict[tuple[int, int, int], tuple[np.ndarray, list[int]]] = {}

    def dec(b: int) -> int:
        return max(b - kdec, 0)

    def solve(k: int, bn: int, bl: int) -> tuple[np.ndarray, list[int]]:
        """vals[m] = best accuracy sum processing exactly m of frames k..n-1;
        choice[m] = action index taken at frame k on that path (-1 = skip)."""
        if k == n:
            base = np.full(1, 0.0)
            return base, []
        key = (k, bn, bl)
        hit = memo.get(key)
        if hit is not None:
            return hit
        rem = n - k
        vals = np.full(rem + 1, NEG)
        choice = [-1] * (rem + 1)
        sub, _ = solve(k + 1, dec(bn), dec(bl))
        vals[: len(sub)] = sub  # skip frame k
        for ai, (a, d, bmax) in enumerate(table):
            b = bn if a.kind == "npu" else bl
            if b > bmax:
                continue
            tgt = min(b + d, nb - 1)
            nbn, nbl = (tgt, bl) if a.kind == "npu" else (bn, tgt)
            sub, _ = solve(k + 1, dec(nbn), dec(nbl))
            for m in range(1, len(sub) + 1):
                if sub[m - 1] <= NEG / 2:
                    continue
                v = sub[m - 1] + a.acc
                if v > vals[m]:
                    vals[m] = v
                    choice[m] = ai
        memo[key] = (vals, choice)
        return vals, choice

    bn0 = min(max(int(np.ceil(max(npu_free, 0.0) / grid - 1e-12)), 0), nb - 1)
    vals, _ = solve(0, bn0, 0)
    window = n * gamma
    if alpha is None:
        m_star = int(np.argmax(vals))
    else:
        m_star, best_u = 0, 0.0
        for m in range(1, len(vals)):
            if vals[m] <= NEG / 2:
                continue
            u = m / window + alpha * vals[m] / m
            if u > best_u:
                m_star, best_u = m, u

    # Walk the chosen path, recomputing exact continuous-time stamps.
    decisions: list[Decision] = []
    bn, bl, m_left = bn0, 0, m_star
    npu_t, net_t = max(npu_free, 0.0), 0.0
    acc_sum, processed = 0.0, 0
    for k in range(n):
        arrival = k * gamma
        _, choice = solve(k, bn, bl)
        ai = choice[m_left] if m_left < len(choice) else -1
        if ai < 0:
            decisions.append(Decision(k, Where.SKIP))
            bn, bl = dec(bn), dec(bl)
            continue
        a, d, _ = table[ai]
        if a.kind == "npu":
            start = max(npu_t, arrival)
            finish = start + a.dur
            npu_t = finish
            where = Where.NPU
            tgt = min(bn + d, nb - 1)
            bn, bl = dec(tgt), dec(bl)
        else:
            start = max(net_t, arrival)
            finish = start + a.dur + a.tail
            net_t = start + a.dur
            where = Where.SERVER
            tgt = min(bl + d, nb - 1)
            bn, bl = dec(bn), dec(tgt)
        decisions.append(
            Decision(k, where, a.model, a.resolution, start=start, finish=finish)
        )
        acc_sum += a.acc
        processed += 1
        m_left -= 1
    utility = processed / window + (alpha * acc_sum / processed if processed else 0.0) if alpha is not None else 0.0
    return RoundPlan(
        decisions=decisions,
        horizon=n,
        expected_accuracy_sum=acc_sum,
        expected_utility=utility,
        npu_busy_until=npu_t,
        net_busy_until=net_t,
    )
