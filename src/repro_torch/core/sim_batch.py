"""Lane-batched sweep engine: whole scenario grids as tensor programs.

The reference simulator (``simulator.simulate``) replays one stream at a
time in a Python event loop.  This module executes and audits the same
round plans for a *group* of scenarios (bandwidth x deadline x fps x
policy-param grid points) at once on a torch device: every per-scenario
quantity is a tensor with a leading lane axis ``B``, and one Python loop
over scheduling rounds issues each round's ops once for the whole group.
A round (a) runs the policy's DP (:mod:`repro_torch.core.jax_sched`) for
every lane, (b) backtracks the argmax schedule, and (c) applies the shared
audit contract of :mod:`repro_torch.core.audit`; lanes whose stream has
ended are masked (``active = head < n_frames``) until the last lane of the
group is done.  The round loop reads one value from the device per round,
its termination test, and one more per group for the results.  On the card
each group's round is captured once as a CUDA graph and replayed, so a
round's thousand-odd small ops cost their device time, not their issue.

Exactness contract (held against the reference in
``tests/test_torch_sim_batch*.py``): for every scenario, the returned stats
equal ``simulate(PolicySpec(name, params).build(), ...)`` — the same bin
discretization, the same DP recurrences, the same f64 audit arithmetic in
the same order:

  * every host-side quantity the reference computes in float64 (bin edges,
    arrival times, windows, f32 casts of policy params) is computed here
    with the same numpy expressions, once per group, and moved to the
    device once;
  * the round-coupled quantity ``npu_free`` is carried on the device in
    float64, every division on it is by a per-lane tensor (a division by a
    Python number may run as a multiply by its reciprocal on the card),
    and every product rounds before the add it feeds;
  * fixed shapes come from *padding*, never truncation: windows pad to the
    group's quantized frame count ``W`` (padded frames are identity no-ops
    in the DPs) and the bin grid pads to the group's quantized bin count
    (padded bins stay ``NEG`` and cannot enter any argmax).

The ``jax_*`` planners reproduce their f32 DPs bit for bit and never
offload.  The ``track_*`` planners score candidates in closed form, bit for
bit.  The paper's ``max_accuracy`` / ``max_utility`` planners are
network-aware: each lane carries its ``rtt`` and piecewise-constant
bandwidth segments, every round looks the bandwidth up at its start time as
the reference calls ``trace.at(t0)``, and the offload phase runs as tensor
expressions around the f64 DP twins.  Their certified contract is integer
stats exact and accuracy sums within :data:`~repro_torch.core.audit
.AUDIT_TOL` (in practice the golden grids come out bit-equal too).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .audit import AUDIT_TOL
from .bucketing import quant_bins, quant_pow2, quant_w
from .jax_sched import (
    NEG,
    _accuracy_dp64,
    _accuracy_dp,
    _no_fma,
    _utility_dp64,
    _utility_dp,
)
from .profiles import ModelProfile, StreamSpec
from .registry import get_policy
from .schedule import StreamStats
from .tracking import WorkloadSpec, interval_means, retention, retention_powers

__all__ = ["BatchScenario", "batched_policies", "simulate_batch"]


@dataclass(frozen=True)
class BatchScenario:
    """One grid point as the batched engine sees it: a stream shape, a frame
    budget, the policy's *resolved* parameter dict (defaults filled in, e.g.
    ``PolicySpec(...).resolved``), and the network model.

    ``bw_segments`` is the piecewise-constant bandwidth trace as sorted
    ``(t_start_s, bandwidth_bps)`` segments — a constant trace is a single
    segment at ``t_start = 0``; before the first segment's start the first
    value applies (``simulator.Trace.piecewise`` semantics).  The local-only
    ``jax_*`` planners never consult the network.

    ``workload`` is the executor's world truth (``tracking.WorkloadSpec``):
    the ``track_*`` planners require ``kind="track"``; the classification
    planners require the default ``kind="classify"``."""

    stream: StreamSpec = field(default_factory=StreamSpec)
    n_frames: int = 120
    params: Mapping[str, Any] = field(default_factory=dict)
    rtt: float = 0.100
    bw_segments: tuple[tuple[float, float], ...] = ((0.0, 2.5e6),)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)


_PLANNERS: dict[str, Callable[..., list[StreamStats]]] = {}


def _planner(name: str):
    def deco(fn):
        _PLANNERS[name] = fn
        return fn

    return deco


def batched_policies() -> tuple[str, ...]:
    """Policy names this engine can execute (mirrors ``batched=True`` in the
    registry; ``tests/test_torch_sweep.py`` asserts the two stay in sync)."""
    return tuple(sorted(_PLANNERS))


def simulate_batch(
    policy: str,
    models: Sequence[ModelProfile],
    scenarios: Sequence[BatchScenario],
    *,
    strict: bool = True,
    device: torch.device | str = "cuda",
    groups: list[dict[str, Any]] | None = None,
) -> list[StreamStats]:
    """Run ``policy`` over every scenario, lane-batched on ``device``.

    Returns one audited :class:`StreamStats` per scenario, in order.  Raises
    ``ValueError`` for policies without a batched planner — callers that
    want the per-point loop for those route through ``Session.run_sweep``.
    Where ``groups`` is a list, one dict per shape group is appended to it:
    its key, lane count, rounds, host reads and lanes rerun at the cap."""
    fn = _PLANNERS.get(policy)
    if fn is None:
        raise ValueError(
            f"policy {policy!r} has no batched backend; available: {batched_policies()}"
        )
    entry = get_policy(policy)
    for s in scenarios:
        if s.workload.kind not in entry.workloads:
            raise ValueError(
                f"policy {policy!r} plans {'/'.join(entry.workloads)} workloads, "
                f"not {s.workload.kind!r}"
            )
    dev = resolve_device(device)
    if not scenarios:
        return []
    log = groups if groups is not None else []
    return fn(list(models), list(scenarios), bool(strict), _Run(dev, policy, log))


# ---------------------------------------------------------------------------
# Shared host-side precomputation (float64 numpy — the reference's
# expressions) and the round loop.
# ---------------------------------------------------------------------------


@dataclass
class _Run:
    """Where a simulate_batch call runs, and its per-group records."""

    device: torch.device
    policy: str
    groups: list[dict[str, Any]]

    def put(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device: int32 widens to int64 (the index
        dtype of gather), floats keep their dtype."""
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def zeros(self, B: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(B, dtype=dtype, device=self.device)

    def drive(self, key: Any, step, state: tuple, n_frames: torch.Tensor) -> tuple[tuple, dict]:
        """Run ``step`` until no lane is active (``state[0]`` is ``head``).
        The test after each round is that round's one read from the device;
        a lane with no frames is inactive from the start, so a group always
        runs at least one round.  On the card the round runs as a CUDA
        graph (:func:`_graphed`)."""
        record = {"policy": self.policy, "key": key, "lanes": int(n_frames.shape[0]),
                  "rounds": 0, "host_reads": 0, "reruns": 0}
        self.groups.append(record)
        if self.device.type == "cuda":
            step, state = _graphed(step, state)
        while True:
            state = step(state)
            record["rounds"] += 1
            record["host_reads"] += 1
            if not bool((state[0] < n_frames).any()):
                return state, record

    @staticmethod
    def read(record: dict, *parts: torch.Tensor) -> list[np.ndarray]:
        """The group's results in one copy to the host (integers below 2^53
        travel exactly as float64)."""
        record["host_reads"] += 1
        host = torch.stack([p.to(torch.float64) for p in parts]).cpu().numpy()
        return list(host)


def _graphed(step, state: tuple):
    """``step`` captured once as a CUDA graph that updates the round state
    in place, and a copy of ``state`` for it to update.

    A round is a few hundred to a few thousand small ops, and eagerly each
    costs its host issue, ~10x its time on the card; a replay issues them
    all at once.  Every shape in a round is fixed for the group, and a
    round never reads from the device, so the captured round is the round.
    Returns ``(replay, state)``: ``replay(state)`` runs one round."""
    static = tuple(t.clone() for t in state)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture (library handles, allocator)
        step(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for dst, src in zip(static, step(static)):
            dst.copy_(src)

    def replay(st: tuple) -> tuple:  # st is ``static``, updated in place
        graph.replay()
        return st

    replay.graph = graph  # keeps the graph (and its memory pool) alive with the closure
    return replay, static


def _window_frames(stream: StreamSpec, params: Mapping[str, Any]) -> int:
    """Mirror of the plan-round wrappers' window choice."""
    wf = params.get("window_frames")
    if wf is not None:
        return int(wf)
    return max(int(np.floor(stream.deadline / stream.gamma)), 1)


# Scenario grouping: one monolithic batch would force every lane to pay the
# batch-max window, bin count AND round count (the round loop runs until the
# deepest lane finishes).  Scenarios are instead partitioned into
# shape-homogeneous groups keyed on *quantized* shapes (core/bucketing),
# which bounds in-group padding waste by ~2x.  Padding is inert, so the
# partition cannot change any result — only wall-clock.


def _stitch(scenarios, key_fn, run_group) -> list[StreamStats]:
    """Partition ``scenarios`` by ``key_fn``, run each group, reassemble in
    the original order."""
    groups: dict[Any, list[int]] = {}
    for i, s in enumerate(scenarios):
        groups.setdefault(key_fn(s), []).append(i)
    stats: list[StreamStats | None] = [None] * len(scenarios)
    for key in sorted(groups):
        idx = groups[key]
        for i, st in zip(idx, run_group(key, [scenarios[i] for i in idx])):
            stats[i] = st
    return stats  # type: ignore[return-value]


@dataclass
class _Common:
    """Per-group host arrays shared by every planner."""

    B: int
    J: int
    W: int  # padded window (quantized group maximum)
    n_active: np.ndarray  # [B] i32 real window per scenario
    gamma: np.ndarray  # [B] f64
    deadline: np.ndarray  # [B] f64
    n_frames: np.ndarray  # [B] i32
    arrivals: np.ndarray  # [B, W] f64, k * gamma
    t_npu64: np.ndarray  # [J] f64 (inf for server-only models)
    acc_dp32: np.ndarray  # [J] f32 — the DP's accuracy table (raw max key)
    acc_dp64: np.ndarray  # [J] f64 — the same table for the float64 twins
    acc_stat64: np.ndarray  # [B, J] f64 — audit accuracy at the stream's r_max


def _common(models: list[ModelProfile], scenarios: list[BatchScenario], W: int | None = None) -> _Common:
    B, J = len(scenarios), len(models)
    n_active = np.array([_window_frames(s.stream, s.params) for s in scenarios], np.int32)
    W = int(n_active.max()) if W is None else int(W)
    gamma = np.array([s.stream.gamma for s in scenarios], np.float64)
    deadline = np.array([s.stream.deadline for s in scenarios], np.float64)
    n_frames = np.array([s.n_frames for s in scenarios], np.int32)
    arrivals = np.arange(W, dtype=np.float64)[None, :] * gamma[:, None]
    t_npu64 = np.array([m.t_npu for m in models], np.float64)
    acc_dp64 = np.array([m.acc_npu[max(m.acc_npu)] if m.acc_npu else 0.0 for m in models], np.float64)
    acc_stat64 = np.array(
        [[m.accuracy(s.stream.r_max, where="npu") for m in models] for s in scenarios], np.float64)
    return _Common(B, J, W, n_active, gamma, deadline, n_frames, arrivals, t_npu64,
                   acc_dp64.astype(np.float32), acc_dp64, acc_stat64)


def _collect(c: _Common, out, wall_s: float, offloaded: np.ndarray | None = None) -> list[StreamStats]:
    acc_sum, proc, miss, rounds, npu_busy = out
    if offloaded is None:
        offloaded = np.zeros(c.B)  # local-only planners never offload
    # The group schedules in one loop; apportion its wall time by round
    # count so schedule_time/schedule_calls is the amortized per-round cost.
    total_rounds = max(int(rounds.sum()), 1)
    return [
        StreamStats(
            frames_total=int(c.n_frames[b]),
            frames_processed=int(proc[b]),
            frames_missed_deadline=int(miss[b]),
            frames_offloaded=int(offloaded[b]),
            accuracy_sum=float(acc_sum[b]),
            elapsed=float(c.n_frames[b] * c.gamma[b]),
            schedule_calls=int(rounds[b]),
            schedule_time=wall_s * float(rounds[b]) / total_rounds,
            npu_busy_s=float(npu_busy[b]),
        )
        for b in range(c.B)
    ]


def _audit_scan(*, head, n_frames, arrivals, deadline, t_npu64, acc_stat, picks, gate, free0,
                acc_sum, proc, miss, npu_s, strict, frame_offset=0):
    """The :mod:`repro_torch.core.audit` contract for the NPU frames of a
    round, for every lane: a sequential f64 fold over the (padded) window in
    frame order, so accuracy accumulates exactly as the reference loop's
    repeated ``+=``.  ``gate[:, k]`` says whether frame ``k`` really
    executes; ``frame_offset`` is the plan-frame id of DP frame 0 (1 when
    the round's head frame offloaded — the offload phase accounts it before
    this fold, preserving decision order)."""
    J = t_npu64.shape[0]
    free = free0
    for k in range(picks.shape[1]):
        act = gate[:, k]
        j = picks[:, k].clamp(0, J - 1)
        arr_k = arrivals[:, k]
        start = torch.maximum(free, arr_k)
        t_j = t_npu64[j]
        finish = start + t_j
        if strict:
            bad = act & (finish > (arr_k + deadline) + AUDIT_TOL)
        else:
            bad = torch.zeros_like(act)
        in_range = (head + frame_offset + k) < n_frames
        take = act & ~bad & in_range
        acc_sum = acc_sum + torch.where(take, acc_stat.gather(1, j[:, None])[:, 0], 0.0)
        proc = proc + take.long()
        miss = miss + bad.long()  # missed counts even past-stream frames
        npu_s = npu_s + torch.where(act, t_j, 0.0)
        free = torch.where(act, finish, free)
    return free, acc_sum, proc, miss, npu_s


def _backtrack_bins(choices, parents, b0, upto=None):
    """Picks [B, W] of a bin DP, walked back from bin ``b0`` [B].  With
    ``upto`` [B], frames ``k >= upto`` are not the lane's (prefix records):
    they pick nothing and leave the bin alone."""
    nbins = choices[0].shape[1]
    b = b0[:, None]
    picks = [None] * len(choices)
    for k in range(len(choices) - 1, -1, -1):
        bc = b.clamp(0, nbins - 1)
        pick = choices[k].gather(1, bc)
        if upto is not None:
            on = (k < upto)[:, None]
            pick = torch.where(on, pick, -1)
            b = torch.where(on & (pick >= 0), parents[k].gather(1, bc), b)
        else:
            b = torch.where(pick >= 0, parents[k].gather(1, bc), b)
        picks[k] = pick
    return torch.cat(picks, dim=1)


def _backtrack_slots(parents, actions, u_final):
    """Picks [B, W] of a Pareto-front DP, walked back from the first slot of
    highest utility."""
    width = u_final.shape[1]
    s = torch.argmax(u_final, dim=1, keepdim=True)  # first max = front order
    picks = [None] * len(parents)
    for k in range(len(parents) - 1, -1, -1):
        ok = s >= 0
        sc = s.clamp(0, width - 1)
        picks[k] = torch.where(ok, actions[k].gather(1, sc), -1)
        s = torch.where(ok, parents[k].gather(1, sc), s)
    return torch.cat(picks, dim=1)


def _init_state(run: _Run, B: int, n_int: int, n_float: int) -> tuple:
    """Round-loop state: ``head`` (int64) and ``busy`` (f64), then
    ``n_float`` float64 and ``n_int`` int64 zeros, one per lane each."""
    return ((run.zeros(B, torch.int64), run.zeros(B, torch.float64))
            + tuple(run.zeros(B, torch.float64) for _ in range(n_float))
            + tuple(run.zeros(B, torch.int64) for _ in range(n_int)))


# ---------------------------------------------------------------------------
# jax_accuracy: Max-Accuracy local DP over a (padded) time-bin grid.
# ---------------------------------------------------------------------------


@_planner("jax_accuracy")
def _run_accuracy(models, scenarios, strict, run: _Run):
    def run_group(W, group):
        c = _common(models, group, W)
        grid = np.array([float(s.params["grid"]) for s in group], np.float64)
        # Bin arithmetic in f64 on the host — the same numpy expressions as
        # local_accuracy_dp_jax, over the group.
        arr_bins = np.ceil(c.arrivals / grid[:, None]).astype(np.int32)
        dl_bins = np.floor((c.arrivals + c.deadline[:, None]) / grid[:, None]).astype(np.int32)
        horizon_t = (c.n_active.astype(np.float64) - 1.0) * c.gamma + c.deadline
        nbins_real = (np.ceil(horizon_t / grid) + 2).astype(np.int32)
        NBINS = quant_bins(int(nbins_real.max()))
        # inf (server-only) and over-horizon durations clamp to NBINS: both
        # are unreachable in-bin exactly as the reference's raw values are.
        with np.errstate(invalid="ignore"):
            dur_f = np.ceil(c.t_npu64[None, :] / grid[:, None])
        dur = np.where(np.isfinite(dur_f), np.minimum(dur_f, NBINS), NBINS).astype(np.int32)
        t_start = time.perf_counter()
        P = run.put
        gamma, deadline, grid_t = P(c.gamma), P(c.deadline), P(grid)
        n_active, nbins_r, n_frames = P(c.n_active), P(nbins_real), P(c.n_frames)
        arr_t, dl_t, dur_t, arrivals = P(arr_bins), P(dl_bins), P(dur), P(c.arrivals)
        acc_stat, t_npu64, acc32 = P(c.acc_stat64), P(c.t_npu64), P(c.acc_dp32)
        ks = torch.arange(c.W, device=run.device)

        def step(state):
            head, busy, acc_sum, npu_s, proc, miss, rounds = state
            active = head < n_frames
            t0 = head.double() * gamma
            npu_free = torch.clamp_min(busy - t0, 0.0)
            # Reference: int(np.ceil(max(npu_free, 0.0) / grid)), clipped to
            # the scenario's REAL bin count (not the padded one).
            start_bin = torch.ceil(npu_free.clamp_min(0.0) / grid_t).long()
            start_bin = torch.minimum(start_bin.clamp_min(0), nbins_r - 1)
            H, choices, parents = _accuracy_dp(dur_t, acc32, arr_t, dl_t, start_bin, n_active,
                                                     nbins=NBINS)
            feasible = H.amax(dim=1) > NEG / 2
            picks = _backtrack_bins(choices, parents, torch.argmax(H, dim=1))
            gate = (active & feasible)[:, None] & (ks < n_active[:, None])
            free_end, acc_sum, proc, miss, npu_s = _audit_scan(
                head=head, n_frames=n_frames, arrivals=arrivals, deadline=deadline, t_npu64=t_npu64,
                acc_stat=acc_stat, picks=picks, gate=gate, free0=npu_free.clamp_min(0.0),
                acc_sum=acc_sum, proc=proc, miss=miss, npu_s=npu_s, strict=strict)
            # Infeasible window: the reference emits a horizon-1 SKIP round
            # that leaves the NPU carry untouched.
            busy_until = torch.where(feasible, free_end, npu_free)
            horizon = torch.where(feasible, n_active, 1)
            head = torch.where(active, head + horizon, head)
            busy = torch.where(active, t0 + busy_until, busy)
            rounds = rounds + active.long()
            return head, busy, acc_sum, npu_s, proc, miss, rounds

        state, record = run.drive(W, step, _init_state(run, c.B, 3, 2), n_frames)
        _, _, acc_sum, npu_s, proc, miss, rounds = state
        out = run.read(record, acc_sum, proc, miss, rounds, npu_s)
        return _collect(c, out, time.perf_counter() - t_start)

    return _stitch(scenarios, lambda s: quant_w(_window_frames(s.stream, s.params)), run_group)


# ---------------------------------------------------------------------------
# jax_utility: Max-Utility Pareto-front DP (skips allowed).
# ---------------------------------------------------------------------------


@_planner("jax_utility")
def _run_utility(models, scenarios, strict, run: _Run):
    # ``width`` is a front shape, so it joins the group key.
    def run_group(key, group):
        W, width = key
        c = _common(models, group, W)
        alpha = np.array([float(s.params["alpha"]) for s in group], np.float64)
        # The f32 casts the one-stream wrapper performs, in bulk.
        window = np.maximum(c.n_active.astype(np.float64) * c.gamma, c.gamma)
        t_start = time.perf_counter()
        P = run.put
        gamma, deadline, n_active, n_frames = P(c.gamma), P(c.deadline), P(c.n_active), P(c.n_frames)
        g32, d32 = P(c.gamma.astype(np.float32)), P(c.deadline.astype(np.float32))
        a32, w32 = P(alpha.astype(np.float32)), P(window.astype(np.float32))
        zero32 = run.zeros(c.B, torch.float32)
        arrivals, acc_stat = P(c.arrivals), P(c.acc_stat64)
        t_npu64, t_npu32, acc32 = P(c.t_npu64), P(c.t_npu64.astype(np.float32)), P(c.acc_dp32)

        def step(state):
            head, busy, acc_sum, npu_s, proc, miss, rounds = state
            active = head < n_frames
            t0 = head.double() * gamma
            npu_free = torch.clamp_min(busy - t0, 0.0)
            (_, u, _, _), parents, actions = _utility_dp(
                t_npu32, acc32, n_active, width=width, gamma=g32, deadline=d32, alpha=a32,
                npu_free=npu_free.float(), first_arrival=zero32, window=w32, n_frames=W)
            picks = _backtrack_slots(parents, actions, u)
            gate = active[:, None] & (picks >= 0)  # only picked frames execute; rest SKIP
            free_end, acc_sum, proc, miss, npu_s = _audit_scan(
                head=head, n_frames=n_frames, arrivals=arrivals, deadline=deadline, t_npu64=t_npu64,
                acc_stat=acc_stat, picks=picks, gate=gate, free0=npu_free.clamp_min(0.0),
                acc_sum=acc_sum, proc=proc, miss=miss, npu_s=npu_s, strict=strict)
            head = torch.where(active, head + n_active, head)  # horizon is always n
            busy = torch.where(active, t0 + free_end, busy)
            rounds = rounds + active.long()
            return head, busy, acc_sum, npu_s, proc, miss, rounds

        state, record = run.drive(key, step, _init_state(run, c.B, 3, 2), n_frames)
        _, _, acc_sum, npu_s, proc, miss, rounds = state
        out = run.read(record, acc_sum, proc, miss, rounds, npu_s)
        return _collect(c, out, time.perf_counter() - t_start)

    return _stitch(
        scenarios,
        lambda s: (quant_w(_window_frames(s.stream, s.params)), int(s.params["width"])),
        run_group,
    )


# ---------------------------------------------------------------------------
# Network-aware planners: the paper's Max-Accuracy / Max-Utility heuristics.
# Each round is the reference plan_round as tensor expressions — bandwidth
# looked up at the round's start time, per-resolution upload times,
# feasible-server-model argmax, the f64 local-phase DP twins, and candidate
# selection on the reference's normalized scores — followed by the shared
# audit fold.  Both of a round's DP instances run as one DP over 2B lanes.
# ---------------------------------------------------------------------------

# max_utility._prune's cap: the width at which _utility_dp64's truncation
# coincides with the reference.  The planner first runs a narrow FAST width
# (real fronts hold a few dozen entries) and reruns only the lanes whose
# flag reports a front outgrew it, or a 1e-12 utility tie its fast keep rule
# cannot settle — exactness is never traded for speed.
_UTIL_CAP = 256
_UTIL_FAST_WIDTH = 64


def _trace_bw(bw_t: torch.Tensor, bw_v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Bandwidth [B] at times ``t`` [B]: the step function
    ``Trace.piecewise`` defines — the last segment with ``t_start <= t``
    wins, and before the first segment's start the first value applies.
    Padded sentinel segments carry ``t_start = +inf``, which a right
    bisection of a finite ``t`` can never select."""
    idx = torch.searchsorted(bw_t, t[:, None], right=True) - 1
    return bw_v.gather(1, idx.clamp(0, bw_t.shape[1] - 1))[:, 0]


def segment_arrays(segs_list: Sequence[Sequence[tuple[float, float]]]) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad per-scenario ``(t_start, bps)`` segment lists into [B, S] arrays:
    segments sort like ``Trace.piecewise``, S pads to the group's
    power-of-two maximum, and sentinel entries carry ``t_start = +inf`` with
    the last real value repeated."""
    B = len(segs_list)
    clean = [sorted((float(t), float(v)) for t, v in segs) or [(0.0, 0.0)] for segs in segs_list]
    S = quant_pow2(max(len(segs) for segs in clean))
    bw_t = np.full((B, S), np.inf, np.float64)
    bw_v = np.zeros((B, S), np.float64)
    for i, segs in enumerate(clean):
        bw_t[i, : len(segs)] = [t for t, _ in segs]
        bw_v[i, : len(segs)] = [v for _, v in segs]
        bw_v[i, len(segs):] = segs[-1][1]
    return bw_t, bw_v, S


def _offload_tables(models: list[ModelProfile], group: list[BatchScenario]) -> tuple[np.ndarray, np.ndarray]:
    """Frame payload bits [B, R] (the exact ``frame_bytes(r) * 8.0`` the
    reference feeds ``upload_time``) and server accuracy [B, J, R] at each
    scenario's offered resolutions."""
    nbits8 = np.array([[s.stream.frame_bytes(r) * 8.0 for r in s.stream.resolutions] for s in group],
                      np.float64)
    acc_sv = np.array(
        [[[m.accuracy(r, where="server") for r in s.stream.resolutions] for m in models] for s in group],
        np.float64)
    return nbits8, acc_sv


def _net_group_key(s: BatchScenario) -> tuple[int, int]:
    return (quant_w(_window_frames(s.stream, s.params)), len(s.stream.resolutions))


class _Net:
    """A group's network model and offload tables on the device."""

    def __init__(self, run: _Run, models, group):
        bw_t, bw_v, _ = segment_arrays([s.bw_segments for s in group])
        nbits8, acc_sv = _offload_tables(models, group)
        P = run.put
        self.rtt = P(np.array([s.rtt for s in group], np.float64))
        self.bw_t, self.bw_v = P(bw_t), P(bw_v)
        self.nbits8, self.acc_sv = P(nbits8), P(acc_sv)  # [B, R], [B, J, R]
        self.t_srv = P(np.array([m.t_server for m in models], np.float64))
        self.inf = torch.full((), float("inf"), dtype=torch.float64, device=run.device)

    def upload(self, t0: torch.Tensor) -> torch.Tensor:
        """Upload time [B, R] of each resolution at the bandwidth of ``t0``."""
        bw0 = _trace_bw(self.bw_t, self.bw_v, t0)[:, None]
        return torch.where(bw0 > 0.0, self.nbits8 / bw0, self.inf)

    def best_server(self, t_up: torch.Tensor, deadline: torch.Tensor):
        """The reference's per-resolution server choice: the first most
        accurate model that fits the budget.  Returns ``(j_best, a_best,
        r_ok)``, each [B, R]."""
        budget = (deadline[:, None] - t_up) - self.rtt[:, None]  # [B, R]
        fits = self.t_srv[None, :, None] <= budget[:, None, :]  # [B, J, R]
        a_cand = torch.where(fits, self.acc_sv, -self.inf)
        j_best = torch.argmax(a_cand, dim=1)  # first max
        a_best = a_cand.gather(1, j_best[:, None])[:, 0]
        return j_best, a_best, (budget > 0.0) & fits.any(dim=1)


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for [B, N] ``x`` and [B] ``idx``."""
    return x.gather(1, idx[:, None])[:, 0]


def _lanes2(x: torch.Tensor) -> torch.Tensor:
    """The same per-lane tensor for both DP instances of a round."""
    return torch.cat([x, x])


@_planner("max_accuracy")
def _run_max_accuracy(models, scenarios, strict, run: _Run):
    def run_group(key, group):
        W, _ = key
        c = _common(models, group, W)
        B = c.B
        grid = np.array([float(s.params["grid"]) for s in group], np.float64)
        # Bin arithmetic in f64 on the host — the same numpy expressions as
        # max_accuracy.local_dp, for both first_arrival values (0: the pure
        # local window; gamma: the frames buffered behind an offload).
        arr0 = np.ceil(c.arrivals / grid[:, None]).astype(np.int32)
        dl0 = np.floor((c.arrivals + c.deadline[:, None]) / grid[:, None]).astype(np.int32)
        arrivals1 = c.gamma[:, None] + c.arrivals
        arr1 = np.ceil(arrivals1 / grid[:, None]).astype(np.int32)
        dl1 = np.floor((arrivals1 + c.deadline[:, None]) / grid[:, None]).astype(np.int32)
        horizon_t = c.gamma + (c.n_active.astype(np.float64) - 1.0) * c.gamma + c.deadline
        NBINS = quant_bins(int((np.ceil(horizon_t / grid) + 2).max()))
        with np.errstate(invalid="ignore"):
            dur_f = np.ceil(c.t_npu64[None, :] / grid[:, None])
        dur = np.where(np.isfinite(dur_f), np.minimum(dur_f, NBINS), NBINS).astype(np.int32)
        t_start = time.perf_counter()
        P = run.put
        net = _Net(run, models, group)
        gamma, deadline, grid_t = P(c.gamma), P(c.deadline), P(grid)
        n_active, n_frames = P(c.n_active), P(c.n_frames)
        # Both DP instances as one over 2B lanes: local first, offload second.
        arr2, dl2 = P(np.concatenate([arr0, arr1])), P(np.concatenate([dl0, dl1]))
        dur2 = P(np.concatenate([dur, dur]))
        arrivals, acc_stat = P(c.arrivals), P(c.acc_stat64)
        t_npu64, acc_dp_t = P(c.t_npu64), P(c.acc_dp64)
        ks = torch.arange(W, device=run.device)
        lanes = torch.arange(B, device=run.device)
        neg = torch.full((), NEG, dtype=torch.float64, device=run.device)

        def step(state):
            head, busy, acc_sum, npu_s, proc, miss, offl, rounds = state
            active = head < n_frames
            t0 = _no_fma(head.double() * gamma)
            npu_free = torch.clamp_min(busy - t0, 0.0)
            start_bin = torch.ceil(npu_free.clamp_min(0.0) / grid_t).long()
            t_up = net.upload(t0)  # the reference's trace.at(t0)
            j_best, a_best, r_ok = net.best_server(t_up, deadline)
            n_l = torch.floor(torch.where(r_ok, t_up, 0.0) / gamma[:, None])
            n_l = n_l.clamp(0, W).long()  # [B, R]
            cho, par, mh, ab, alive = _accuracy_dp64(dur2, acc_dp_t, arr2, dl2, _lanes2(start_bin),
                                                     nbins=NBINS)
            mh0, mh1 = mh[:B], mh[B:]
            # The reference sizes each DP instance at ceil(horizon/grid)+2
            # bins and declares start_bin >= nbins infeasible; rebuild that
            # per-candidate bound from the shared prefix records.
            nlm1 = (n_l - 1).clamp(0, W - 1)
            nb1 = torch.ceil(((gamma[:, None] + _no_fma((n_l.double() - 1.0) * gamma[:, None]))
                              + deadline[:, None]) / grid_t[:, None]).long() + 2
            dp_ok = torch.where(n_l == 0, True, alive[B:].gather(1, nlm1) & (start_bin[:, None] < nb1))
            dp_tot = torch.where(n_l == 0, 0.0, mh1.gather(1, nlm1))
            feas = r_ok & dp_ok
            norm = torch.where(feas, (a_best + dp_tot) / (n_l + 1).double(), neg)
            r_star = torch.argmax(norm, dim=1)  # first max = lowest r
            off_exists = _pick(feas, r_star)
            off_norm = _pick(norm, r_star)
            # local_window_plan tries nn = n..1 and keeps the first feasible;
            # aliveness is prefix-monotone, so that is the leading-alive
            # count (and the start_bin bound only loosens as nn grows).
            A = (alive[:B] & (ks < n_active[:, None])).sum(dim=1)
            nb0 = torch.ceil((_no_fma((A.double() - 1.0) * gamma) + deadline) / grid_t).long() + 2
            loc_exists = (A >= 1) & (start_bin < nb0)
            a_last = (A - 1).clamp(0, W - 1)
            loc_norm = torch.where(loc_exists, _pick(mh0, a_last) / A.double(), neg)
            use_loc = loc_exists & (loc_norm > torch.where(off_exists, off_norm, neg))
            use_off = off_exists & ~use_loc
            n_off = _pick(n_l, r_star)
            nn = torch.where(use_off, n_off, torch.where(use_loc, A, 0))
            # Backtrack both DPs at once: the local lanes from their last
            # alive frame, the offload lanes from frame n_l(r*) - 1.
            b0 = torch.cat([_pick(ab[:B], a_last), _pick(ab[B:], _pick(nlm1, r_star))])
            upto = torch.cat([torch.where(use_loc, nn, 0), torch.where(use_off, nn, 0)])
            picks2 = _backtrack_bins(cho, par, b0, upto)
            picks = torch.where(use_off[:, None], picks2[B:], picks2[:B])

            # Head-frame offload first: decision order is SERVER, then NPUs.
            j_srv = _pick(j_best, r_star)
            srv_fin = (_pick(t_up, r_star) + net.rtt) + net.t_srv[j_srv]
            if strict:
                srv_bad = use_off & (srv_fin > deadline + AUDIT_TOL)
            else:
                srv_bad = torch.zeros_like(use_off)
            srv_take = active & use_off & ~srv_bad
            acc_sum = acc_sum + torch.where(srv_take, net.acc_sv[lanes, j_srv, r_star], 0.0)
            proc = proc + srv_take.long()
            offl = offl + srv_take.long()
            miss = miss + (active & srv_bad).long()

            fa = torch.where(use_off, gamma, 0.0)
            gate = (active[:, None] & (picks >= 0)) & (ks < nn[:, None])
            free_end, acc_sum, proc, miss, npu_s = _audit_scan(
                head=head, frame_offset=use_off.long(), n_frames=n_frames, arrivals=fa[:, None] + arrivals,
                deadline=deadline, t_npu64=t_npu64, acc_stat=acc_stat, picks=picks, gate=gate,
                free0=npu_free.clamp_min(0.0), acc_sum=acc_sum, proc=proc, miss=miss, npu_s=npu_s,
                strict=strict)
            busy_until = torch.where(use_off | use_loc, free_end, npu_free)
            horizon = torch.where(use_off, n_off + 1, torch.where(use_loc, A, 1))
            head = torch.where(active, head + horizon, head)
            busy = torch.where(active, t0 + busy_until, busy)
            rounds = rounds + active.long()
            return head, busy, acc_sum, npu_s, proc, miss, offl, rounds

        state, record = run.drive(key, step, _init_state(run, B, 4, 2), n_frames)
        _, _, acc_sum, npu_s, proc, miss, offl, rounds = state
        out = run.read(record, acc_sum, proc, miss, rounds, npu_s, offl)
        return _collect(c, out[:5], time.perf_counter() - t_start, offloaded=out[5])

    return _stitch(scenarios, _net_group_key, run_group)


# ---------------------------------------------------------------------------
# Detect+track planners (tracking.py): no bin DP — candidate scoring is
# closed-form (fresh accuracy times a host-computed interval mean), so a
# round is a handful of tensor expressions plus a short sequential fold
# over the tracked frames.  One round function serves both policies;
# ``fixed`` selects track_fixed (raw accuracy scores, always ``k`` frames)
# or track_accuracy (interval-mean scores, the winner sets the horizon).
# Decay tables come from the host with the reference planners' own Python
# arithmetic, so every product on the device multiplies the same float64
# constants.
# ---------------------------------------------------------------------------


def _run_track(models, scenarios, strict, run: _Run, *, fixed: bool):
    kname = "k" if fixed else "k_max"

    def key_fn(s):
        # KQ bounds the horizon (and the tracked-frame fold length); A sizes
        # the retention table — ages reach n_frames with the -1 initial state.
        return (quant_w(int(s.params[kname])), len(s.stream.resolutions), quant_pow2(s.n_frames + 1))

    def run_group(key, group):
        KQ, R, A = key
        c = _common(models, group, W=1)  # windows are a classify concept
        B, J = c.B, c.J
        k_lim = np.array([int(s.params[kname]) for s in group], np.int32)
        im = np.zeros((B, KQ), np.float64)
        if not fixed:
            # interval_means is prefix-stable, so padding KQ past a lane's
            # k_max cannot change any entry the planner may select.
            for i, s in enumerate(group):
                im[i, :] = interval_means(retention(float(s.params["decay"]), float(s.params["density"])), KQ)
        ret_pow = np.empty((B, A), np.float64)
        for i, s in enumerate(group):
            ret_pow[i, :] = retention_powers(s.workload.retention, A)
        t_start = time.perf_counter()
        P = run.put
        net = _Net(run, models, group)
        gamma, deadline, n_frames = P(c.gamma), P(c.deadline), P(c.n_frames)
        k_lim_t, im_t, ret_t = P(k_lim), P(im), P(ret_pow)
        acc_stat, t_npu64 = P(c.acc_stat64), P(c.t_npu64)
        inf = net.inf
        local = torch.isfinite(t_npu64)[None, :]  # [1, J]

        def step(state):
            head, busy, det_acc, acc_sum, npu_s, det_frm, proc, miss, offl, rounds = state
            active = head < n_frames
            t0 = _no_fma(head.double() * gamma)
            npu_free = torch.clamp_min(busy - t0, 0.0)
            # NPU candidates: j ascending (the concatenation order below).
            kf = torch.where(local, torch.ceil(t_npu64[None, :] / gamma[:, None]), 0.0)
            k_npu = torch.clamp_min(kf.long(), 1)  # [B, J] npu_interval
            feas_npu = local & ((npu_free[:, None] + t_npu64) <= deadline[:, None]) & (k_npu <= k_lim_t[:, None])
            # Offload candidates: the reference's _server_candidates, r asc.
            t_up = net.upload(t0)
            j_best, a_best, r_ok = net.best_server(t_up, deadline)
            k_srv = torch.floor(torch.where(r_ok, t_up, 0.0) / gamma[:, None]).long() + 1
            feas_srv = r_ok & (k_srv <= k_lim_t[:, None])
            if fixed:
                s_npu = torch.where(feas_npu, acc_stat, -inf)
                s_srv = torch.where(feas_srv, a_best, -inf)
            else:
                s_npu = torch.where(feas_npu, acc_stat * im_t.gather(1, (k_npu - 1).clamp(0, KQ - 1)), -inf)
                s_srv = torch.where(feas_srv, a_best * im_t.gather(1, (k_srv - 1).clamp(0, KQ - 1)), -inf)
            # NPU-then-server candidate order with strict > first-wins is a
            # first-maximum argmax over the concatenation (real scores are
            # >= 0, so -inf marks infeasible unambiguously).
            scores = torch.cat([s_npu, s_srv], dim=1)
            idx = torch.argmax(scores, dim=1)
            exists = _pick(scores, idx) > -inf
            det_npu = exists & (idx < J)
            j_pick = idx.clamp(0, J - 1)
            r_pick = (idx - J).clamp(0, R - 1)
            d_acc = torch.where(det_npu, _pick(acc_stat, j_pick), _pick(a_best, r_pick))
            k_det = torch.where(det_npu, _pick(k_npu, j_pick), _pick(k_srv, r_pick))
            horizon = k_lim_t if fixed else torch.where(exists, k_det, 1)  # fixed: consumed even on SKIP
            fin_npu = npu_free + t_npu64[j_pick]
            fin_srv = (_pick(t_up, r_pick) + net.rtt) + net.t_srv[_pick(j_best, r_pick)]
            fin = torch.where(det_npu, fin_npu, fin_srv)
            if strict:
                bad = exists & (fin > deadline + AUDIT_TOL)
            else:
                bad = torch.zeros_like(exists)
            # Detection first (audit order), then tracked frames ascending.
            take = active & exists & ~bad
            acc_sum = acc_sum + torch.where(take, d_acc, 0.0)
            proc = proc + take.long()
            offl = offl + (take & ~det_npu).long()
            miss = miss + (active & bad).long()
            det_acc = torch.where(take, d_acc, det_acc)
            det_frm = torch.where(take, head, det_frm)
            off0 = exists.long()  # SKIP tracks the head frame too
            for o in range(KQ):
                on = active & (o >= off0) & (o < horizon) & ((head + o) < n_frames)
                age = (head + o - det_frm).clamp(0, A - 1)
                v = _no_fma(det_acc * ret_t.gather(1, age[:, None])[:, 0])
                acc_sum = acc_sum + torch.where(on, v, 0.0)
                proc = proc + on.long()
            npu_s = npu_s + torch.where(active & det_npu, t_npu64[j_pick], 0.0)
            busy_until = torch.where(det_npu, fin_npu, npu_free)
            head = torch.where(active, head + horizon, head)
            busy = torch.where(active, t0 + busy_until, busy)
            rounds = rounds + active.long()
            return head, busy, det_acc, acc_sum, npu_s, det_frm, proc, miss, offl, rounds

        init = _init_state(run, B, 5, 3)
        init = init[:5] + (torch.full((B,), -1, dtype=torch.int64, device=run.device),) + init[6:]
        state, record = run.drive(key, step, init, n_frames)
        acc_sum, npu_s, proc, miss, offl, rounds = state[3], state[4], *state[6:]
        out = run.read(record, acc_sum, proc, miss, rounds, npu_s, offl)
        return _collect(c, out[:5], time.perf_counter() - t_start, offloaded=out[5])

    return _stitch(scenarios, key_fn, run_group)


@_planner("track_accuracy")
def _run_track_accuracy(models, scenarios, strict, run: _Run):
    return _run_track(models, scenarios, strict, run, fixed=False)


@_planner("track_fixed")
def _run_track_fixed(models, scenarios, strict, run: _Run):
    return _run_track(models, scenarios, strict, run, fixed=True)


# ---------------------------------------------------------------------------
# max_utility
# ---------------------------------------------------------------------------


def _max_utility_lanes(run: _Run, key, models: list[ModelProfile], group: list[BatchScenario], *,
                       width: int, exact: bool, strict: bool):
    """Run max_utility over ``group`` (one shape group, or its lanes to
    rerun) to the end at front ``width``; returns ``(common, state,
    record)``."""
    c = _common(models, group, key[0])
    P = run.put
    net = _Net(run, models, group)
    gamma, deadline, n_w, n_frames = P(c.gamma), P(c.deadline), P(c.n_active), P(c.n_frames)
    alpha = P(np.array([float(s.params["alpha"]) for s in group], np.float64))
    fps = P(np.array([s.stream.fps for s in group], np.float64))
    arrivals, acc_stat, t_npu64, acc_dp = P(c.arrivals), P(c.acc_stat64), P(c.t_npu64), P(c.acc_dp64)
    rtt, acc_sv, t_srv = net.rtt, net.acc_sv, net.t_srv
    B, W, J = c.B, c.W, c.J
    ks = torch.arange(W, device=run.device)
    lanes = torch.arange(B, device=run.device)
    inf = net.inf
    neg = torch.full((), NEG, dtype=torch.float64, device=run.device)
    ones = torch.ones((), dtype=torch.float64, device=run.device)

    def step(state):
        head, busy, acc_sum, npu_s, proc, miss, offl, rounds, ovf = state
        active = head < n_frames
        t0 = _no_fma(head.double() * gamma)
        npu_free = torch.clamp_min(busy - t0, 0.0)
        t_up = net.upload(t0)  # [B, R]
        R = t_up.shape[1]
        # Offload phase: argmax_{r,j} capped-rate + alpha * a(j, r); the
        # reference iterates r-outer/j-inner with strict >, so the first
        # maximum over the r-major flattening wins ties identically.
        feas = ((t_up[:, :, None] + t_srv) + rtt[:, None, None]) <= deadline[:, None, None]  # [B, R, J]
        rate = torch.minimum(ones / torch.clamp_min(t_up, 1e-9), fps[:, None])
        score = rate[:, :, None] + _no_fma(alpha[:, None, None] * acc_sv.transpose(1, 2))
        flat = torch.where(feas, score, -inf).reshape(B, R * J)
        off_exists = feas.reshape(B, -1).any(dim=1)
        pick_rj = torch.argmax(flat, dim=1)
        r0 = pick_rj // J
        j0 = pick_rj - r0 * J
        t_up0 = torch.where(off_exists, _pick(t_up, r0), 0.0)
        n_l = torch.floor(t_up0 / gamma).clamp(0, W).long()
        n_plan = torch.maximum(n_l, n_w - 1)
        win1 = torch.maximum(n_plan.clamp_min(1).double() * gamma, gamma)
        win2 = torch.maximum(n_w.double() * gamma, gamma)
        # Both DP instances as one over 2B lanes: offload first, local second.
        (_, u, _, _), par, act, flag = _utility_dp64(
            t_npu64, acc_dp, torch.cat([n_plan, n_w]), width=width, gamma=_lanes2(gamma),
            deadline=_lanes2(deadline), alpha=_lanes2(alpha), npu_free=_lanes2(npu_free),
            first_arrival=torch.cat([gamma, torch.zeros_like(gamma)]), window=torch.cat([win1, win2]),
            n_frames=W, exact=exact)
        ovf = ovf | (active & (flag[:B] | flag[B:]))
        picks2 = _backtrack_slots(par, act, u)
        srv_acc = acc_sv[lanes, j0, r0]
        # _round_utility's decision-order f64 fold; the head offload's server
        # accuracy seeds the offload lanes so the summation order matches.
        n12 = torch.zeros(2 * B, dtype=torch.int64, device=run.device)
        a12 = torch.cat([srv_acc, torch.zeros_like(srv_acc)])
        acc_stat2 = _lanes2(acc_stat)
        for k in range(W):
            pick = picks2[:, k]
            takes = pick >= 0
            n12 = n12 + takes.long()
            a12 = a12 + torch.where(takes, acc_stat2.gather(1, pick.clamp(0, J - 1)[:, None])[:, 0], 0.0)
        n1, n2, a_off, a_loc = n12[:B], n12[B:], a12[:B], a12[B:]
        # The true round objective (_round_utility) for both candidates.
        p_off = (n1 + 1).double()
        h_off = (n_plan + 1).clamp_min(1).double()
        u_off = torch.where(off_exists, p_off / (h_off * gamma) + (alpha * a_off) / p_off, neg)
        n2f = n2.double()
        u_loc = torch.where(n2 > 0, n2f / (n_w.double() * gamma) + (alpha * a_loc) / n2f, 0.0)
        use_off = off_exists & (u_off >= u_loc)  # first candidate wins ties
        use_loc = ~use_off & (n2 > 0)
        nn = torch.where(use_off, n_plan, torch.where(use_loc, n_w, 0))
        picks = torch.where(use_off[:, None], picks2[:B], picks2[B:])
        srv_fin = (t_up0 + rtt) + t_srv[j0.clamp(0, J - 1)]
        if strict:
            srv_bad = use_off & (srv_fin > deadline + AUDIT_TOL)
        else:
            srv_bad = torch.zeros_like(use_off)
        srv_take = active & use_off & ~srv_bad
        acc_sum = acc_sum + torch.where(srv_take, srv_acc, 0.0)
        proc = proc + srv_take.long()
        offl = offl + srv_take.long()
        miss = miss + (active & srv_bad).long()

        fa = torch.where(use_off, gamma, 0.0)
        gate = (active[:, None] & (picks >= 0)) & (ks < nn[:, None])
        free_end, acc_sum, proc, miss, npu_s = _audit_scan(
            head=head, frame_offset=use_off.long(), n_frames=n_frames, arrivals=fa[:, None] + arrivals,
            deadline=deadline, t_npu64=t_npu64, acc_stat=acc_stat, picks=picks, gate=gate,
            free0=npu_free.clamp_min(0.0), acc_sum=acc_sum, proc=proc, miss=miss, npu_s=npu_s,
            strict=strict)
        busy_until = torch.where(use_off | use_loc, free_end, npu_free)
        horizon = torch.where(use_off, n_plan + 1, torch.where(use_loc, n_w, 1))
        head = torch.where(active, head + horizon, head)
        busy = torch.where(active, t0 + busy_until, busy)
        rounds = rounds + active.long()
        return head, busy, acc_sum, npu_s, proc, miss, offl, rounds, ovf

    init = _init_state(run, B, 4, 2) + (torch.zeros(B, dtype=torch.bool, device=run.device),)
    return (c, *run.drive(key, step, init, n_frames))


@_planner("max_utility")
def _run_max_utility(models, scenarios, strict, run: _Run):
    def run_group(key, group):
        t_start = time.perf_counter()
        c, state, record = _max_utility_lanes(run, key, models, group, width=_UTIL_FAST_WIDTH, exact=False,
                                              strict=strict)
        _, _, acc_sum, npu_s, proc, miss, offl, rounds, ovf = state
        out = run.read(record, acc_sum, proc, miss, rounds, npu_s, offl, ovf)
        flagged = np.nonzero(out[6])[0]
        if flagged.size:
            # A front outgrew the fast width, or two utilities met within the
            # epsilon, somewhere in these lanes: rerun just them at the
            # reference prune cap with the exact keep rule (exact for any
            # front) and splice their results back in.
            _, sub, sub_record = _max_utility_lanes(run, key, models, [group[i] for i in flagged],
                                                    width=_UTIL_CAP, exact=True, strict=strict)
            _, _, acc_sum, npu_s, proc, miss, offl, rounds, _ = sub
            sub_out = run.read(sub_record, acc_sum, proc, miss, rounds, npu_s, offl)
            for dst, src in zip(out[:6], sub_out):
                dst[flagged] = src
            record["reruns"] = sub_record["reruns"] = int(flagged.size)
        return _collect(c, out[:5], time.perf_counter() - t_start, offloaded=out[5])

    return _stitch(scenarios, _net_group_key, run_group)
