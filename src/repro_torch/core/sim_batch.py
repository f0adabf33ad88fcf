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
its termination test, and one more per group for the results.  Each group
runs as a :class:`~repro_torch.core.sweep_shard.LaneProgram`: on the card
its round is captured once as a CUDA graph and replayed, so a round's
thousand-odd small ops cost their device time, not their issue, and the
program is kept for later groups of the same shape (later chunks, later
sweeps).

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
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import sweep_shard
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

    def drive(self, key: Any, lanes: Mapping[str, Any], shared: Mapping[str, Any], build,
              statics: tuple = ()) -> tuple[tuple, dict]:
        """Run one shape group to the end: its lane program (built by
        ``build``, or taken from :data:`~repro_torch.core.sweep_shard.PROGRAMS`
        with this group's ``lanes`` and ``shared`` inputs loaded into it) runs
        rounds until no lane is active, over this rank's share of the lanes
        where a sweep mesh spans several ranks (``sweep_shard.run_sharded``).
        ``statics`` are the values other than ``key`` that the step reads as
        Python numbers.  Returns the final state (padded lanes included) and
        the group's record."""
        record = {"policy": self.policy, "key": key, "statics": list(statics), "lanes": len(lanes["n_frames"]),
                  "rounds": 0, "host_reads": 0, "reruns": 0}
        self.groups.append(record)
        state = sweep_shard.run_sharded((self.policy, key, statics), self.device, lanes, shared, build, record)
        return state, record

    @staticmethod
    def read(record: dict, *parts: torch.Tensor) -> list[np.ndarray]:
        """The group's results for its real lanes in one copy to the host
        (integers below 2^53 travel exactly as float64), gathered from every
        rank over a sweep mesh (``sweep_shard.gather``)."""
        host = torch.stack([p.to(torch.float64) for p in parts]).cpu().numpy()
        return list(sweep_shard.gather(record, host, axis=1))


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


def _init_state(b, n_int: int, n_float: int) -> tuple:
    """Round-loop state of a program's ``b.B`` lanes: ``head`` (int64) and
    ``busy`` (f64), then ``n_float`` float64 and ``n_int`` int64 zeros."""
    def zeros(dtype):
        return torch.zeros(b.B, dtype=dtype, device=b.device)

    return ((zeros(torch.int64), zeros(torch.float64))
            + tuple(zeros(torch.float64) for _ in range(n_float))
            + tuple(zeros(torch.int64) for _ in range(n_int)))


# ---------------------------------------------------------------------------
# jax_accuracy: Max-Accuracy local DP over a (padded) time-bin grid.
# ---------------------------------------------------------------------------


def _jax_accuracy_step(b, W: int, NBINS: int, strict: bool):
    """jax_accuracy's round over a program's buffers: ``step(state)`` on the
    state ``(head, busy, acc_sum, npu_s, proc, miss, rounds)``."""
    ks = torch.arange(W, device=b.device)

    def step(state):
        head, busy, acc_sum, npu_s, proc, miss, rounds = state
        active = head < b.n_frames
        t0 = head.double() * b.gamma
        npu_free = torch.clamp_min(busy - t0, 0.0)
        # Reference: int(np.ceil(max(npu_free, 0.0) / grid)), clipped
        # to the scenario's REAL bin count (not the padded one).
        start_bin = torch.ceil(npu_free.clamp_min(0.0) / b.grid).long()
        start_bin = torch.minimum(start_bin.clamp_min(0), b.nbins_r - 1)
        H, choices, parents = _accuracy_dp(b.dur, b.acc32, b.arr, b.dl, start_bin, b.n_active, nbins=NBINS)
        feasible = H.amax(dim=1) > NEG / 2
        picks = _backtrack_bins(choices, parents, torch.argmax(H, dim=1))
        gate = (active & feasible)[:, None] & (ks < b.n_active[:, None])
        free_end, acc_sum, proc, miss, npu_s = _audit_scan(
            head=head, n_frames=b.n_frames, arrivals=b.arrivals, deadline=b.deadline,
            t_npu64=b.t_npu64, acc_stat=b.acc_stat, picks=picks, gate=gate,
            free0=npu_free.clamp_min(0.0), acc_sum=acc_sum, proc=proc, miss=miss, npu_s=npu_s,
            strict=strict)
        # Infeasible window: the reference emits a horizon-1 SKIP round that
        # leaves the NPU carry untouched.
        busy_until = torch.where(feasible, free_end, npu_free)
        horizon = torch.where(feasible, b.n_active, 1)
        head = torch.where(active, head + horizon, head)
        busy = torch.where(active, t0 + busy_until, busy)
        rounds = rounds + active.long()
        return head, busy, acc_sum, npu_s, proc, miss, rounds

    return step


def _jax_accuracy_inputs(c: _Common, group) -> tuple[dict, int]:
    """jax_accuracy's per-lane inputs and the group's bin count.  Bin
    arithmetic in f64 on the host — the same numpy expressions as
    local_accuracy_dp_jax, over the group."""
    grid = np.array([float(s.params["grid"]) for s in group], np.float64)
    arr_bins = np.ceil(c.arrivals / grid[:, None]).astype(np.int32)
    dl_bins = np.floor((c.arrivals + c.deadline[:, None]) / grid[:, None]).astype(np.int32)
    horizon_t = (c.n_active.astype(np.float64) - 1.0) * c.gamma + c.deadline
    nbins_real = (np.ceil(horizon_t / grid) + 2).astype(np.int32)
    NBINS = quant_bins(int(nbins_real.max()))
    # inf (server-only) and over-horizon durations clamp to NBINS: both are
    # unreachable in-bin exactly as the reference's raw values are.
    with np.errstate(invalid="ignore"):
        dur_f = np.ceil(c.t_npu64[None, :] / grid[:, None])
    dur = np.where(np.isfinite(dur_f), np.minimum(dur_f, NBINS), NBINS).astype(np.int32)
    return dict(gamma=c.gamma, deadline=c.deadline, grid=grid, n_active=c.n_active, nbins_r=nbins_real,
                n_frames=c.n_frames, arr=arr_bins, dl=dl_bins, dur=dur, arrivals=c.arrivals,
                acc_stat=c.acc_stat64), NBINS


@_planner("jax_accuracy")
def _run_accuracy(models, scenarios, strict, run: _Run):
    def run_group(W, group):
        c = _common(models, group, W)
        lanes, NBINS = _jax_accuracy_inputs(c, group)
        t_start = time.perf_counter()

        def build(b):
            return _jax_accuracy_step(b, W, NBINS, strict), lambda: _init_state(b, 3, 2)

        state, record = run.drive(W, lanes, dict(t_npu64=c.t_npu64, acc32=c.acc_dp32), build,
                                  statics=(NBINS, strict))
        _, _, acc_sum, npu_s, proc, miss, rounds = state
        out = run.read(record, acc_sum, proc, miss, rounds, npu_s)
        return _collect(c, out, time.perf_counter() - t_start)

    return _stitch(scenarios, lambda s: quant_w(_window_frames(s.stream, s.params)), run_group)


# ---------------------------------------------------------------------------
# jax_utility: Max-Utility Pareto-front DP (skips allowed).
# ---------------------------------------------------------------------------


def _jax_utility_step(b, W: int, width: int, strict: bool):
    """jax_utility's round over a program's buffers, on the state of
    :func:`_jax_accuracy_step`."""
    zero32 = torch.zeros(b.B, dtype=torch.float32, device=b.device)

    def step(state):
        head, busy, acc_sum, npu_s, proc, miss, rounds = state
        active = head < b.n_frames
        t0 = head.double() * b.gamma
        npu_free = torch.clamp_min(busy - t0, 0.0)
        (_, u, _, _), parents, actions = _utility_dp(
            b.t_npu32, b.acc32, b.n_active, width=width, gamma=b.g32, deadline=b.d32, alpha=b.a32,
            npu_free=npu_free.float(), first_arrival=zero32, window=b.w32, n_frames=W)
        picks = _backtrack_slots(parents, actions, u)
        gate = active[:, None] & (picks >= 0)  # only picked frames execute; rest SKIP
        free_end, acc_sum, proc, miss, npu_s = _audit_scan(
            head=head, n_frames=b.n_frames, arrivals=b.arrivals, deadline=b.deadline,
            t_npu64=b.t_npu64, acc_stat=b.acc_stat, picks=picks, gate=gate,
            free0=npu_free.clamp_min(0.0), acc_sum=acc_sum, proc=proc, miss=miss, npu_s=npu_s,
            strict=strict)
        head = torch.where(active, head + b.n_active, head)  # horizon is always n
        busy = torch.where(active, t0 + free_end, busy)
        rounds = rounds + active.long()
        return head, busy, acc_sum, npu_s, proc, miss, rounds

    return step


def _jax_utility_inputs(c: _Common, group) -> dict[str, np.ndarray]:
    """jax_utility's per-lane inputs: the f32 casts the one-stream wrapper
    performs, in bulk."""
    alpha = np.array([float(s.params["alpha"]) for s in group], np.float64)
    window = np.maximum(c.n_active.astype(np.float64) * c.gamma, c.gamma)
    return dict(gamma=c.gamma, deadline=c.deadline, n_active=c.n_active, n_frames=c.n_frames,
                g32=c.gamma.astype(np.float32), d32=c.deadline.astype(np.float32),
                a32=alpha.astype(np.float32), w32=window.astype(np.float32), arrivals=c.arrivals,
                acc_stat=c.acc_stat64)


def _jax_utility_shared(c: _Common) -> dict[str, np.ndarray]:
    return dict(t_npu64=c.t_npu64, t_npu32=c.t_npu64.astype(np.float32), acc32=c.acc_dp32)


@_planner("jax_utility")
def _run_utility(models, scenarios, strict, run: _Run):
    # ``width`` is a front shape, so it joins the group key.
    def run_group(key, group):
        W, width = key
        c = _common(models, group, W)
        t_start = time.perf_counter()

        def build(b):
            return _jax_utility_step(b, W, width, strict), lambda: _init_state(b, 3, 2)

        state, record = run.drive(key, _jax_utility_inputs(c, group), _jax_utility_shared(c), build,
                                  statics=(strict,))
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


def _net_lanes(models, group) -> dict[str, np.ndarray]:
    """A group's network model and offload tables, per lane: rtt, the padded
    bandwidth segments, frame payload bits [B, R] and server accuracy
    [B, J, R]."""
    bw_t, bw_v, _ = segment_arrays([s.bw_segments for s in group])
    nbits8, acc_sv = _offload_tables(models, group)
    return dict(rtt=np.array([s.rtt for s in group], np.float64), bw_t=bw_t, bw_v=bw_v, nbits8=nbits8,
                acc_sv=acc_sv)


class _Net:
    """A program's network model and offload tables (its buffers)."""

    def __init__(self, b):
        self.bw_t, self.bw_v, self.nbits8, self.acc_sv, self.t_srv = b.bw_t, b.bw_v, b.nbits8, b.acc_sv, b.t_srv
        self.inf = torch.full((), float("inf"), dtype=torch.float64, device=b.device)

    def bandwidth(self, t: torch.Tensor) -> torch.Tensor:
        """The true bandwidth [B] at times ``t`` (the reference's ``trace.at``)."""
        return _trace_bw(self.bw_t, self.bw_v, t)

    def upload(self, bw: torch.Tensor) -> torch.Tensor:
        """Upload time [B, R] of each resolution at bandwidth ``bw`` [B]."""
        bw = bw[:, None]
        return torch.where(bw > 0.0, self.nbits8 / bw, self.inf)

    def best_server(self, t_up: torch.Tensor, deadline: torch.Tensor, rtt: torch.Tensor):
        """The reference's per-resolution server choice under round trip
        ``rtt`` [B]: the first most accurate model that fits the budget.
        Returns ``(j_best, a_best, r_ok)``, each [B, R]."""
        budget = (deadline[:, None] - t_up) - rtt[:, None]  # [B, R]
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


class _Plan(NamedTuple):
    """A network-aware round's decision, per lane: offload the head frame
    (at resolution ``r_off`` to server model ``j_off``, upload ``t_up_off``,
    server accuracy ``srv_acc``) and/or run ``picks`` on the NPU for the
    first ``nn`` frames of the window; ``horizon`` frames are consumed.
    ``ovf`` flags a Max-Utility front that outgrew its width."""

    use_off: torch.Tensor
    use_loc: torch.Tensor
    r_off: torch.Tensor
    j_off: torch.Tensor
    t_up_off: torch.Tensor
    srv_acc: torch.Tensor
    picks: torch.Tensor
    nn: torch.Tensor
    horizon: torch.Tensor
    ovf: torch.Tensor | None = None


def _accuracy_choice(net: _Net, W: int, *, gamma, deadline, grid_t, n_active, start_bin, t_up, rtt, local, offload):
    """Max-Accuracy's candidate selection for [B] lanes, from the upload
    times [B, R] and round trip [B] the planner believes and the prefix
    records ``(maxH, argb, alive)`` [B, W] of its two DP instances: ``local``
    (first arrival 0) and ``offload`` (the frames buffered behind a head
    offload).  Returns ``(use_off, use_loc, r_star, j_srv, nn, horizon,
    b0_loc, b0_off)``: the choice, the offload's resolution and server
    model, the NPU frame count, the frames consumed, and each DP's
    backtrack start bin."""
    mh0, ab0, alive0 = local
    mh1, ab1, alive1 = offload
    neg = torch.full((), NEG, dtype=torch.float64, device=t_up.device)
    ks = torch.arange(W, device=t_up.device)
    j_best, a_best, r_ok = net.best_server(t_up, deadline, rtt)
    n_l = torch.floor(torch.where(r_ok, t_up, 0.0) / gamma[:, None])
    n_l = n_l.clamp(0, W).long()  # [B, R]
    # The reference sizes each DP instance at ceil(horizon/grid)+2 bins and
    # declares start_bin >= nbins infeasible; rebuild that per-candidate
    # bound from the shared prefix records.
    nlm1 = (n_l - 1).clamp(0, W - 1)
    nb1 = torch.ceil(((gamma[:, None] + _no_fma((n_l.double() - 1.0) * gamma[:, None]))
                      + deadline[:, None]) / grid_t[:, None]).long() + 2
    dp_ok = torch.where(n_l == 0, True, alive1.gather(1, nlm1) & (start_bin[:, None] < nb1))
    dp_tot = torch.where(n_l == 0, 0.0, mh1.gather(1, nlm1))
    feas = r_ok & dp_ok
    norm = torch.where(feas, (a_best + dp_tot) / (n_l + 1).double(), neg)
    r_star = torch.argmax(norm, dim=1)  # first max = lowest r
    off_exists = _pick(feas, r_star)
    off_norm = _pick(norm, r_star)
    # local_window_plan tries nn = n..1 and keeps the first feasible;
    # aliveness is prefix-monotone, so that is the leading-alive count (and
    # the start_bin bound only loosens as nn grows).
    A = (alive0 & (ks < n_active[:, None])).sum(dim=1)
    nb0 = torch.ceil((_no_fma((A.double() - 1.0) * gamma) + deadline) / grid_t).long() + 2
    loc_exists = (A >= 1) & (start_bin < nb0)
    a_last = (A - 1).clamp(0, W - 1)
    loc_norm = torch.where(loc_exists, _pick(mh0, a_last) / A.double(), neg)
    use_loc = loc_exists & (loc_norm > torch.where(off_exists, off_norm, neg))
    use_off = off_exists & ~use_loc
    n_off = _pick(n_l, r_star)
    nn = torch.where(use_off, n_off, torch.where(use_loc, A, 0))
    horizon = torch.where(use_off, n_off + 1, torch.where(use_loc, A, 1))
    return (use_off, use_loc, r_star, _pick(j_best, r_star), nn, horizon, _pick(ab0, a_last),
            _pick(ab1, _pick(nlm1, r_star)))


def _accuracy_planner(b, W: int, NBINS: int):
    """Max-Accuracy's planning phase over a program's buffers:
    ``plan(npu_free, t_up, rtt) -> _Plan`` from the upload times [B, R] and
    the round trip [B] the planner believes (the trace and the true RTT in
    the sweep engine, the estimator's belief in the online engine)."""
    B = b.B
    net = _Net(b)
    lanes = torch.arange(B, device=b.device)

    def plan(npu_free, t_up, rtt):
        start_bin = torch.ceil(npu_free.clamp_min(0.0) / b.grid).long()
        # Both DP instances as one over 2B lanes: local first, offload second.
        cho, par, mh, ab, alive = _accuracy_dp64(
            torch.cat([b.dur, b.dur]), b.acc_dp, torch.cat([b.arr0, b.arr1]), torch.cat([b.dl0, b.dl1]),
            _lanes2(start_bin), nbins=NBINS)
        use_off, use_loc, r_star, j_srv, nn, horizon, b0_loc, b0_off = _accuracy_choice(
            net, W, gamma=b.gamma, deadline=b.deadline, grid_t=b.grid, n_active=b.n_active, start_bin=start_bin,
            t_up=t_up, rtt=rtt, local=(mh[:B], ab[:B], alive[:B]), offload=(mh[B:], ab[B:], alive[B:]))
        # Backtrack both DPs at once: the local lanes from their last alive
        # frame, the offload lanes from frame n_l(r*) - 1.
        upto = torch.cat([torch.where(use_loc, nn, 0), torch.where(use_off, nn, 0)])
        picks2 = _backtrack_bins(cho, par, torch.cat([b0_loc, b0_off]), upto)
        picks = torch.where(use_off[:, None], picks2[B:], picks2[:B])
        return _Plan(use_off, use_loc, r_star, j_srv, _pick(t_up, r_star), net.acc_sv[lanes, j_srv, r_star],
                     picks, nn, horizon)

    return plan


def _accuracy_bins(c: _Common, group, q: int = 128) -> tuple[dict, int]:
    """Max-Accuracy's bin inputs per lane and the group's bin count (padded
    to a multiple of ``q``).  Bin arithmetic in f64 on the host — the same
    numpy expressions as ``max_accuracy.local_dp``, for both first_arrival
    values (0: the pure local window; gamma: the frames buffered behind an
    offload)."""
    grid = np.array([float(s.params["grid"]) for s in group], np.float64)
    arr0 = np.ceil(c.arrivals / grid[:, None]).astype(np.int32)
    dl0 = np.floor((c.arrivals + c.deadline[:, None]) / grid[:, None]).astype(np.int32)
    arrivals1 = c.gamma[:, None] + c.arrivals
    arr1 = np.ceil(arrivals1 / grid[:, None]).astype(np.int32)
    dl1 = np.floor((arrivals1 + c.deadline[:, None]) / grid[:, None]).astype(np.int32)
    horizon_t = c.gamma + (c.n_active.astype(np.float64) - 1.0) * c.gamma + c.deadline
    NBINS = quant_bins(int((np.ceil(horizon_t / grid) + 2).max()), q=q)
    with np.errstate(invalid="ignore"):
        dur_f = np.ceil(c.t_npu64[None, :] / grid[:, None])
    dur = np.where(np.isfinite(dur_f), np.minimum(dur_f, NBINS), NBINS).astype(np.int32)
    return dict(grid=grid, arr0=arr0, dl0=dl0, arr1=arr1, dl1=dl1, dur=dur), NBINS


def _accuracy_inputs(models, c: _Common, group) -> tuple[dict, int]:
    """Max-Accuracy's per-lane inputs beyond the network model, and the
    group's bin count."""
    bins, NBINS = _accuracy_bins(c, group)
    return dict(_base_lanes(c), **bins, **_net_lanes(models, group)), NBINS


def _base_lanes(c: _Common) -> dict[str, np.ndarray]:
    return dict(gamma=c.gamma, deadline=c.deadline, n_active=c.n_active, n_frames=c.n_frames,
                arrivals=c.arrivals, acc_stat=c.acc_stat64)


def _shared(models, c: _Common) -> dict[str, np.ndarray]:
    """The network planners' model tables."""
    return dict(t_npu64=c.t_npu64, acc_dp=c.acc_dp64, t_srv=np.array([m.t_server for m in models], np.float64))


def _server_audit(p: _Plan, *, active, rtt, t_srv, deadline, strict, acc_sum, proc, miss, offl):
    """The head-frame offload of a planned round, audited at the planned
    upload time (decision order: SERVER first, then the NPU frames)."""
    srv_fin = (p.t_up_off + rtt) + t_srv[p.j_off]
    if strict:
        srv_bad = p.use_off & (srv_fin > deadline + AUDIT_TOL)
    else:
        srv_bad = torch.zeros_like(p.use_off)
    srv_take = active & p.use_off & ~srv_bad
    acc_sum = acc_sum + torch.where(srv_take, p.srv_acc, 0.0)
    proc = proc + srv_take.long()
    offl = offl + srv_take.long()
    miss = miss + (active & srv_bad).long()
    return acc_sum, proc, miss, offl


def _npu_audit(b, p: _Plan, ks, *, active, head, busy, t0, npu_free, acc_sum, proc, miss, npu_s, rounds,
               strict):
    """The NPU frames of a planned round (the audit fold, after the head
    offload when there is one), then the round's carry: head, NPU busy
    time, round count."""
    fa = torch.where(p.use_off, b.gamma, 0.0)
    gate = (active[:, None] & (p.picks >= 0)) & (ks < p.nn[:, None])
    free_end, acc_sum, proc, miss, npu_s = _audit_scan(
        head=head, frame_offset=p.use_off.long(), n_frames=b.n_frames, arrivals=fa[:, None] + b.arrivals,
        deadline=b.deadline, t_npu64=b.t_npu64, acc_stat=b.acc_stat, picks=p.picks, gate=gate,
        free0=npu_free.clamp_min(0.0), acc_sum=acc_sum, proc=proc, miss=miss, npu_s=npu_s, strict=strict)
    busy_until = torch.where(p.use_off | p.use_loc, free_end, npu_free)
    head = torch.where(active, head + p.horizon, head)
    busy = torch.where(active, t0 + busy_until, busy)
    rounds = rounds + active.long()
    return head, busy, acc_sum, proc, miss, npu_s, rounds


@_planner("max_accuracy")
def _run_max_accuracy(models, scenarios, strict, run: _Run):
    def run_group(key, group):
        W, _ = key
        c = _common(models, group, W)
        lanes, NBINS = _accuracy_inputs(models, c, group)
        t_start = time.perf_counter()

        def build(b):
            plan = _accuracy_planner(b, W, NBINS)
            net = _Net(b)
            ks = torch.arange(W, device=b.device)

            def step(state):
                head, busy, acc_sum, npu_s, proc, miss, offl, rounds = state
                active = head < b.n_frames
                t0 = _no_fma(head.double() * b.gamma)
                npu_free = torch.clamp_min(busy - t0, 0.0)
                p = plan(npu_free, net.upload(net.bandwidth(t0)), b.rtt)  # the reference's trace.at(t0)
                acc_sum, proc, miss, offl = _server_audit(
                    p, active=active, rtt=b.rtt, t_srv=b.t_srv, deadline=b.deadline, strict=strict,
                    acc_sum=acc_sum, proc=proc, miss=miss, offl=offl)
                head, busy, acc_sum, proc, miss, npu_s, rounds = _npu_audit(
                    b, p, ks, active=active, head=head, busy=busy, t0=t0, npu_free=npu_free, acc_sum=acc_sum,
                    proc=proc, miss=miss, npu_s=npu_s, rounds=rounds, strict=strict)
                return head, busy, acc_sum, npu_s, proc, miss, offl, rounds

            return step, lambda: _init_state(b, 4, 2)

        state, record = run.drive(key, lanes, _shared(models, c), build, statics=(NBINS, strict))
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

        def build(b):
            net = _Net(b)
            inf = net.inf
            local = b.local[None, :]  # [1, J] models with an NPU variant

            def step(state):
                head, busy, det_acc, acc_sum, npu_s, det_frm, proc, miss, offl, rounds = state
                gamma, deadline, t_npu64, acc_stat = b.gamma, b.deadline, b.t_npu64, b.acc_stat
                active = head < b.n_frames
                t0 = _no_fma(head.double() * gamma)
                npu_free = torch.clamp_min(busy - t0, 0.0)
                # NPU candidates: j ascending (the concatenation order below).
                kf = torch.where(local, torch.ceil(t_npu64[None, :] / gamma[:, None]), 0.0)
                k_npu = torch.clamp_min(kf.long(), 1)  # [B, J] npu_interval
                feas_npu = local & ((npu_free[:, None] + t_npu64) <= deadline[:, None]) & \
                    (k_npu <= b.k_lim[:, None])
                # Offload candidates: the reference's _server_candidates, r asc.
                t_up = net.upload(net.bandwidth(t0))
                j_best, a_best, r_ok = net.best_server(t_up, deadline, b.rtt)
                k_srv = torch.floor(torch.where(r_ok, t_up, 0.0) / gamma[:, None]).long() + 1
                feas_srv = r_ok & (k_srv <= b.k_lim[:, None])
                if fixed:
                    s_npu = torch.where(feas_npu, acc_stat, -inf)
                    s_srv = torch.where(feas_srv, a_best, -inf)
                else:
                    s_npu = torch.where(feas_npu, acc_stat * b.im.gather(1, (k_npu - 1).clamp(0, KQ - 1)), -inf)
                    s_srv = torch.where(feas_srv, a_best * b.im.gather(1, (k_srv - 1).clamp(0, KQ - 1)), -inf)
                # NPU-then-server candidate order with strict > first-wins is
                # a first-maximum argmax over the concatenation (real scores
                # are >= 0, so -inf marks infeasible unambiguously).
                scores = torch.cat([s_npu, s_srv], dim=1)
                idx = torch.argmax(scores, dim=1)
                exists = _pick(scores, idx) > -inf
                det_npu = exists & (idx < J)
                j_pick = idx.clamp(0, J - 1)
                r_pick = (idx - J).clamp(0, R - 1)
                d_acc = torch.where(det_npu, _pick(acc_stat, j_pick), _pick(a_best, r_pick))
                k_det = torch.where(det_npu, _pick(k_npu, j_pick), _pick(k_srv, r_pick))
                horizon = b.k_lim if fixed else torch.where(exists, k_det, 1)  # fixed: consumed even on SKIP
                fin_npu = npu_free + t_npu64[j_pick]
                fin_srv = (_pick(t_up, r_pick) + b.rtt) + b.t_srv[_pick(j_best, r_pick)]
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
                    on = active & (o >= off0) & (o < horizon) & ((head + o) < b.n_frames)
                    age = (head + o - det_frm).clamp(0, A - 1)
                    v = _no_fma(det_acc * b.ret_pow.gather(1, age[:, None])[:, 0])
                    acc_sum = acc_sum + torch.where(on, v, 0.0)
                    proc = proc + on.long()
                npu_s = npu_s + torch.where(active & det_npu, t_npu64[j_pick], 0.0)
                busy_until = torch.where(det_npu, fin_npu, npu_free)
                head = torch.where(active, head + horizon, head)
                busy = torch.where(active, t0 + busy_until, busy)
                rounds = rounds + active.long()
                return head, busy, det_acc, acc_sum, npu_s, det_frm, proc, miss, offl, rounds

            def init():
                state = _init_state(b, 5, 3)
                return state[:5] + (torch.full((b.B,), -1, dtype=torch.int64, device=b.device),) + state[6:]

            return step, init

        shared = _shared(models, c)
        del shared["acc_dp"]
        state, record = run.drive(
            key, dict(gamma=c.gamma, deadline=c.deadline, n_frames=c.n_frames, k_lim=k_lim, im=im, ret_pow=ret_pow,
                      acc_stat=c.acc_stat64, **_net_lanes(models, group)),
            dict(shared, local=np.isfinite(c.t_npu64)), build, statics=(fixed, strict))
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


def _utility_planner(b, W: int, J: int, width: int, exact: bool):
    """Max-Utility's planning phase over a program's buffers:
    ``plan(npu_free, t_up, rtt) -> _Plan`` from the upload times [B, R] and
    the round trip [B] the planner believes, as :func:`_accuracy_planner`."""
    B = b.B
    lanes = torch.arange(B, device=b.device)
    inf = torch.full((), float("inf"), dtype=torch.float64, device=b.device)
    neg = torch.full((), NEG, dtype=torch.float64, device=b.device)
    ones = torch.ones((), dtype=torch.float64, device=b.device)

    def plan(npu_free, t_up, rtt):
        gamma, deadline, alpha, n_w, acc_sv, t_srv = b.gamma, b.deadline, b.alpha, b.n_active, b.acc_sv, b.t_srv
        R = t_up.shape[1]
        # Offload phase: argmax_{r,j} capped-rate + alpha * a(j, r); the
        # reference iterates r-outer/j-inner with strict >, so the first
        # maximum over the r-major flattening wins ties identically.
        feas = ((t_up[:, :, None] + t_srv) + rtt[:, None, None]) <= deadline[:, None, None]  # [B, R, J]
        rate = torch.minimum(ones / torch.clamp_min(t_up, 1e-9), b.fps[:, None])
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
            b.t_npu64, b.acc_dp, torch.cat([n_plan, n_w]), width=width, gamma=_lanes2(gamma),
            deadline=_lanes2(deadline), alpha=_lanes2(alpha), npu_free=_lanes2(npu_free),
            first_arrival=torch.cat([gamma, torch.zeros_like(gamma)]), window=torch.cat([win1, win2]),
            n_frames=W, exact=exact)
        picks2 = _backtrack_slots(par, act, u)
        srv_acc = acc_sv[lanes, j0, r0]
        # _round_utility's decision-order f64 fold; the head offload's server
        # accuracy seeds the offload lanes so the summation order matches.
        n12 = torch.zeros(2 * B, dtype=torch.int64, device=b.device)
        a12 = torch.cat([srv_acc, torch.zeros_like(srv_acc)])
        acc_stat2 = _lanes2(b.acc_stat)
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
        return _Plan(use_off, use_loc, r0, j0.clamp(0, J - 1), t_up0, srv_acc, picks, nn,
                     torch.where(use_off, n_plan + 1, torch.where(use_loc, n_w, 1)), flag[:B] | flag[B:])

    return plan


def _utility_inputs(models, c: _Common, group) -> dict[str, np.ndarray]:
    """Max-Utility's per-lane inputs."""
    return dict(_base_lanes(c), alpha=np.array([float(s.params["alpha"]) for s in group], np.float64),
                fps=np.array([s.stream.fps for s in group], np.float64), **_net_lanes(models, group))


def _max_utility_lanes(run: _Run, key, models: list[ModelProfile], group: list[BatchScenario], *,
                       width: int, exact: bool, strict: bool):
    """Run max_utility over ``group`` (one shape group, or its lanes to
    rerun) to the end at front ``width``; returns ``(common, state,
    record)``."""
    c = _common(models, group, key[0])
    W, J = c.W, c.J

    def build(b):
        plan = _utility_planner(b, W, J, width, exact)
        net = _Net(b)
        ks = torch.arange(W, device=b.device)

        def step(state):
            head, busy, acc_sum, npu_s, proc, miss, offl, rounds, ovf = state
            active = head < b.n_frames
            t0 = _no_fma(head.double() * b.gamma)
            npu_free = torch.clamp_min(busy - t0, 0.0)
            p = plan(npu_free, net.upload(net.bandwidth(t0)), b.rtt)
            ovf = ovf | (active & p.ovf)
            acc_sum, proc, miss, offl = _server_audit(
                p, active=active, rtt=b.rtt, t_srv=b.t_srv, deadline=b.deadline, strict=strict,
                acc_sum=acc_sum, proc=proc, miss=miss, offl=offl)
            head, busy, acc_sum, proc, miss, npu_s, rounds = _npu_audit(
                b, p, ks, active=active, head=head, busy=busy, t0=t0, npu_free=npu_free, acc_sum=acc_sum,
                proc=proc, miss=miss, npu_s=npu_s, rounds=rounds, strict=strict)
            return head, busy, acc_sum, npu_s, proc, miss, offl, rounds, ovf

        return step, lambda: _init_state(b, 4, 2) + (torch.zeros(b.B, dtype=torch.bool, device=b.device),)

    return (c, *run.drive(key, _utility_inputs(models, c, group), _shared(models, c), build,
                          statics=(width, exact, strict)))


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
