"""Lane-batched fleet engine: grids of *interacting* fleets as tensor programs.

``simulator.simulate_multi`` is the ground truth for every multi-client
result: N phones share one fluid uplink and one edge server, and the
``EdgeServerScheduler``'s admission policy (weighted_fair / priority /
fifo) decides who may offload.  It is a Python event loop.  This module
runs the same physics for a *group* of fleet scenarios (bandwidth x
deadline x fps x n_clients x allocation grid points) at once on a torch
device, as :mod:`.sim_batch` runs single streams: every per-scenario value
carries a leading lane axis, the client axis ``N`` is a second, static
axis, and each shape group runs as a
:class:`~repro_torch.core.sweep_shard.LaneProgram` (on the card, a CUDA
graph per round).

One round of a lane is one plan event of the reference:

  * plan events are tick-synchronized (every client of a ``make_fleet``
    fleet shares one frame interval), and a round plans at the laggard
    client's head ``k = min(head)``; clients whose head is ``k`` plan in
    the scheduler's ``(-priority, -weight, client_id)`` order, a chain
    unrolled over the static N, because each grant and lease changes the
    scheduler state the next client sees;
  * between plan events the shared link drains, event by event: water-
    filled rates over the per-client head uploads (radios are serial),
    earliest-completion selection with the reference's ``_EPS`` /
    ``_BITS_EPS`` semantics, and a fixed-point water-filling of at most N
    cap-resolution steps, unrolled;
  * the ``EdgeServerScheduler``'s gates (effective weights, fair shares,
    capacity / backlog / priority-reservation, the serial-radio link
    reservation) are float64 tensor expressions over per-client lease
    counters;
  * offloads are audited at actual completion (fluid upload, a FIFO worker
    queue over ``capacity`` slots, the RTT) against ``deadline_abs +
    1e-9``, as ``simulate_multi`` does.

The drain between two plan events runs a number of completion events that
depends on the data.  A captured round cannot loop on the device, so each
round ends in a fixed count :data:`DRAIN_EVENTS` of masked event
iterations (an iteration with no due event is a no-op for its lane) and a
per-lane "events left" flag, which the host reads with the round's
termination test in one copy; while any lane has events left, a drain-only
program is replayed (``LaneProgram.drain``).  The next round's plan starts
from a fully drained link, so no result depends on the count.

Exactness (held against the reference in ``tests/test_torch_fleet_*.py``):
integer stats (``EQUIV_INT_FIELDS``, server jobs, grants, denials) exact,
float stats within :data:`MULTI_TOL`; with equal weights, bit-equal.  The
reference's own batched engine accumulates its fluid weight totals and
link-reservation sums in client-id order where the event loop uses
registration order, hence the tolerance; this module does the same, as
chains of single adds (never a tree reduction): ``_seq_sum``, the
sequential cap subtraction in the water-filling, and the server-busy
accumulator in the worker assignment.  Every divisor is a per-lane device
tensor and every product rounds before the add it feeds, as in
:mod:`.sim_batch`.

Seven policies have fleet planners here, over the one set of physics
(:class:`_Physics`):

  * ``offload`` — closed-form plan in the granted bandwidth, every client
    at every tick;
  * ``max_accuracy`` / ``max_utility`` — the paper's planners against the
    *granted* bandwidth (:mod:`.sim_batch`'s planning phases), the head
    offload registered on the shared link and scored at completion;
    ``max_utility`` keeps the width-64 fast pass and the rerun, at the
    reference's cap, of the lanes whose flag is set;
  * ``jax_accuracy`` / ``jax_utility`` — local-only plans that never read
    the grant, so every client follows the identical trajectory: one lane
    per scenario runs the single-stream round plus the scheduler's grant /
    denial counters, and the result is copied to every client;
  * ``track_accuracy`` / ``track_fixed`` — the closed-form detect+track
    round with offloaded detections contending on the link.

``Session.run_sweep`` routes fleet grids of these policies here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import sweep_shard
from .bucketing import quant_w
from .jax_sched import _accuracy_dp64, _no_fma
from .profiles import ModelProfile, StreamSpec
from .registry import get_policy
from .schedule import StreamStats
from .sim_batch import (
    _UTIL_CAP,
    _UTIL_FAST_WIDTH,
    BatchScenario,
    _accuracy_bins,
    _accuracy_choice,
    _audit_scan,
    _backtrack_bins,
    _collect,
    _common,
    _init_state,
    _jax_accuracy_inputs,
    _jax_accuracy_step,
    _jax_utility_inputs,
    _jax_utility_shared,
    _jax_utility_step,
    _Net,
    _npu_audit,
    _pick,
    _Run,
    _stitch,
    _trace_bw,
    _utility_planner,
    _window_frames,
    segment_arrays,
)
from .simulator import _BITS_EPS, _EPS, MultiStreamStats
from .tracking import WorkloadSpec, interval_means, retention, retention_powers

__all__ = [
    "DRAIN_EVENTS",
    "EQUIV_INT_FIELDS",
    "FleetScenario",
    "MULTI_TOL",
    "multi_batched_policies",
    "simulate_multi_batch",
]

# The equivalence contract versus the reference event loop: the per-stream
# integer fields below match exactly, float stats (accuracy sums, server
# busy seconds) within the absolute tolerance MULTI_TOL.
MULTI_TOL = 1e-9
EQUIV_INT_FIELDS = (
    "frames_processed",
    "frames_missed_deadline",
    "frames_offloaded",
    "frames_total",
    "schedule_calls",
)

_BIG = 1e18  # "never" sentinel for event times (far above any finish time)
_BIG_I = 2**31 - 1  # the reference's int32 "never" for registration order

# Masked completion events per round (and per drain-only replay).  Results
# do not depend on it; it trades a round's length against drain replays.
DRAIN_EVENTS = 2


@dataclass(frozen=True)
class FleetScenario:
    """One fleet grid point as the batched engine sees it: a homogeneous
    fleet (the ``make_fleet`` shape — one stream spec, per-client weights /
    priorities), a shared network, an allocation policy, and the inner
    policy's *resolved* parameter dict.

    The network is ``bw_segments`` — sorted piecewise-constant
    ``(t_start_s, bandwidth_bps)`` segments replayed on the device
    (allocation reads bandwidth at each round's start, the fluid link at
    every event boundary, as the reference's ``trace.at``) — or, when that
    is ``None``, the constant ``bandwidth_bps``.

    ``workload`` is the fleet's world truth (``tracking.WorkloadSpec``): the
    ``track_*`` planners require ``kind="track"``, the classification
    planners the default ``kind="classify"``."""

    stream: StreamSpec = field(default_factory=StreamSpec)
    n_frames: int = 120
    bandwidth_bps: float = 2.5e6
    rtt: float = 0.100
    n_clients: int = 2
    allocation: str = "weighted_fair"
    capacity: int = 4
    backlog_limit: float = 0.0
    weights: tuple[float, ...] | None = None
    priorities: tuple[int, ...] | None = None
    params: Mapping[str, Any] = field(default_factory=dict)
    bw_segments: tuple[tuple[float, float], ...] | None = None
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)


_PLANNERS: dict[str, Callable[..., list[tuple[MultiStreamStats, dict]]]] = {}


def _planner(name: str):
    def deco(fn):
        _PLANNERS[name] = fn
        return fn

    return deco


def multi_batched_policies() -> tuple[str, ...]:
    """Policies with a fleet planner here (the registry's
    ``batched_multi=True`` set; ``tests/test_torch_fleet_session.py``
    asserts the two stay in sync)."""
    return tuple(sorted(_PLANNERS))


def simulate_multi_batch(
    policy: str,
    models: Sequence[ModelProfile],
    scenarios: Sequence[FleetScenario],
    *,
    strict: bool = True,
    device: torch.device | str = "cuda",
    groups: list[dict[str, Any]] | None = None,
) -> list[tuple[MultiStreamStats, dict]]:
    """Run ``policy`` fleets over every scenario, lane-batched on ``device``.

    Returns one ``(MultiStreamStats, meta)`` pair per scenario, in order;
    ``meta`` holds the scheduler's ``grants`` and ``denials``, as
    ``Session.run_multi`` reports them.  Raises ``ValueError`` for policies
    without a fleet planner (``Session.run_sweep`` is the front door that
    logs a fallback instead).  ``strict`` gates the plan-time audit of NPU
    decisions, as in ``simulate_multi``; offloads are audited at actual
    completion either way.  Where ``groups`` is a list, one dict per shape
    group is appended to it: its key, lanes, rounds, host reads, drain
    replays and lanes rerun at the cap."""
    fn = _PLANNERS.get(policy)
    if fn is None:
        raise ValueError(
            f"policy {policy!r} has no batched fleet backend; available: {multi_batched_policies()}"
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
# Fixed-shape fleet state.  One scenario is one lane; per-client values
# carry a second axis N.  Upload queues are per-client append-only logs of
# length F (at most one offload per client per tick), so the cursors need
# no ring arithmetic:
#
#     [0 .. srv-released) .. [.. updone) .. [.. tail)
#      lease popped           at server      upload in flight
#
# A lease exists for every entry in [released, tail); its link share is
# active for entries in [updone, tail), and the serial radio transmits only
# the entry AT updone.  "released" is not stored: a lease leaves the server
# when its recorded finish time passes (q_srvfin <= t).
# ---------------------------------------------------------------------------


class _Fleet(NamedTuple):
    k: torch.Tensor  # [B] i64 the tick the lane plans at next (>= F: planning is over)
    now: torch.Tensor  # [B] f64 simulation time
    rates: torch.Tensor  # [B, N] f64 the link's water-filled rates at ``now``
    q_bits: torch.Tensor  # [B, N, F] f64 residual upload bits
    q_cap: torch.Tensor  # [B, N, F] f64 granted rate cap (inf under fifo)
    q_ddl: torch.Tensor  # [B, N, F] f64 absolute deadline
    q_acc: torch.Tensor  # [B, N, F] f64 server accuracy credited on an on-time finish
    q_tsrv: torch.Tensor  # [B, N, F] f64 server-side service time
    q_bps: torch.Tensor  # [B, N, F] f64 leased bandwidth (link reservation while active)
    q_seq: torch.Tensor  # [B, N, F] i64 global registration order (tick * N + plan rank)
    q_srvfin: torch.Tensor  # [B, N, F] f64 server-job finish time (BIG until assigned)
    q_detfrm: torch.Tensor  # [B, N, F] i64 frame of the detection an upload carries (track)
    tail: torch.Tensor  # [B, N] i64 uploads ever registered
    updone: torch.Tensor  # [B, N] i64 uploads fully drained off the link
    worker_free: torch.Tensor  # [B, KW] f64 per-worker busy-until
    sbu: torch.Tensor  # [B] f64 the scheduler's backlog estimate (server_busy_until)
    grants: torch.Tensor  # [B] i64
    denials: torch.Tensor  # [B] i64
    sjobs: torch.Tensor  # [B] i64 jobs the server executed
    sbusy: torch.Tensor  # [B] f64 server busy seconds
    accs: torch.Tensor  # [B, N] f64 per-client accuracy sums
    proc: torch.Tensor  # [B, N] i64 frames processed
    miss: torch.Tensor  # [B, N] i64 deadline misses
    offl: torch.Tensor  # [B, N] i64 on-time server completions
    head: torch.Tensor  # [B, N] i64 next frame each client plans (round boundary)
    busy: torch.Tensor  # [B, N] f64 absolute NPU busy-until
    rounds: torch.Tensor  # [B, N] i64 plan rounds executed
    npus: torch.Tensor  # [B, N] f64 NPU busy seconds
    det_acc: torch.Tensor  # [B, N] f64 accuracy of the newest detection (track)
    det_frm: torch.Tensor  # [B, N] i64 its frame (track; -1 before the first)
    ovf: torch.Tensor  # [B] bool a Max-Utility front outgrew its width
    tgt: torch.Tensor  # [B] f64 the time the link drains toward
    budget: torch.Tensor  # [B] i64 completion events the drain may still run
    left: torch.Tensor  # [B] bool the drain has events left (LaneProgram's flag, last)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the client axis of ``x`` [B, N] as a chain of single adds in
    client-id order, as the reference sums with Python's left-to-right
    ``sum`` (a tree reduction rounds differently)."""
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def _at(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``q[b, c, idx[b, c]]`` for [B, N, F] ``q`` and [B, N] ``idx``."""
    return q.gather(2, idx[..., None])[..., 0]


def _set_at(q: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q`` with ``q[b, c, idx[b, c]] = v[b, c]``."""
    return q.scatter(2, idx[..., None], v[..., None])


class _Physics:
    """The shared fleet physics over a program's buffers: the fluid uplink
    (water-filled rates, event-by-event drain), the completion and audit
    machinery, and the ``EdgeServerScheduler``'s allocation and lease
    arithmetic.  Every planner composes these with its own plan chain, so
    the link a DP planner contends on is the code the ``offload`` planner
    runs.  ``b`` holds, per lane: ``bw_t``/``bw_v`` (segments), ``rtt``,
    ``L`` (backlog limit), ``gamma``, ``n_frames`` (F), and per client
    ``w_fluid``, ``w_eff``, ``prio`` and the plan ``order``, with
    ``tot_w`` per lane."""

    def __init__(self, b, alloc: str, N: int, K: int, F: int):
        dev = b.device
        self.b, self.N, self.K, self.F = b, N, K, F
        self.fifo, self.prio_pol = alloc == "fifo", alloc == "priority"
        self.KW = max(K, 1)  # worker count (the reference's max(int(capacity), 1))
        self.maxev = N * F + N + 4  # completion events are bounded by registrations
        self.net = _Net(b)
        f64 = torch.float64
        # The reference divides by max(capacity, 1), even at K == 0.
        self.kw = torch.full((b.B,), float(self.KW), dtype=f64, device=dev)
        self.cids = torch.arange(N, device=dev)
        self.wids = torch.arange(self.KW, device=dev)
        self.pos = torch.arange(F, device=dev)
        self.big = torch.full((), _BIG, dtype=f64, device=dev)
        self.inf = torch.full((), float("inf"), dtype=f64, device=dev)

    # -- fluid link: rates over the per-client head uploads ----------------
    def heads(self, st: _Fleet):
        idx = st.updone.clamp(0, self.F - 1)
        active = st.updone < st.tail
        hbits = torch.where(active, _at(st.q_bits, idx), 0.0)
        hcap = torch.where(active, _at(st.q_cap, idx), self.big)
        hseq = torch.where(active, _at(st.q_seq, idx), _BIG_I)
        return idx, active, hbits, hcap, hseq

    def waterfill(self, bw: torch.Tensor, active: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
        """Fixed-point rendering of ``edge_server.fluid_rates``: each step
        either freezes >= 1 capped transfer or assigns the final shares, so
        N steps always suffice."""
        w = self.b.w_fluid
        rates = torch.zeros_like(caps)
        remaining = bw.clamp_min(0.0)
        act = active
        done = ~active.any(dim=1)
        for _ in range(self.N):
            total_w = _seq_sum(torch.where(act, w, 0.0))
            total_w = torch.where(total_w == 0.0, 1.0, total_w)
            share = (remaining[:, None] * w) / total_w[:, None]
            live = act & (remaining > _EPS)[:, None] & ~done[:, None]
            capped = live & (caps <= share + _EPS)
            any_capped = capped.any(dim=1)
            fill = live & ~any_capped[:, None]
            # No cap binds: everyone still active takes its share, done.
            rates = torch.where(fill, share, rates)
            # Caps bind: freeze them, return the leftovers to the pool in
            # client-id order (the reference subtracts sequentially).
            rates = torch.where(capped, caps, rates)
            freed = torch.where(capped, caps, 0.0)
            sub = remaining
            for i in range(self.N):
                sub = sub - freed[:, i]
            remaining = torch.where(any_capped, sub.clamp_min(0.0), remaining)
            act = act & ~capped & any_capped[:, None]
            done = done | fill.any(dim=1) | ~live.any(dim=1)
        return rates

    def link(self, st: _Fleet):
        """The link at ``st.now``: ``(idx, active, hbits, rates, finish)``.
        Rates are re-evaluated at every event boundary against the trace's
        bandwidth at the current time."""
        idx, active, hbits, hcap, _ = self.heads(st)
        rates = self.waterfill(self.net.bandwidth(st.now), active, hcap)
        finish = torch.where(active & (rates > _EPS), st.now[:, None] + hbits / rates, self.big)
        return idx, active, hbits, rates, finish

    # -- a batch of upload completions: worker queue + deadline audit ------
    def complete(self, st: _Fleet, due: torch.Tensor) -> _Fleet:
        """At most one upload per client (its head) is due at once, so the
        per-client stats update as [B, N] tensors; the worker assignment
        walks the due set one job at a time in registration order against
        the mutating worker pool, and the server-busy accumulator grows one
        job at a time, as the reference's loop does."""
        idx, _, _, _, hseq = self.heads(st)
        tsv = torch.where(due, _at(st.q_tsrv, idx), 0.0)
        seqs = torch.where(due, hseq, _BIG_I)
        wf, sbusy, left = st.worker_free, st.sbusy, due
        jfin = torch.full_like(tsv, _BIG)
        for _ in range(self.N):
            c = torch.argmin(torch.where(left, seqs, _BIG_I), dim=1, keepdim=True)  # first min
            go = left.gather(1, c)[:, 0]
            wi = torch.argmin(wf, dim=1, keepdim=True)  # the first free worker
            wf_i = wf.gather(1, wi)[:, 0]
            tsv_c = tsv.gather(1, c)[:, 0]
            fin = torch.maximum(st.now, wf_i) + tsv_c
            wf = torch.where((self.wids == wi) & go[:, None], fin[:, None], wf)
            mine = self.cids == c
            jfin = torch.where(mine & go[:, None], fin[:, None], jfin)
            sbusy = sbusy + torch.where(go, tsv_c, 0.0)
            left = left & ~mine
        ontime = due & ((jfin + self.b.rtt[:, None]) <= (_at(st.q_ddl, idx) + _EPS))
        return st._replace(
            worker_free=wf,
            q_srvfin=_set_at(st.q_srvfin, idx, torch.where(due, jfin, _at(st.q_srvfin, idx))),
            updone=st.updone + due.long(),
            sjobs=st.sjobs + due.sum(dim=1),
            sbusy=sbusy,
            accs=st.accs + torch.where(ontime, _at(st.q_acc, idx), 0.0),
            proc=st.proc + ontime.long(),
            miss=st.miss + (due & ~ontime).long(),
            offl=st.offl + ontime.long(),
        )

    def advance(self, st: _Fleet, t0: torch.Tensor, on: torch.Tensor) -> _Fleet:
        """The end of a drain toward a plan event at ``t0`` (lanes ``on``):
        a partial advance at the current rates (the reference's
        piecewise-constant approximation), then the mop-up of any head left
        below ``_BITS_EPS``."""
        idx, active, hbits, _, _ = self.heads(st)
        dt = (t0 - st.now).clamp_min(0.0)
        newbits = (hbits - st.rates * dt[:, None]).clamp_min(0.0)
        hit = active & on[:, None]
        st = st._replace(now=torch.where(on, torch.maximum(st.now, t0), st.now),
                         q_bits=_set_at(st.q_bits, idx, torch.where(hit, newbits, _at(st.q_bits, idx))))
        idx, active, hbits, _, _ = self.heads(st)
        return self.complete(st, active & on[:, None] & (hbits <= _BITS_EPS))

    def drain(self, st: _Fleet, events: int) -> _Fleet:
        """``events`` completion events toward ``st.tgt``, each a no-op for
        a lane with none due (or an exhausted budget); then the link's rates
        and the flag of lanes with events left."""
        for e in range(events + 1):
            idx, active, hbits, rates, finish = self.link(st)
            t_done = finish.amin(dim=1)
            # t_done == BIG means "no completion will ever happen"; without
            # the guard a drain toward BIG would spin on it.
            go = (t_done <= st.tgt + _EPS) & (t_done < _BIG * 0.5) & (st.budget > 0)
            if e == events:
                return st._replace(rates=rates, left=go)
            t_next = torch.minimum(torch.minimum(t_done, st.tgt), self.big)
            dt = (t_next - st.now).clamp_min(0.0)
            newbits = (hbits - rates * dt[:, None]).clamp_min(0.0)
            due = active & go[:, None] & (
                ((finish <= (t_done + _EPS)[:, None]) & (t_done <= t_next + _EPS)[:, None])
                | (newbits <= _BITS_EPS))
            st = st._replace(
                now=torch.where(go, torch.maximum(st.now, t_next), st.now),
                q_bits=_set_at(st.q_bits, idx, torch.where(active & go[:, None], torch.where(due, 0.0, newbits),
                                                           _at(st.q_bits, idx))),
                budget=st.budget - go.long())
            st = self.complete(st, due)

    # -- the scheduler ------------------------------------------------------
    def released(self, st: _Fleet, t0: torch.Tensor) -> torch.Tensor:
        """Per client, the leases whose server jobs have finished by ``t0``."""
        return (st.q_srvfin <= (t0 + _EPS)[:, None, None]).sum(dim=2)

    def link_reserved(self, st: _Fleet) -> torch.Tensor:
        """Serial radios: a client's many leases reserve max(bps) over its
        link-active entries [updone, tail).  Recomputed once a round; plan
        events then maintain it (a new lease can only raise its own
        client's max)."""
        act = (self.pos >= st.updone[..., None]) & (self.pos < st.tail.clamp(0, self.F)[..., None])
        return torch.where(act, st.q_bps, 0.0).amax(dim=2)

    def allocate(self, st: _Fleet, c, t0, released, act_bps):
        """One client's ``EdgeServerScheduler.allocate``: ``(grant, denied)``
        for client ``c`` [B], the bandwidth at ``t0`` (the reference plans
        against ``trace.at(t0)``)."""
        b = self.b
        lease_len = st.tail - released  # [B, N]
        total = lease_len.sum(dim=1)
        bw0 = self.net.bandwidth(t0)
        if self.fifo:
            return bw0, torch.zeros_like(st.left)
        own = _pick(lease_len, c)
        effective = total - own.clamp_max(1)
        gated = (effective >= self.K) | ((st.sbu - t0) > b.L)
        if self.prio_pol:
            free = self.K - total
            higher_waiting = ((b.prio > _pick(b.prio, c)[:, None]) & (lease_len == 0)).sum(dim=1)
            gated = gated | (free <= higher_waiting)
        used = _seq_sum(torch.where(self.cids != c[:, None], act_bps, 0.0))
        available = (bw0 - used).clamp_min(0.0)
        share = (bw0 * _pick(b.w_eff, c)) / b.tot_w
        grant = torch.minimum(share, available)
        denied = gated | (grant <= 0.0)
        return torch.where(denied, 0.0, grant), denied

    def register(self, st: _Fleet, act_bps, c, *, on, t0, seq, grant, bits, ddl, acc, tsv, det_frm=None):
        """Register client ``c``'s head-frame offload on the link and its
        server lease, where ``on``."""
        e = _pick(st.tail, c).clamp(0, self.F - 1)
        mine = (self.cids == c[:, None]) & on[:, None]  # [B, N]
        slot = mine[..., None] & (self.pos == e[:, None, None])  # [B, N, F]

        def put(q, val):
            return torch.where(slot, val.reshape(-1, 1, 1) if val.dim() else val, q)

        sbu = st.sbu
        if not self.fifo:
            sbu = torch.where(on, torch.maximum(st.sbu, t0) + tsv / self.kw, st.sbu)
        st = st._replace(
            q_bits=put(st.q_bits, bits),
            q_cap=put(st.q_cap, self.inf if self.fifo else grant),
            q_ddl=put(st.q_ddl, ddl),
            q_acc=put(st.q_acc, acc),
            q_tsrv=put(st.q_tsrv, tsv),
            q_bps=put(st.q_bps, grant),
            q_seq=put(st.q_seq, seq),
            q_detfrm=st.q_detfrm if det_frm is None else put(st.q_detfrm, det_frm),
            tail=st.tail + mine.long(),
            sbu=sbu,
        )
        return st, torch.where(mine, torch.maximum(act_bps, grant[:, None]), act_bps)

    def init(self) -> tuple:
        b, N, F = self.b, self.N, self.F
        dev, f64, i64 = b.device, torch.float64, torch.int64

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        B = b.B
        st = _Fleet(
            k=full((B,), 0, i64), now=full((B,), 0.0, f64), rates=full((B, N), 0.0, f64),
            q_bits=full((B, N, F), 0.0, f64), q_cap=full((B, N, F), _BIG, f64), q_ddl=full((B, N, F), 0.0, f64),
            q_acc=full((B, N, F), 0.0, f64), q_tsrv=full((B, N, F), 0.0, f64), q_bps=full((B, N, F), 0.0, f64),
            q_seq=full((B, N, F), _BIG_I, i64), q_srvfin=full((B, N, F), _BIG, f64),
            q_detfrm=full((B, N, F), -1, i64), tail=full((B, N), 0, i64), updone=full((B, N), 0, i64),
            worker_free=full((B, self.KW), 0.0, f64), sbu=full((B,), 0.0, f64), grants=full((B,), 0, i64),
            denials=full((B,), 0, i64), sjobs=full((B,), 0, i64), sbusy=full((B,), 0.0, f64),
            accs=full((B, N), 0.0, f64), proc=full((B, N), 0, i64), miss=full((B, N), 0, i64),
            offl=full((B, N), 0, i64), head=full((B, N), 0, i64), busy=full((B, N), 0.0, f64),
            rounds=full((B, N), 0, i64), npus=full((B, N), 0.0, f64), det_acc=full((B, N), 0.0, f64),
            det_frm=full((B, N), -1, i64), ovf=full((B,), False, torch.bool), tgt=full((B,), 0.0, f64),
            budget=full((B,), self.maxev, i64), left=full((B,), False, torch.bool))
        return tuple(st)


def _fleet_program(phys: _Physics, plan: Callable, events: int):
    """A fleet planner's round and drain-only step: the round ends the drain
    toward its plan event (partial advance, mop-up), frees the finished
    leases, runs ``plan(st, on, t0, released)`` for every lane still
    planning (``on``), moves each lane to its next plan event (``min(head)``,
    or ``BIG`` for the post-stream drain once planning is over) and drains
    ``events`` completion events toward it."""
    b = phys.b

    def step(state):
        st = _Fleet(*state)
        on = st.k < b.n_frames
        t0 = _no_fma(st.k.double() * b.gamma)
        st = phys.advance(st, t0, on)
        st = plan(st, on, t0, phys.released(st, t0))
        k = torch.where(on, st.head.amin(dim=1), st.k)
        tgt = torch.where(k < b.n_frames, _no_fma(k.double() * b.gamma), phys.big)
        st = st._replace(k=k, tgt=torch.where(on, tgt, st.tgt),
                         budget=torch.where(on, phys.maxev, st.budget))
        return tuple(phys.drain(st, events))

    def drain(state):
        return tuple(phys.drain(_Fleet(*state), events))

    return step, phys.init, drain


# ---------------------------------------------------------------------------
# Host side: f64 precomputation mirrors the reference expression by
# expression (frame bits, accuracy tables, effective weights, plan order),
# then one lane program per shape group.
# ---------------------------------------------------------------------------


def _segments(group: list[FleetScenario]):
    return segment_arrays([s.bw_segments or ((0.0, s.bandwidth_bps),) for s in group])


def _shims(group: list[FleetScenario]) -> list[BatchScenario]:
    """Each fleet point as a single-stream scenario, for sim_batch's
    per-scenario precomputation (``_common``)."""
    return [BatchScenario(stream=s.stream, n_frames=s.n_frames, params=s.params) for s in group]


def _fleet_lanes(models: list[ModelProfile], group: list[FleetScenario], N: int, alloc: str) -> dict:
    """Per-lane network, offload tables and scheduler tensors, the scalar
    reference arithmetic verbatim: fluid weights floor at ``_EPS`` (the
    reference's ``max(weight, _EPS)``), effective weights and their total
    use the scheduler's own expressions so shares match to the bit, and the
    plan order inside a tick is the reference's event key ``(t, -priority,
    -weight, client_id)``."""
    w = np.array([s.weights if s.weights is not None else (1.0,) * N for s in group], np.float64)
    prio = np.array([s.priorities if s.priorities is not None else (0,) * N for s in group], np.int64)
    if alloc == "priority":
        w_eff = np.array([[wi * (2.0 ** int(pi)) for wi, pi in zip(wr, pr)] for wr, pr in zip(w, prio)],
                         np.float64)
    else:
        w_eff = w.copy()
    bw_t, bw_v, _ = _segments(group)
    return dict(
        bw_t=bw_t, bw_v=bw_v,
        rtt=np.array([s.rtt for s in group], np.float64),
        L=np.array([s.backlog_limit for s in group], np.float64),
        nbits8=np.array([[s.stream.frame_bytes(r) * 8.0 for r in s.stream.resolutions] for s in group],
                        np.float64),
        acc_sv=np.array([[[m.accuracy(r, where="server") for r in s.stream.resolutions] for m in models]
                         for s in group], np.float64),
        w_fluid=np.maximum(w, _EPS), w_eff=w_eff,
        tot_w=np.array([sum(row) or 1.0 for row in w_eff], np.float64),
        prio=prio,
        order=np.stack([np.lexsort((np.arange(N), -wr, -pr)) for wr, pr in zip(w, prio)]),
    )


def _fleet_key(s: FleetScenario) -> tuple:
    """Allocation, fleet size, capacity and frame count fix a fleet
    program's link arrays; resolutions and png_ratio its offload tables."""
    return (s.allocation, int(s.n_clients), int(s.capacity), int(s.n_frames), tuple(s.stream.resolutions),
            float(s.stream.png_ratio))


def _read(record: dict, st: _Fleet) -> dict[str, np.ndarray]:
    """A group's results for its real lanes in one copy to the host
    (integers below 2^53 travel exactly as float64).  Uploads still queued
    after the post-stream drain could never complete (a dead link): each
    is a deadline miss, as the reference's ``finish`` counts them."""
    parts = dict(accs=st.accs, proc=st.proc, miss=st.miss + (st.tail - st.updone), offl=st.offl,
                 rounds=st.rounds, npus=st.npus, grants=st.grants, denials=st.denials, sjobs=st.sjobs,
                 sbusy=st.sbusy, ovf=st.ovf)
    B = st.k.shape[0]
    flat = [p.reshape(B, -1).to(torch.float64) for p in parts.values()]
    host = sweep_shard.gather(record, torch.cat(flat, dim=1).cpu().numpy())
    out, at = {}, 0
    for name, p in zip(parts, flat):
        out[name] = host[:, at: at + p.shape[1]]
        at += p.shape[1]
    return out


def _fleet_results(group: list[FleetScenario], out: dict[str, np.ndarray], wall: float, *,
                   offload_only: bool = False) -> list[tuple[MultiStreamStats, dict]]:
    """Per-client StreamStats + meta.  The group's wall time is apportioned
    by round count, so schedule_time / schedule_calls is the amortized
    per-round cost (as sim_batch reports it)."""
    total_rounds = max(int(out["rounds"].sum()), 1)
    results = []
    for b, s in enumerate(group):
        elapsed = s.n_frames * s.stream.gamma
        per_client = [
            StreamStats(
                frames_total=s.n_frames,
                frames_processed=int(out["proc"][b, c]),
                frames_missed_deadline=int(out["miss"][b, c]),
                frames_offloaded=int(out["proc"][b, c] if offload_only else out["offl"][b, c]),
                accuracy_sum=float(out["accs"][b, c]),
                elapsed=elapsed,
                schedule_calls=int(out["rounds"][b, c]),
                schedule_time=wall * float(out["rounds"][b, c]) / total_rounds,
                npu_busy_s=float(out["npus"][b, c]),
            )
            for c in range(s.n_clients)
        ]
        ms = MultiStreamStats(per_client=per_client, server_jobs=int(out["sjobs"][b, 0]),
                              server_busy_s=float(out["sbusy"][b, 0]), elapsed=elapsed)
        results.append((ms, {"grants": int(out["grants"][b, 0]), "denials": int(out["denials"][b, 0])}))
    return results


def _client(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Client ``c[b]``'s row of a [B, N, W] per-client table: [B, W]."""
    return x.gather(1, c[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]


def _set(x: torch.Tensor, mine: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``x`` [B, N] with the entry of each lane's client (``mine``, one-hot)
    set to ``v`` [B]."""
    return torch.where(mine, v[:, None], x)


# ---------------------------------------------------------------------------
# offload: the round plan is closed-form in the granted bandwidth (no DP),
# and every client plans at every tick.
# ---------------------------------------------------------------------------


@_planner("offload")
def _run_offload(models, scenarios, strict, run: _Run):
    # ``strict`` has no observable effect: offload plans hold no NPU decision.
    del strict
    t_srv = np.array([m.t_server for m in models], np.float64)
    events = DRAIN_EVENTS

    def run_group(key, group):
        alloc, N, K, F, _, _ = key
        alpha_raw = [s.params.get("alpha") for s in group]
        lanes = dict(
            _fleet_lanes(models, group, N, alloc),
            gamma=np.array([s.stream.gamma for s in group], np.float64),
            deadline=np.array([s.stream.deadline for s in group], np.float64),
            fps=np.array([s.stream.fps for s in group], np.float64),
            alpha=np.array([a if a is not None else 0.0 for a in alpha_raw], np.float64),
            is_util=np.array([a is not None for a in alpha_raw], bool),
            n_frames=np.array([s.n_frames for s in group], np.int64),
        )
        t_start = time.perf_counter()

        def build(b):
            phys = _Physics(b, alloc, N, K, F)
            lanes_i = torch.arange(b.B, device=b.device)
            ones = torch.ones((), dtype=torch.float64, device=b.device)

            def plan(st, on, t0, released):
                act_bps = phys.link_reserved(st)
                for rank in range(N):
                    c = b.order[:, rank]
                    grant, denied = phys.allocate(st, c, t0, released, act_bps)
                    st = st._replace(grants=st.grants + (on & ~denied).long(),
                                     denials=st.denials + (on & denied).long())
                    # The reference's per-resolution loop as one [B, R]
                    # expression against the granted bandwidth.
                    t_up = b.nbits8 / grant[:, None]  # inf when grant == 0, like upload_time
                    budget = (b.deadline[:, None] - t_up) - b.rtt[:, None]
                    fits = b.t_srv[None, :, None] <= budget[:, None, :]  # [B, J, R]
                    a_mask = torch.where(fits, b.acc_sv, -phys.inf)
                    j_best = torch.argmax(a_mask, dim=1)  # first max
                    a_best = a_mask.gather(1, j_best[:, None])[:, 0]
                    feasible = (t_up <= b.gamma[:, None]) & fits.any(dim=1)
                    util = torch.minimum(ones / t_up.clamp_min(1e-9), b.fps[:, None]) + b.alpha[:, None] * a_best
                    score = torch.where(b.is_util[:, None], util, a_best)
                    score = torch.where(feasible, score, -phys.inf)
                    r_pick = torch.argmax(score, dim=1)  # first max wins ties
                    j_pick = _pick(j_best, r_pick)
                    st, act_bps = phys.register(
                        st, act_bps, c, on=on & feasible.any(dim=1), t0=t0, seq=st.k * N + rank, grant=grant,
                        bits=_pick(b.nbits8, r_pick), ddl=t0 + b.deadline, acc=b.acc_sv[lanes_i, j_pick, r_pick],
                        tsv=b.t_srv[j_pick])
                step1 = on.long()[:, None]
                return st._replace(head=st.head + step1, rounds=st.rounds + step1)

            return _fleet_program(phys, plan, events)

        state, record = run.drive(key, lanes, dict(t_srv=t_srv), build, statics=(events,))
        record["drain_events"] = events
        out = _read(record, _Fleet(*state))
        return _fleet_results(group, out, time.perf_counter() - t_start, offload_only=True)

    return _stitch(scenarios, _fleet_key, run_group)


# ---------------------------------------------------------------------------
# The DP planners: max_accuracy / max_utility.  Each client's round is the
# sim_batch rendering of the reference plan_round, against the GRANTED
# bandwidth, with the head-frame offload registered on the shared link
# (audited at actual completion, as the reference's on_offload callback)
# instead of scored at plan time.  Clients plan only at their own round
# boundaries (head == k).
# ---------------------------------------------------------------------------


def _planner_key(s: FleetScenario) -> tuple:
    """The fleet key plus the quantized window, which fixes the DP shapes."""
    return (*_fleet_key(s), quant_w(_window_frames(s.stream, s.params)))


def _dp_lanes(models, group, c, N: int, alloc: str) -> dict:
    return dict(_fleet_lanes(models, group, N, alloc), gamma=c.gamma, deadline=c.deadline,
                n_active=c.n_active, n_frames=c.n_frames, arrivals=c.arrivals, acc_stat=c.acc_stat64)


def _dp_shared(models, c) -> dict:
    return dict(t_npu64=c.t_npu64, acc_dp=c.acc_dp64, t_srv=np.array([m.t_server for m in models], np.float64))


@_planner("max_accuracy")
def _run_max_accuracy_fleet(models, scenarios, strict, run: _Run):
    events = DRAIN_EVENTS

    def run_group(key, group):
        alloc, N, K, F, _, _, W = key
        c = _common(models, _shims(group), W)
        # A fine padding quantum: the fleet DP pays NBINS x rounds x N a lane.
        bins, NBINS = _accuracy_bins(c, _shims(group), q=32)
        lanes = dict(_dp_lanes(models, group, c, N, alloc), **bins)
        t_start = time.perf_counter()

        def build(b):
            phys = _Physics(b, alloc, N, K, F)
            net = phys.net
            BN = b.B * N
            ks = torch.arange(W, device=b.device)
            lanes_i = torch.arange(b.B, device=b.device)

            def rep(x):  # a per-lane tensor for each of its clients' lanes
                return x.repeat_interleave(N, dim=0)

            def plan(st, on, t0, released):
                # A client's DP tables depend on the round only through its
                # own NPU horizon (start_bin), which nobody else writes, so
                # the tables of all N clients are one DP over 2*B*N lanes
                # outside the allocate/register chain, which then runs on
                # cheap [B] tensors.
                npu_free = (st.busy - t0[:, None]).clamp_min(0.0)  # [B, N]
                start_bins = torch.ceil(npu_free.clamp_min(0.0) / b.grid[:, None]).long()
                sb = start_bins.reshape(BN)
                dur = rep(b.dur)
                cho, par, mh, ab, alive = _accuracy_dp64(
                    torch.cat([dur, dur]), b.acc_dp, torch.cat([rep(b.arr0), rep(b.arr1)]),
                    torch.cat([rep(b.dl0), rep(b.dl1)]), torch.cat([sb, sb]), nbins=NBINS)
                recs = [x[:BN].view(b.B, N, W) for x in (mh, ab, alive)], \
                    [x[BN:].view(b.B, N, W) for x in (mh, ab, alive)]
                act_bps = phys.link_reserved(st)
                zi = torch.zeros_like(st.head)
                zb = torch.zeros_like(st.head, dtype=torch.bool)
                planning_v, use_off_v, use_loc_v, nn_v, b0_loc_v, b0_off_v = zb, zb, zb, zi, zi, zi
                head, rounds = st.head, st.rounds
                for rank in range(N):
                    c = b.order[:, rank]
                    mine = phys.cids == c[:, None]
                    planning = on & (_pick(head, c) == st.k)
                    grant, denied = phys.allocate(st, c, t0, released, act_bps)
                    st = st._replace(grants=st.grants + (planning & ~denied).long(),
                                     denials=st.denials + (planning & denied).long())
                    # The reference plans against NetworkState(grant, rtt).
                    use_off, use_loc, r_star, j_srv, nn, horizon, b0_loc, b0_off = _accuracy_choice(
                        net, W, gamma=b.gamma, deadline=b.deadline, grid_t=b.grid, n_active=b.n_active,
                        start_bin=_pick(start_bins, c), t_up=net.upload(grant), rtt=b.rtt,
                        local=[_client(x, c) for x in recs[0]], offload=[_client(x, c) for x in recs[1]])
                    # Head-frame offload: registered on the shared link, and
                    # audited at actual completion.
                    st, act_bps = phys.register(
                        st, act_bps, c, on=planning & use_off, t0=t0, seq=st.k * N + rank, grant=grant,
                        bits=_pick(b.nbits8, r_star), ddl=t0 + b.deadline, acc=b.acc_sv[lanes_i, j_srv, r_star],
                        tsv=b.t_srv[j_srv])
                    head = head + torch.where(mine & planning[:, None], horizon[:, None], 0)
                    rounds = rounds + (mine & planning[:, None]).long()
                    planning_v = _set(planning_v, mine, planning)
                    use_off_v = _set(use_off_v, mine, use_off)
                    use_loc_v = _set(use_loc_v, mine, use_loc)
                    nn_v, b0_loc_v, b0_off_v = _set(nn_v, mine, nn), _set(b0_loc_v, mine, b0_loc), \
                        _set(b0_off_v, mine, b0_off)
                # Backtracking and the frame audit depend only on each
                # client's own decision, so they run over B*N lanes after
                # the chain, both DPs' backtracks at once.
                flat = [x.reshape(BN) for x in (planning_v, use_off_v, use_loc_v, nn_v, npu_free)]
                planning_f, use_off_f, use_loc_f, nn_f, free_f = flat
                upto = torch.cat([torch.where(use_loc_f, nn_f, 0), torch.where(use_off_f, nn_f, 0)])
                picks2 = _backtrack_bins(cho, par, torch.cat([b0_loc_v.reshape(BN), b0_off_v.reshape(BN)]), upto)
                picks = torch.where(use_off_f[:, None], picks2[BN:], picks2[:BN])
                fa = torch.where(use_off_f, rep(b.gamma), 0.0)
                gate = (planning_f[:, None] & (picks >= 0)) & (ks < nn_f[:, None])
                free_end, acc, proc, miss, npu = _audit_scan(
                    head=rep(st.k), frame_offset=use_off_f.long(), n_frames=rep(b.n_frames),
                    arrivals=fa[:, None] + rep(b.arrivals), deadline=rep(b.deadline), t_npu64=b.t_npu64,
                    acc_stat=rep(b.acc_stat), picks=picks, gate=gate, free0=free_f.clamp_min(0.0),
                    acc_sum=st.accs.reshape(BN), proc=st.proc.reshape(BN), miss=st.miss.reshape(BN),
                    npu_s=st.npus.reshape(BN), strict=strict)
                busy_until = torch.where(use_off_f | use_loc_f, free_end, free_f).view(b.B, N)
                return st._replace(
                    head=head, rounds=rounds,
                    accs=torch.where(planning_v, acc.view(b.B, N), st.accs),
                    proc=torch.where(planning_v, proc.view(b.B, N), st.proc),
                    miss=torch.where(planning_v, miss.view(b.B, N), st.miss),
                    npus=torch.where(planning_v, npu.view(b.B, N), st.npus),
                    busy=torch.where(planning_v, t0[:, None] + busy_until, st.busy))

            return _fleet_program(phys, plan, events)

        state, record = run.drive(key, lanes, _dp_shared(models, c), build, statics=(NBINS, strict, events))
        record["drain_events"] = events
        out = _read(record, _Fleet(*state))
        return _fleet_results(group, out, time.perf_counter() - t_start)

    return _stitch(scenarios, _planner_key, run_group)


def _utility_fleet_lanes(run: _Run, key, models, group, *, width: int, exact: bool, strict: bool):
    """Run max_utility fleets over ``group`` (one shape group, or its lanes
    to rerun) to the end at front ``width``; returns ``(state, record)``."""
    alloc, N, K, F, _, _, W = key
    c = _common(models, _shims(group), W)
    J = c.J
    events = DRAIN_EVENTS
    lanes = dict(_dp_lanes(models, group, c, N, alloc),
                 alpha=np.array([float(s.params["alpha"]) for s in group], np.float64),
                 fps=np.array([s.stream.fps for s in group], np.float64))

    def build(b):
        phys = _Physics(b, alloc, N, K, F)
        net = phys.net
        plan_one = _utility_planner(b, W, J, width, exact)
        ks = torch.arange(W, device=b.device)

        def plan(st, on, t0, released):
            # Each client's DPs depend on its grant, so they run inside the
            # chain: two DP instances over 2B lanes per client.
            act_bps = phys.link_reserved(st)
            for rank in range(N):
                c = b.order[:, rank]
                mine = phys.cids == c[:, None]
                planning = on & (_pick(st.head, c) == st.k)
                grant, denied = phys.allocate(st, c, t0, released, act_bps)
                npu_free = (_pick(st.busy, c) - t0).clamp_min(0.0)
                p = plan_one(npu_free, net.upload(grant), b.rtt)
                st = st._replace(grants=st.grants + (planning & ~denied).long(),
                                 denials=st.denials + (planning & denied).long(),
                                 ovf=st.ovf | (planning & p.ovf))
                st, act_bps = phys.register(
                    st, act_bps, c, on=planning & p.use_off, t0=t0, seq=st.k * N + rank, grant=grant,
                    bits=_pick(b.nbits8, p.r_off), ddl=t0 + b.deadline, acc=p.srv_acc, tsv=b.t_srv[p.j_off])
                head, busy, acc, proc, miss, npu, rounds = _npu_audit(
                    b, p, ks, active=planning, head=_pick(st.head, c), busy=_pick(st.busy, c), t0=t0,
                    npu_free=npu_free, acc_sum=_pick(st.accs, c), proc=_pick(st.proc, c), miss=_pick(st.miss, c),
                    npu_s=_pick(st.npus, c), rounds=_pick(st.rounds, c), strict=strict)
                st = st._replace(head=_set(st.head, mine, head), busy=_set(st.busy, mine, busy),
                                 accs=_set(st.accs, mine, acc), proc=_set(st.proc, mine, proc),
                                 miss=_set(st.miss, mine, miss), npus=_set(st.npus, mine, npu),
                                 rounds=_set(st.rounds, mine, rounds))
            return st

        return _fleet_program(phys, plan, events)

    state, record = run.drive(key, lanes, _dp_shared(models, c), build, statics=(width, exact, strict, events))
    record["drain_events"] = events
    return state, record


@_planner("max_utility")
def _run_max_utility_fleet(models, scenarios, strict, run: _Run):
    def run_group(key, group):
        t_start = time.perf_counter()
        state, record = _utility_fleet_lanes(run, key, models, group, width=_UTIL_FAST_WIDTH, exact=False,
                                             strict=strict)
        out = _read(record, _Fleet(*state))
        flagged = np.nonzero(out["ovf"][:, 0])[0]
        if flagged.size:
            # A front outgrew the fast width, or two utilities met within
            # the epsilon, somewhere in these lanes: rerun just them at the
            # reference's prune cap with the exact keep rule and splice
            # their results back in.
            sub_state, sub_record = _utility_fleet_lanes(run, key, models, [group[i] for i in flagged],
                                                         width=_UTIL_CAP, exact=True, strict=strict)
            sub = _read(sub_record, _Fleet(*sub_state))
            for name, dst in out.items():
                dst[flagged] = sub[name]
            record["reruns"] = sub_record["reruns"] = int(flagged.size)
        return _fleet_results(group, out, time.perf_counter() - t_start)

    return _stitch(scenarios, _planner_key, run_group)


# ---------------------------------------------------------------------------
# The local-only planners: jax_accuracy / jax_utility.  Their plans never
# read the grant, so every client of a homogeneous fleet follows the
# identical trajectory: one lane per scenario runs sim_batch's single-stream
# round and adds the scheduler's grant / denial bookkeeping.  The reference
# still calls ``allocate`` once per client per plan event, and for a fleet
# that never takes a lease the gate outcome factors into a static
# per-client predicate (capacity <= 0, priority reservation, non-positive
# effective weight: ``den0`` clients) and two time-varying shared terms
# (trace bandwidth non-positive, backlog clock past the limit) that deny
# everyone at once.
# ---------------------------------------------------------------------------


def _local_fleet_lanes(group: list[FleetScenario]) -> dict[str, np.ndarray]:
    """The allocation gates that are static for local-only plans: no lease
    is ever taken, so every ``allocate`` sees the same scheduler state and
    only the trace bandwidth and the backlog clock vary.  ``gated`` marks
    non-fifo lanes (fifo always grants)."""
    n_clients = np.array([s.n_clients for s in group], np.int64)
    den0 = np.zeros(len(group), np.int64)
    gated = np.zeros(len(group), bool)
    for i, s in enumerate(group):
        if s.allocation == "fifo":
            continue
        gated[i] = True
        N = s.n_clients
        w = np.array(s.weights if s.weights is not None else (1.0,) * N, np.float64)
        pr = np.array(s.priorities if s.priorities is not None else (0,) * N, np.int64)
        if s.allocation == "priority":
            w_eff = np.array([wi * (2.0 ** int(pi)) for wi, pi in zip(w, pr)], np.float64)
            reserved = np.array([s.capacity <= int(np.sum(pr > pr[ci])) for ci in range(N)], bool)
        else:
            w_eff = w
            reserved = np.zeros(N, bool)
        tot = float(sum(w_eff)) or 1.0
        d0 = (s.capacity <= 0) | reserved | (w_eff <= 0.0) | (tot <= 0.0)
        den0[i] = int(d0.sum())
    bw_t, bw_v, _ = _segments(group)
    return dict(n_clients=n_clients, den0=den0, gated=gated,
                L=np.array([s.backlog_limit for s in group], np.float64), bw_t=bw_t, bw_v=bw_v)


def _local_fleet_build(inner_step: Callable):
    """A local-only fleet round: the scheduler's counters for this plan
    event, then the single-stream round ``inner_step(b)``."""

    def build(b):
        inner = inner_step(b)

        def step(state):
            *core, grants, denials = state
            head = core[0]
            active = head < b.n_frames
            t0 = head.double() * b.gamma
            shared_den = b.gated & (((0.0 - t0) > b.L) | (_trace_bw(b.bw_t, b.bw_v, t0) <= 0.0))
            den_n = torch.where(shared_den, b.n_clients, b.den0)
            grants = grants + torch.where(active, b.n_clients - den_n, 0)
            denials = denials + torch.where(active, den_n, 0)
            return (*inner(tuple(core)), grants, denials)

        return step, lambda: _init_state(b, 5, 2)

    return build


def _replicated_results(group, c, state, record, wall) -> list[tuple[MultiStreamStats, dict]]:
    """Fleet reports for the local-only planners: the per-lane single-stream
    stats copied to every client; the server never runs a job."""
    _, _, acc_sum, npu_s, proc, miss, rounds, grants, denials = state
    out = _Run.read(record, acc_sum, proc, miss, rounds, npu_s, grants, denials)
    base = _collect(c, out[:5], wall)
    return [(MultiStreamStats(per_client=[replace(st) for _ in range(s.n_clients)], server_jobs=0,
                              server_busy_s=0.0, elapsed=st.elapsed),
             {"grants": int(out[5][i]), "denials": int(out[6][i])})
            for i, (s, st) in enumerate(zip(group, base))]


@_planner("jax_accuracy")
def _run_jax_accuracy_fleet(models, scenarios, strict, run: _Run):
    def run_group(W, group):
        c = _common(models, _shims(group), W)
        lanes, NBINS = _jax_accuracy_inputs(c, _shims(group))
        t_start = time.perf_counter()
        build = _local_fleet_build(lambda b: _jax_accuracy_step(b, W, NBINS, strict))
        state, record = run.drive(W, {**lanes, **_local_fleet_lanes(group)},
                                  dict(t_npu64=c.t_npu64, acc32=c.acc_dp32), build, statics=(NBINS, strict))
        return _replicated_results(group, c, state, record, time.perf_counter() - t_start)

    return _stitch(scenarios, lambda s: quant_w(_window_frames(s.stream, s.params)), run_group)


@_planner("jax_utility")
def _run_jax_utility_fleet(models, scenarios, strict, run: _Run):
    def run_group(key, group):
        W, width = key
        c = _common(models, _shims(group), W)
        t_start = time.perf_counter()
        build = _local_fleet_build(lambda b: _jax_utility_step(b, W, width, strict))
        state, record = run.drive(key, {**_jax_utility_inputs(c, _shims(group)), **_local_fleet_lanes(group)},
                                  _jax_utility_shared(c), build, statics=(strict,))
        return _replicated_results(group, c, state, record, time.perf_counter() - t_start)

    return _stitch(
        scenarios, lambda s: (quant_w(_window_frames(s.stream, s.params)), int(s.params["width"])), run_group)


# ---------------------------------------------------------------------------
# Detect+track planners: sim_batch's closed-form round (interval-mean
# candidate scoring, no bin DP) over the shared fleet physics.  Detections
# contend: an offloaded detection registers on the fluid uplink and is
# audited (and installed into the client's detection state) at actual
# on-time completion, the reference's on_offload path, while
# tracker-carried frames are free local work that scores at the plan event
# against the state current there.  The detection state is the
# max-det_frame merge of plan-time NPU refreshes and completed on-time
# offloads, recomputed from the upload logs at every plan event.
# ---------------------------------------------------------------------------


def _run_track_fleet(models, scenarios, strict, run: _Run, *, fixed: bool):
    # ``strict`` has no observable effect: offloads audit at completion, and
    # the track planners emit only deadline-feasible NPU detections.
    del strict
    kname = "k" if fixed else "k_max"
    events = DRAIN_EVENTS

    def key_fn(s: FleetScenario) -> tuple:
        return (*_fleet_key(s), quant_w(int(s.params[kname])))

    def run_group(key, group):
        alloc, N, K, F, resolutions, _, KQ = key
        R = len(resolutions)
        c = _common(models, _shims(group), 1)  # windows are a classify concept
        J = c.J
        k_lim = np.array([int(s.params[kname]) for s in group], np.int64)
        im = np.zeros((len(group), KQ), np.float64)
        if not fixed:
            # interval_means is prefix-stable: padding KQ past a lane's k_max
            # cannot change any entry the planner may select.
            for i, s in enumerate(group):
                im[i, :] = interval_means(retention(float(s.params["decay"]), float(s.params["density"])), KQ)
        ret_pow = np.stack([retention_powers(s.workload.retention, F + 1) for s in group])
        lanes = dict(_fleet_lanes(models, group, N, alloc), gamma=c.gamma, deadline=c.deadline,
                     n_frames=c.n_frames, k_lim=k_lim, im=im, ret_pow=ret_pow, acc_stat=c.acc_stat64)
        shared = dict(t_npu64=c.t_npu64, t_srv=np.array([m.t_server for m in models], np.float64),
                      local=np.isfinite(c.t_npu64))
        t_start = time.perf_counter()

        def build(b):
            phys = _Physics(b, alloc, N, K, F)
            net = phys.net
            inf = phys.inf
            lanes_i = torch.arange(b.B, device=b.device)

            def plan(st, on, t0, released):
                gamma, deadline, t_npu64, acc_stat = b.gamma, b.deadline, b.t_npu64, b.acc_stat
                # Install completed on-time offloaded detections: the newest
                # (max det_frame) against the plan-time NPU state.
                done = (st.q_srvfin + b.rtt[:, None, None]) <= (st.q_ddl + _EPS)
                m_frm = torch.where(done, st.q_detfrm, -1)
                bi = torch.argmax(m_frm, dim=2)  # first max
                srv_frm = _at(m_frm, bi)
                newer = srv_frm > st.det_frm
                det_frm = torch.where(newer, srv_frm, st.det_frm)
                det_acc = torch.where(newer, _at(st.q_acc, bi), st.det_acc)
                # NPU candidates, j ascending: round-invariant npu_interval.
                local = b.local[None, :]
                kf = torch.where(local, torch.ceil(t_npu64[None, :] / gamma[:, None]), 0.0)
                k_npu = torch.clamp_min(kf.long(), 1)  # [B, J]
                act_bps = phys.link_reserved(st)
                zi = torch.zeros_like(st.head)
                planning_v, off0_v, hor_v = zi.bool(), zi, zi
                for rank in range(N):
                    c = b.order[:, rank]
                    mine = phys.cids == c[:, None]
                    planning = on & (_pick(st.head, c) == st.k)
                    grant, denied = phys.allocate(st, c, t0, released, act_bps)
                    st = st._replace(grants=st.grants + (planning & ~denied).long(),
                                     denials=st.denials + (planning & denied).long())
                    npu_free = (_pick(st.busy, c) - t0).clamp_min(0.0)
                    feas_npu = local & ((npu_free[:, None] + t_npu64) <= deadline[:, None]) & \
                        (k_npu <= b.k_lim[:, None])
                    # The reference plans against NetworkState(grant, rtt).
                    t_up = net.upload(grant)
                    j_best, a_best, r_ok = net.best_server(t_up, deadline, b.rtt)
                    k_srv = torch.floor(torch.where(r_ok, t_up, 0.0) / gamma[:, None]).long() + 1
                    feas_srv = r_ok & (k_srv <= b.k_lim[:, None])
                    if fixed:
                        s_npu = torch.where(feas_npu, acc_stat, -inf)
                        s_srv = torch.where(feas_srv, a_best, -inf)
                    else:
                        s_npu = torch.where(feas_npu, acc_stat * b.im.gather(1, (k_npu - 1).clamp(0, KQ - 1)), -inf)
                        s_srv = torch.where(feas_srv, a_best * b.im.gather(1, (k_srv - 1).clamp(0, KQ - 1)), -inf)
                    # NPU-then-server candidate order with strict > first-wins
                    # is a first-maximum argmax over the concatenation.
                    scores = torch.cat([s_npu, s_srv], dim=1)
                    idx = torch.argmax(scores, dim=1)
                    exists = _pick(scores, idx) > -inf
                    is_npu = exists & (idx < J)
                    is_srv = exists & ~is_npu
                    j_pick = idx.clamp(0, J - 1)
                    r_pick = (idx - J).clamp(0, R - 1)
                    k_det = torch.where(is_npu, _pick(k_npu, j_pick), _pick(k_srv, r_pick))
                    horizon = b.k_lim if fixed else torch.where(exists, k_det, 1)  # fixed: consumed even on SKIP
                    # NPU detection: scored and state-refreshed at the plan event.
                    npu_take = planning & is_npu
                    acc_j = _pick(acc_stat, j_pick)
                    took = mine & npu_take[:, None]
                    det_acc = torch.where(took, acc_j[:, None], det_acc)
                    det_frm = torch.where(took, st.k[:, None], det_frm)
                    # Offloaded detection: registered on the shared link
                    # (audited and installed at actual completion); the state
                    # stays stale for this round's tracked frames.
                    j_star = _pick(j_best, r_pick)
                    st, act_bps = phys.register(
                        st, act_bps, c, on=planning & is_srv, t0=t0, seq=st.k * N + rank, grant=grant,
                        bits=_pick(b.nbits8, r_pick), ddl=t0 + deadline, acc=b.acc_sv[lanes_i, j_star, r_pick],
                        tsv=b.t_srv[j_star], det_frm=st.k)
                    t_j = t_npu64[j_pick]
                    busy_until = torch.where(is_npu, npu_free + t_j, npu_free)
                    plans = mine & planning[:, None]
                    st = st._replace(
                        accs=st.accs + torch.where(took, acc_j[:, None], 0.0),
                        proc=st.proc + took.long(),
                        npus=st.npus + torch.where(took, t_j[:, None], 0.0),
                        busy=torch.where(plans, (t0 + busy_until)[:, None], st.busy),
                        head=st.head + torch.where(plans, horizon[:, None], 0),
                        rounds=st.rounds + plans.long())
                    planning_v = _set(planning_v, mine, planning)
                    off0_v = _set(off0_v, mine, exists.long())
                    hor_v = _set(hor_v, mine, horizon)
                # Tracked frames depend only on each client's own post-plan
                # state: ascending frame order per client, the
                # apply_track_round accumulation order, over [B, N].
                accs, proc = st.accs, st.proc
                for o in range(KQ):
                    on_o = planning_v & (o >= off0_v) & (o < hor_v) & ((st.k[:, None] + o) < b.n_frames[:, None])
                    age = (st.k[:, None] + o - det_frm).clamp(0, F)
                    v = _no_fma(det_acc * b.ret_pow.gather(1, age))
                    accs = accs + torch.where(on_o, v, 0.0)
                    proc = proc + on_o.long()
                return st._replace(accs=accs, proc=proc, det_acc=det_acc, det_frm=det_frm)

            return _fleet_program(phys, plan, events)

        state, record = run.drive(key, lanes, shared, build, statics=(fixed, events))
        record["drain_events"] = events
        out = _read(record, _Fleet(*state))
        return _fleet_results(group, out, time.perf_counter() - t_start)

    return _stitch(scenarios, key_fn, run_group)


@_planner("track_accuracy")
def _run_track_accuracy_fleet(models, scenarios, strict, run: _Run):
    return _run_track_fleet(models, scenarios, strict, run, fixed=False)


@_planner("track_fixed")
def _run_track_fixed_fleet(models, scenarios, strict, run: _Run):
    return _run_track_fleet(models, scenarios, strict, run, fixed=True)
