"""Lane-batched online engine: observe -> replan -> execute for whole grids.

``Session.run_online`` replays the paper's §VI adaptivity story one Python
round at a time: the policy plans against the EWMA belief of
:class:`~repro_torch.core.controller.BandwidthEstimator` (bandwidth shaded
by the pessimism factor, RTT seeded from the first observation), while
execution is audited against the *true* trace: offload finish times are
recomputed at the real bandwidth over a serially occupied uplink, and each
upload feeds the estimator back.  This module runs that loop for a *group*
of scenarios at once on a torch device, as :mod:`.sim_batch` runs the
oracle-bandwidth simulator: every per-scenario value is a tensor with a
leading lane axis, and each round carries the estimator state (EWMA bps,
believed RTT) and the true link's occupancy next to the audit accumulators.
On the card a shape group's round is a captured
:class:`~repro_torch.core.sweep_shard.LaneProgram`.

Exactness contract (held against the reference in
``tests/test_torch_online_batch.py``): for every scenario, integer stats
(processed / missed / offloaded / rounds) are exact, accuracy sums match
the Python ``run_online`` within :data:`~repro_torch.core.audit.AUDIT_TOL`,
and the final believed bandwidth ``estimated_bps`` is bit for bit.  The
planning phase is the network-aware planners' of :mod:`.sim_batch`, with
two substitutions: the bandwidth the planner sees is the carried belief
``bps * pessimism`` instead of a trace lookup, and the RTT is the carried
believed RTT instead of the constant.  The execution phase renders
``run_online``'s offload callback:

  * ``start = max(net_free, t0)``: the true link is a serial resource
    carried across rounds (a belief-driven offload storm queues up);
  * ``finish = ((start + t_up_true) + rtt_true) + t_server``, compared
    against ``(t0 + deadline) + AUDIT_TOL`` whatever ``strict`` says (only
    the plan-side NPU audits are strict-gated);
  * the estimator updates ``bps <- (1-beta)*bps + beta*sample`` with
    ``sample = nbits / t_up_true``, divided twice as the reference rounds
    it (0 on a dead link: the belief decays, and is never poisoned by
    ``inf``).  Every product here is its own op, rounded before the add it
    feeds, and every divisor is a per-lane device tensor (a division by a
    Python number may run as a multiply by its reciprocal on the card); no
    fused op (``addcmul``, ``lerp``, ``alpha=``) may replace them.

The reference guards the same arithmetic against XLA's rewrites with an
optimization barrier and a vmap batching rule for it
(``_install_barrier_batching`` / ``_barrier``).  Eager PyTorch and a
captured CUDA graph rewrite no arithmetic, so neither is ported.

Only the head frame of a round ever offloads (both planners emit a single
SERVER decision at frame 0), so each round makes at most one estimator
observation pair, as the reference does.  Policies registered
``batched_online=True`` have a planner here; ``Session.run_sweep(mode=
"online")`` runs the per-point ``run_online`` loop for every other policy.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .audit import AUDIT_TOL
from .jax_sched import _no_fma
from .profiles import ModelProfile, StreamSpec
from .registry import get_policy
from .schedule import StreamStats
from . import sim_batch
from .sim_batch import (
    _UTIL_CAP,
    _accuracy_inputs,
    _accuracy_planner,
    _collect,
    _common,
    _init_state,
    _Net,
    _net_group_key,
    _npu_audit,
    _pick,
    _Plan,
    _Run,
    _shared,
    _stitch,
    _utility_inputs,
    _utility_planner,
)

__all__ = ["OnlineScenario", "batched_online_policies", "simulate_online_batch"]


@dataclass(frozen=True)
class OnlineScenario:
    """One online grid point: the scenario a ``run_online`` call would see.

    ``bw_segments`` / ``rtt`` describe the **true** network (the piecewise
    layout of :class:`~repro_torch.core.sim_batch.BatchScenario`); the
    estimator fields describe the belief.  ``init_bps=None`` seeds the
    belief from the true trace at t=0, as ``run_online``'s
    ``BandwidthEstimator(init_bps=trace.at(0.0).bandwidth_bps)``, and the
    believed RTT always seeds from the true RTT (``run_online``'s pre-loop
    ``observe_rtt(trace.at(0.0).rtt)``, whose first sample replaces the
    stub prior)."""

    stream: StreamSpec = field(default_factory=StreamSpec)
    n_frames: int = 120
    params: Mapping[str, Any] = field(default_factory=dict)
    rtt: float = 0.100
    bw_segments: tuple[tuple[float, float], ...] = ((0.0, 2.5e6),)
    init_bps: float | None = None
    beta: float = 0.3
    pessimism: float = 0.9


_ONLINE: dict[str, Callable[..., list[tuple[StreamStats, dict]]]] = {}


def _online(name: str):
    def deco(fn):
        _ONLINE[name] = fn
        return fn

    return deco


def batched_online_policies() -> tuple[str, ...]:
    """Policy names with an online backend (mirrors ``batched_online=True``
    in the registry; ``tests/test_torch_online_batch.py`` asserts the
    two stay in sync)."""
    return tuple(sorted(_ONLINE))


def simulate_online_batch(
    policy: str,
    models: Sequence[ModelProfile],
    scenarios: Sequence[OnlineScenario],
    *,
    strict: bool = True,
    device: torch.device | str = "cuda",
    groups: list[dict[str, Any]] | None = None,
) -> list[tuple[StreamStats, dict]]:
    """Run the online loop for ``policy`` over every scenario, lane-batched
    on ``device``.  Returns ``(stats, meta)`` per scenario in order, where
    ``meta`` carries what ``run_online`` reports: the round count and the
    estimator's final believed bandwidth (``estimated_bps``).  Raises
    ``ValueError`` for policies without an online backend; the per-point
    fallback lives in ``Session.run_sweep(mode="online")``.  Where
    ``groups`` is a list, one record per shape group is appended to it, as
    :func:`~repro_torch.core.sim_batch.simulate_batch` does."""
    fn = _ONLINE.get(policy)
    if fn is None:
        raise ValueError(
            f"policy {policy!r} has no batched online backend; "
            f"available: {batched_online_policies()}"
        )
    get_policy(policy)  # surface unknown-policy errors with the registry text
    dev = resolve_device(device)
    if not scenarios:
        return []
    log = groups if groups is not None else []
    return fn(list(models), list(scenarios), bool(strict), _Run(dev, policy, log))


def _bw_at0(segments: Sequence[tuple[float, float]]) -> float:
    """True bandwidth at t=0 under ``Trace.piecewise`` semantics: the last
    segment with ``t_start <= 0`` wins; before the first segment's start the
    first value applies."""
    segs = sorted((float(t), float(v)) for t, v in segments) or [(0.0, 0.0)]
    v0 = segs[0][1]
    for t, v in segs:
        if t <= 0.0:
            v0 = v
    return v0


def _estimator_arrays(group: list[OnlineScenario]) -> dict[str, np.ndarray]:
    """Per-lane estimator constants: beta, (1-beta) (computed once, the same
    f64 subtraction the reference performs per call), pessimism, and the
    belief's initial bandwidth."""
    beta = np.array([s.beta for s in group], np.float64)
    return dict(
        beta=beta,
        omb=1.0 - beta,
        pess=np.array([s.pessimism for s in group], np.float64),
        bps0=np.array([s.init_bps if s.init_bps is not None else _bw_at0(s.bw_segments) for s in group],
                      np.float64),
    )


def _with_meta(stats: list[StreamStats], bps_final, pess) -> list[tuple[StreamStats, dict]]:
    # estimator.state().bandwidth_bps == _bps * pessimism: the belief the
    # next round would have planned with.
    return [
        (st, {"rounds": int(st.schedule_calls), "estimated_bps": float(b * p)})
        for st, b, p in zip(stats, np.asarray(bps_final), np.asarray(pess))
    ]


# ---------------------------------------------------------------------------
# The shared execution phase: run_online's offload callback as tensor
# expressions.  The planning phase decided use_off / r_off / j_off from the
# *belief*; this completes the head-frame upload on the *true* network,
# keeps the link serially occupied, and feeds the estimator back.
# ---------------------------------------------------------------------------


def _true_offload(b, net: _Net, p: _Plan, *, active, t0, bps, rttb, netf, acc_sum, proc, miss, offl):
    nbits = _pick(b.nbits8, p.r_off)
    bw_true = net.bandwidth(t0)  # the reference's trace.at(t0)
    tup_t = torch.where(bw_true > 0.0, nbits / bw_true, net.inf)
    start = torch.maximum(netf, t0)  # d.start == 0.0 for both planners' heads
    fin = ((start + tup_t) + b.rtt) + b.t_srv[p.j_off]
    ok = fin <= (t0 + b.deadline) + AUDIT_TOL  # true completion: never strict-gated
    sent = active & p.use_off
    srv_take = sent & ok
    acc_sum = acc_sum + torch.where(srv_take, p.srv_acc, 0.0)
    proc = proc + srv_take.long()
    offl = offl + srv_take.long()
    miss = miss + (sent & ~ok).long()
    netf = torch.where(sent, start + tup_t, netf)
    # observe_upload: sample = nbits / seconds, the second of two divisions
    # by device tensors; a dead link (t_up = inf) still observes, and its
    # sample 0.0 decays the belief.
    sample = torch.where(tup_t > 0.0, nbits / tup_t, 0.0)
    upd = sent & (tup_t > 0.0)  # observe_upload's <= 0 guard (never met here)
    bps = torch.where(upd, _no_fma(b.omb * bps) + _no_fma(b.beta * sample), bps)
    rttb = torch.where(sent, _no_fma(b.omb * rttb) + _no_fma(b.beta * b.rtt), rttb)  # observe_rtt: no guard
    return bps, rttb, netf, acc_sum, proc, miss, offl


def _online_step(b, plan, W: int, strict: bool, *, utility: bool):
    """One online round for every lane: plan against the carried belief,
    execute the head offload on the true network, audit the NPU frames."""
    net = _Net(b)
    ks = torch.arange(W, device=b.device)

    def step(state):
        head, busy, bps, rttb, netf, acc_sum, npu_s, proc, miss, offl, rounds = state[:11]
        active = head < b.n_frames
        t0 = _no_fma(head.double() * b.gamma)
        npu_free = torch.clamp_min(busy - t0, 0.0)
        # estimator.state(): the belief, not a trace lookup.
        p = plan(npu_free, net.upload(_no_fma(bps * b.pess)), rttb)
        bps, rttb, netf, acc_sum, proc, miss, offl = _true_offload(
            b, net, p, active=active, t0=t0, bps=bps, rttb=rttb, netf=netf, acc_sum=acc_sum, proc=proc,
            miss=miss, offl=offl)
        head, busy, acc_sum, proc, miss, npu_s, rounds = _npu_audit(
            b, p, ks, active=active, head=head, busy=busy, t0=t0, npu_free=npu_free, acc_sum=acc_sum,
            proc=proc, miss=miss, npu_s=npu_s, rounds=rounds, strict=strict)
        out = (head, busy, bps, rttb, netf, acc_sum, npu_s, proc, miss, offl, rounds)
        return out + (state[11] | (active & p.ovf),) if utility else out

    def init():
        # Belief seeds: init_bps, and the pre-loop observe_rtt of the true RTT.
        head, busy, netf, acc_sum, npu_s, proc, miss, offl, rounds = _init_state(b, 4, 3)
        state = (head, busy, b.bps0.clone(), b.rtt.clone(), netf, acc_sum, npu_s, proc, miss, offl, rounds)
        return state + (torch.zeros(b.B, dtype=torch.bool, device=b.device),) if utility else state

    return step, init


def _read(run: _Run, record: dict, state, *extra) -> list[np.ndarray]:
    """acc_sum, processed, missed, rounds, NPU seconds, offloaded, final bps
    (then ``extra``) of a group's real lanes, in one copy to the host."""
    bps, (acc_sum, npu_s, proc, miss, offl, rounds) = state[2], state[5:11]
    return run.read(record, acc_sum, proc, miss, rounds, npu_s, offl, bps, *extra)


# ---------------------------------------------------------------------------
# Max-Accuracy online: sim_batch's planning phase against the belief.
# ---------------------------------------------------------------------------


@_online("max_accuracy")
def _run_online_max_accuracy(models, scenarios, strict, run: _Run):
    def run_group(key, group):
        W, _ = key
        c = _common(models, group, W)
        lanes, NBINS = _accuracy_inputs(models, c, group)
        est = _estimator_arrays(group)
        t_start = time.perf_counter()

        def build(b):
            return _online_step(b, _accuracy_planner(b, W, NBINS), W, strict, utility=False)

        state, record = run.drive(key, {**lanes, **est}, _shared(models, c), build, statics=(NBINS, strict))
        out = _read(run, record, state)
        stats = _collect(c, out[:5], time.perf_counter() - t_start, offloaded=out[5])
        return _with_meta(stats, out[6], est["pess"])

    return _stitch(scenarios, _net_group_key, run_group)


# ---------------------------------------------------------------------------
# Max-Utility online: the same substitution, keeping the fast-width pass
# and the rerun of flagged lanes (a front that outgrew the fast width, or a
# 1e-12 utility tie its keep rule cannot settle) at the exact cap.  A
# flagged lane reruns the whole online loop: its estimator state diverges
# from the first round on, so only a rerun from the start is exact.
# ---------------------------------------------------------------------------


def _online_utility_lanes(run: _Run, key, models, group, *, width: int, exact: bool, strict: bool):
    c = _common(models, group, key[0])
    est = _estimator_arrays(group)

    def build(b):
        return _online_step(b, _utility_planner(b, c.W, c.J, width, exact), c.W, strict, utility=True)

    state, record = run.drive(key, {**_utility_inputs(models, c, group), **est}, _shared(models, c), build,
                              statics=(width, exact, strict))
    return c, est, state, record


@_online("max_utility")
def _run_online_max_utility(models, scenarios, strict, run: _Run):
    def run_group(key, group):
        t_start = time.perf_counter()
        c, est, state, record = _online_utility_lanes(run, key, models, group, width=sim_batch._UTIL_FAST_WIDTH,
                                                      exact=False, strict=strict)
        out = _read(run, record, state, state[11])
        flagged = np.nonzero(out[7])[0]
        if flagged.size:
            _, _, sub, sub_record = _online_utility_lanes(run, key, models, [group[i] for i in flagged],
                                                          width=_UTIL_CAP, exact=True, strict=strict)
            for dst, src in zip(out[:7], _read(run, sub_record, sub)):
                dst[flagged] = src
            record["reruns"] = sub_record["reruns"] = int(flagged.size)
        stats = _collect(c, out[:5], time.perf_counter() - t_start, offloaded=out[5])
        return _with_meta(stats, out[6], est["pess"])

    return _stitch(scenarios, _net_group_key, run_group)
