"""Event-driven stream simulator: executes any policy's round plans over a
video trace with a (possibly time-varying) network, and audits feasibility.

The simulator is the ground truth for every figure benchmark: policies only
*propose* plans; accuracy/utility are re-derived here from the profiles, and
``validate_plan`` rejects any deadline/overlap violation (a violating frame
counts as missed, accuracy 0 — defence against buggy policies).

Two entry points, plain-Python transcriptions of the reference's loops
(their stats are the reference's, bit for bit):
  simulate        one stream, the paper's setting (§VI figures);
  simulate_multi  N streams contending for one shared uplink + edge server,
                  driven by ``edge_server.EdgeServerScheduler``.  Uploads share
                  the link as a fluid: each in-flight transfer gets a
                  weight-proportional share of ``Trace`` bandwidth, capped at
                  its scheduler-granted rate — so coordinated clients see
                  exactly what they were promised, while uncoordinated (fifo)
                  clients stretch each other's uploads and miss deadlines.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Protocol, Sequence

from .audit import TrackState, apply_round, apply_track_round, audit_round
from .edge_server import fluid_rates
from .profiles import ModelProfile, NetworkState, StreamSpec
from .schedule import RoundPlan, StreamStats
from .tracking import WorkloadSpec


class Policy(Protocol):
    def __call__(
        self,
        models: Sequence[ModelProfile],
        stream: StreamSpec,
        net: NetworkState,
        *,
        npu_free: float,
    ) -> RoundPlan: ...


@dataclass
class Trace:
    """Bandwidth/RTT as functions of time (seconds) — supports live variation."""

    bandwidth_bps: Callable[[float], float]
    rtt: Callable[[float], float] = lambda t: 0.100

    @staticmethod
    def constant(mbps: float, rtt_ms: float = 100.0) -> "Trace":
        return Trace(lambda t: mbps * 1e6, lambda t: rtt_ms / 1e3)

    @staticmethod
    def piecewise(points: Sequence[tuple[float, float]], rtt_ms: float = 100.0) -> "Trace":
        """points: [(t_start, mbps), ...] with strictly increasing t_start.

        Non-monotonic time points or negative bandwidth raise ``ValueError``.
        """
        pts = list(points)
        if not pts:
            raise ValueError("piecewise trace needs at least one (t_start, mbps) point")
        for (t0, _), (t1, _) in zip(pts, pts[1:]):
            if t1 <= t0:
                raise ValueError(
                    f"piecewise trace time points must be strictly increasing, "
                    f"got t={t1!r} after t={t0!r}"
                )
        for ts, v in pts:
            if v < 0:
                raise ValueError(
                    f"piecewise trace bandwidth must be >= 0 Mbps, got {v!r} at t={ts!r}"
                )

        def bw(t: float) -> float:
            cur = pts[0][1]
            for ts, v in pts:
                if t >= ts:
                    cur = v
                else:
                    break
            return cur * 1e6

        return Trace(bw, lambda t: rtt_ms / 1e3)

    def at(self, t: float) -> NetworkState:
        return NetworkState(bandwidth_bps=self.bandwidth_bps(t), rtt=self.rtt(t))


def simulate(
    policy: Policy,
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    trace: Trace,
    n_frames: int,
    *,
    strict: bool = True,
    workload: WorkloadSpec | None = None,
) -> StreamStats:
    """Run ``policy`` over ``n_frames`` frames; return audited stream stats.

    The audit semantics (what validates, what scores, what counts missed)
    live in :mod:`repro_torch.core.audit`.

    ``workload`` selects the frame semantics: ``None`` / ``"classify"``
    keeps the paper's independent frames; ``"track"`` executes rounds as
    detect+track intervals (``audit.apply_track_round``), carrying the
    detection-age state across rounds.
    """
    track = workload is not None and workload.is_track
    ret = workload.retention if track else 0.0
    state = TrackState()
    stats = StreamStats(frames_total=n_frames, elapsed=n_frames * stream.gamma)
    gamma = stream.gamma
    head = 0
    npu_busy_abs = 0.0
    while head < n_frames:
        t0 = head * gamma
        net = trace.at(t0)
        wall = time.perf_counter()
        plan = policy(models, stream, net, npu_free=max(0.0, npu_busy_abs - t0))
        stats.schedule_time += time.perf_counter() - wall
        stats.schedule_calls += 1

        horizon, bad_frames = audit_round(
            plan, gamma=gamma, deadline=stream.deadline, strict=strict
        )
        if track:
            state = apply_track_round(
                stats,
                plan,
                models=models,
                stream=stream,
                state=state,
                head=head,
                n_frames=n_frames,
                horizon=horizon,
                bad_frames=bad_frames,
                retention=ret,
            )
        else:
            apply_round(
                stats,
                plan,
                models=models,
                stream=stream,
                head=head,
                n_frames=n_frames,
                horizon=horizon,
                bad_frames=bad_frames,
            )
        npu_busy_abs = t0 + plan.npu_busy_until
        head += horizon
    return stats


def make_policy(
    name: str, *, alpha: float | None = None, device: Any = "cuda", **kw
) -> Policy:
    """Deprecated shim over the policy registry — prefer ``PolicySpec``.

    Builds the named policy through :mod:`repro_torch.core.registry`, so
    unknown names, unknown parameters, and a missing required ``alpha``
    (e.g. for ``max_utility``) all raise ``ValueError`` instead of being
    silently swallowed.  ``alpha=None`` is dropped before validation because
    the legacy signature passed it unconditionally.  ``device`` goes to
    ``PolicySpec.build``.
    """
    import warnings

    from .registry import PolicySpec

    warnings.warn(
        "make_policy() is deprecated; construct policies with "
        "repro_torch.core.registry.PolicySpec(name, params) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    params = dict(kw)
    if alpha is not None:
        params["alpha"] = alpha
    return PolicySpec(name, params).build(device=device)


# ---------------------------------------------------------------------------
# Multi-stream simulation: N clients, one shared uplink, one edge server.
# ---------------------------------------------------------------------------

_EPS = 1e-9
# An upload also counts as delivered below this many residual bits (far below
# any real frame — smallest is ~24k bits).  The primary completion mechanism
# is by event identity (see ``due`` in ``simulate_multi``); this threshold
# only mops up transfers that cross zero during a planning-event advance.
_BITS_EPS = 1e-3


@dataclass
class _Upload:
    """One in-flight offloaded frame on the shared (fluid) uplink."""

    client_id: int
    bits_left: float
    weight: float
    rate_cap: float  # scheduler-granted bps; inf under the fifo policy
    deadline_abs: float
    accuracy: float
    t_server: float
    rtt: float
    start_at: float = 0.0  # abs time the frame exists and may start uploading
    # Tracking workload only: absolute frame index of the detection this
    # upload carries (-1 for classification frames).  On on-time completion
    # the client's TrackState refreshes iff this is newer than what a later
    # NPU detection may already have installed.
    det_frame: int = -1


@dataclass
class MultiStreamStats:
    """Per-client audited stats plus fleet-level aggregates."""

    per_client: list[StreamStats]
    server_jobs: int = 0
    server_busy_s: float = 0.0
    elapsed: float = 0.0

    @property
    def aggregate_accuracy(self) -> float:
        """Fleet mean accuracy over all frames of all clients (missed = 0)."""
        total = sum(s.frames_total for s in self.per_client)
        return sum(s.accuracy_sum for s in self.per_client) / total if total else 0.0

    @property
    def miss_rates(self) -> list[float]:
        return [
            s.frames_missed_deadline / s.frames_total if s.frames_total else 0.0
            for s in self.per_client
        ]

    @property
    def max_miss_rate(self) -> float:
        return max(self.miss_rates, default=0.0)

    @property
    def server_utilization(self) -> float:
        return self.server_busy_s / self.elapsed if self.elapsed > 0 else 0.0


def _fluid_rates(bandwidth_bps: float, uploads: Sequence[_Upload]) -> list[float]:
    """Weighted max-min (water-filling) split of the link across uploads.

    Pure arithmetic lives in :func:`repro_torch.core.edge_server.fluid_rates`;
    this wrapper just unpacks the in-flight ``_Upload`` records.
    """
    return fluid_rates(
        bandwidth_bps,
        [u.weight for u in uploads],
        [u.rate_cap for u in uploads],
        eps=_EPS,
    )


def simulate_multi(
    scheduler,
    trace: Trace,
    n_frames: int,
    *,
    strict: bool = True,
    workload: WorkloadSpec | None = None,
) -> MultiStreamStats:
    """Drive every client of ``scheduler`` (an ``EdgeServerScheduler``) for
    ``n_frames`` frames each over one shared ``trace``.

    Event loop: the next event is either some client's round boundary (it
    plans against its *allocated* bandwidth) or an upload completing on the
    fluid link.  NPU decisions are audited exactly as in :func:`simulate`;
    offloaded frames are audited at *actual* completion — shared-link upload
    time, then a server worker (FIFO queue over ``scheduler.capacity`` slots),
    then the RTT — so a plan that assumed more bandwidth than the link really
    delivers shows up as deadline misses here, not as optimistic accuracy.

    With a tracking ``workload``, detections contend on the shared link but
    tracker-carried frames do not: NPU detections refresh the client's
    detection state at the planning event, offloaded detections at their
    *actual* on-time completion (guarded by detection recency, so a slow
    upload never clobbers a newer NPU detection), and tracked frames score
    against the state current at their round's planning event.
    """
    scheduler.reset()  # clock restarts at 0; stale leases/backlog must not leak in
    track = workload is not None and workload.is_track
    ret = workload.retention if track else 0.0
    clients = list(scheduler.clients.values())
    stats = {
        c.client_id: StreamStats(frames_total=n_frames, elapsed=n_frames * c.stream.gamma)
        for c in clients
    }
    tstate = {c.client_id: TrackState() for c in clients}
    head = {c.client_id: 0 for c in clients}
    npu_busy_abs = {c.client_id: 0.0 for c in clients}
    uploads: list[_Upload] = []
    n_workers = max(int(scheduler.capacity), 1)
    worker_free = [0.0] * n_workers
    server_jobs = 0
    server_busy = 0.0
    now = 0.0

    def next_plan_event() -> tuple[float, "object"] | None:
        best = None
        for c in clients:
            if head[c.client_id] >= n_frames:
                continue
            t = head[c.client_id] * c.stream.gamma
            key = (t, -c.priority, -c.weight, c.client_id)
            if best is None or key < best[0]:
                best = (key, c)
        return (best[0][0], best[1]) if best is not None else None

    # Server-slot leases are held until the job leaves the server, not just
    # until its upload drains: (abs finish time, client_id), kept sorted.
    pending_releases: list[tuple[float, int]] = []

    while True:
        plan_ev = next_plan_event()
        # Earliest upload completion under current rates (piecewise-constant
        # approximation: rates are re-evaluated at every event boundary).
        # A client's radio is serial: only its OLDEST pending upload transmits
        # (later frames of a multi-offload round queue behind it), and frames
        # that have not arrived yet (start_at in the future) hold no link
        # share; their activation is an event of its own.
        heads: dict[int, _Upload] = {}
        for u in uploads:
            heads.setdefault(u.client_id, u)
        active = [u for u in heads.values() if u.start_at <= now + _EPS]
        rates = _fluid_rates(trace.at(now).bandwidth_bps, active) if active else []
        t_done = None
        due: list[_Upload] = []
        if active:
            finish_at = [
                now + (u.bits_left / r if r > _EPS else float("inf"))
                for u, r in zip(active, rates)
            ]
            t_done = min(finish_at)
            if t_done < float("inf"):
                # Completion events drain by identity, not by a residual-bits
                # threshold: near the end of a transfer the remaining time can
                # underflow ``now + dt == now`` and a threshold test livelocks.
                due = [u for u, t in zip(active, finish_at) if t <= t_done + _EPS]
            else:
                t_done = None
        t_start = min(
            (u.start_at for u in heads.values() if u.start_at > now + _EPS), default=None
        )
        events = [t for t in (t_done, t_start) if t is not None]
        if plan_ev is not None:
            events.append(plan_ev[0])
        if not events:
            break
        t_next = min(events)
        client = plan_ev[1] if plan_ev is not None and plan_ev[0] <= t_next + _EPS else None

        # Advance the fluid link to t_next (active uploads only).
        if active and t_next > now:
            for u, r in zip(active, rates):
                u.bits_left = max(0.0, u.bits_left - r * (t_next - now))
        if t_done is not None and t_next >= t_done - _EPS:
            for u in due:  # this IS the completion event for these uploads
                u.bits_left = 0.0
        now = max(now, t_next)

        # Free server slots whose jobs have finished by now.
        while pending_releases and pending_releases[0][0] <= now + _EPS:
            scheduler.release(pending_releases.pop(0)[1])

        # Drain any uploads that finished: server queue, then deadline audit.
        # Only head uploads can have transmitted, so queued ones stay put.
        still: list[_Upload] = []
        for u in uploads:
            if u.bits_left > _BITS_EPS or u.start_at > now + _EPS:
                still.append(u)
                continue
            scheduler.release_link(u.client_id)
            wi = min(range(n_workers), key=lambda i: worker_free[i])
            start = max(now, worker_free[wi])
            finish = start + u.t_server
            worker_free[wi] = finish
            server_jobs += 1
            server_busy += u.t_server
            pending_releases.append((finish, u.client_id))
            pending_releases.sort()
            s = stats[u.client_id]
            if finish + u.rtt <= u.deadline_abs + _EPS:
                s.frames_processed += 1
                s.frames_offloaded += 1
                s.accuracy_sum += u.accuracy
                if track and u.det_frame > tstate[u.client_id].det_frame:
                    tstate[u.client_id] = TrackState(u.accuracy, u.det_frame)
            else:
                s.frames_missed_deadline += 1
        uploads = still

        if client is None:
            continue

        # Round boundary for ``client``: allocate, plan, execute.
        cid = client.client_id
        t0 = head[cid] * client.stream.gamma
        net_full = trace.at(t0)
        grant = scheduler.allocate(cid, t0, net_full)
        net_c = NetworkState(bandwidth_bps=grant, rtt=net_full.rtt)
        s = stats[cid]
        wall = time.perf_counter()
        plan = client.plan(net_c, npu_free=max(0.0, npu_busy_abs[cid] - t0))
        s.schedule_time += time.perf_counter() - wall
        s.schedule_calls += 1

        horizon, bad_frames = audit_round(
            plan,
            gamma=client.stream.gamma,
            deadline=client.stream.deadline,
            strict=strict,
            npu_only=True,
        )

        def offload(d, m, *, cid=cid, client=client, t0=t0, grant=grant, rtt=net_full.rtt):
            # SERVER: hand to the shared link; audited on completion.
            scheduler.register(cid, grant, t=t0, server_s=m.t_server)
            uploads.append(
                _Upload(
                    client_id=cid,
                    bits_left=client.stream.frame_bytes(d.resolution) * 8.0,
                    weight=max(client.weight, _EPS),
                    rate_cap=grant if scheduler.policy != "fifo" else float("inf"),
                    deadline_abs=t0 + d.frame * client.stream.gamma + client.stream.deadline,
                    accuracy=m.accuracy(d.resolution, where="server"),
                    t_server=m.t_server,
                    rtt=rtt,
                    # The plan's start is round-relative; a frame cannot
                    # transmit before it exists (matters for policies that
                    # offload non-head frames, e.g. DeepDecision).
                    start_at=t0 + max(d.start, 0.0),
                    # Tracking: the upload carries this round's detection.
                    det_frame=head[cid] + d.frame if track else -1,
                )
            )

        if track:
            tstate[cid] = apply_track_round(
                s,
                plan,
                models=client.models,
                stream=client.stream,
                state=tstate[cid],
                head=head[cid],
                n_frames=n_frames,
                horizon=horizon,
                bad_frames=bad_frames,
                retention=ret,
                on_offload=offload,
            )
        else:
            apply_round(
                s,
                plan,
                models=client.models,
                stream=client.stream,
                head=head[cid],
                n_frames=n_frames,
                horizon=horizon,
                bad_frames=bad_frames,
                on_offload=offload,
            )
        npu_busy_abs[cid] = t0 + plan.npu_busy_until
        head[cid] += horizon

    # Uploads stranded at exit (link went dead with frames in flight): every
    # one is a deadline miss, and its leases must not leak.
    for u in uploads:
        scheduler.release_link(u.client_id)
        scheduler.release(u.client_id)
        stats[u.client_id].frames_missed_deadline += 1
    for _, cid in pending_releases:
        scheduler.release(cid)

    elapsed = max((s.elapsed for s in stats.values()), default=0.0)
    return MultiStreamStats(
        per_client=[stats[c.client_id] for c in clients],
        server_jobs=server_jobs,
        server_busy_s=server_busy,
        elapsed=elapsed,
    )
