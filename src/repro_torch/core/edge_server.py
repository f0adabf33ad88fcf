"""Multi-stream edge-server scheduling: N clients share one uplink + one edge.

The paper (and this package's §IV/§V solvers) plan for ONE phone talking to
an idle edge server.  Here an :class:`EdgeServerScheduler` admits N
concurrent :class:`EdgeClient` streams, splits the shared uplink bandwidth and
the server's worker pool across them, and lets each client fall back to its
local NPU plan when the edge is saturated.  The per-stream Max-Accuracy /
Max-Utility solvers are reused unchanged as the inner loop — a client simply
plans against the *allocated* share of the link instead of the whole link, and
both solvers already degrade to a pure-local plan when their bandwidth is too
small to offload.

Allocation policies (``EdgeServerScheduler(policy=...)``):

  weighted_fair  static weighted share: client i may lease at most
                 ``B * w_i / sum_j w_j`` of the link, further clipped to what
                 is left unleased — so concurrent grants never exceed B.
  priority       weighted-fair with effective weight ``w_i * 2**priority_i``,
                 plus slot reservation: a client is denied an offload slot
                 while every free server worker is "spoken for" by a distinct
                 higher-priority client that holds no slot.
  fifo           the naive baseline: every client assumes it owns the whole
                 link and the server admits jobs first-come-first-served.
                 Under contention the fluid link model (simulator.simulate_multi)
                 stretches the overlapping uploads and deadlines blow up —
                 this is the strawman the coordinated policies beat.

The scheduler is deliberately *mechanism only*: it never inspects frames or
plans, just grants (bandwidth, slot) leases.  The audited ground truth —
whether an offload actually made its deadline once the shared link and the
server queue are accounted for — lives in ``simulator.simulate_multi``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from .profiles import ModelProfile, NetworkState, StreamSpec
from .registry import PolicySpec

ALLOCATION_POLICIES = ("weighted_fair", "priority", "fifo")

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Pure allocation arithmetic.  These are the scheduler's numeric semantics
# stripped of all lease bookkeeping, shared verbatim by the stateful
# EdgeServerScheduler below and the fluid-link loop
# (simulator.simulate_multi).  Keep them dependency-free and side-effect-free.
# ---------------------------------------------------------------------------


def effective_weight(policy: str, weight: float, priority: int) -> float:
    """Allocation weight of one client: raw weight, or priority-boosted
    ``w * 2**p`` under the ``priority`` policy."""
    if policy == "priority":
        return weight * (2.0 ** priority)
    return weight


def fair_share(bandwidth_bps: float, w_eff: float, total_w_eff: float) -> float:
    """The static weighted-fair bandwidth share ``B * w_i / sum_j w_j``."""
    return bandwidth_bps * w_eff / total_w_eff


def fluid_rates(
    bandwidth_bps: float,
    weights: Sequence[float],
    caps: Sequence[float],
    *,
    eps: float = _EPS,
) -> list[float]:
    """Weighted max-min (water-filling) split of one link across transfers.

    Each transfer asks for its weight-proportional share but never exceeds
    its ``cap``; capped transfers return their leftover to the pool.  When
    the caps are scheduler grants summing to <= B this degenerates to
    "everyone transmits at the granted rate"; with infinite caps (fifo) it
    is plain weighted processor sharing.  This is the fluid model of
    ``simulator.simulate_multi``.
    """
    rates = [0.0] * len(weights)
    active = list(range(len(weights)))
    remaining = max(bandwidth_bps, 0.0)
    while active and remaining > eps:
        total_w = sum(weights[i] for i in active) or 1.0
        capped = [i for i in active if caps[i] <= remaining * weights[i] / total_w + eps]
        if not capped:
            for i in active:
                rates[i] = remaining * weights[i] / total_w
            return rates
        for i in capped:
            rates[i] = caps[i]
            remaining -= caps[i]
        remaining = max(remaining, 0.0)
        active = [i for i in active if i not in capped]
    return rates


@dataclass
class EdgeClient:
    """One tenant stream: a phone running the FastVA controller.

    ``weight`` steers weighted-fair bandwidth shares; ``priority`` (higher =
    more important) steers the ``priority`` policy.  ``policy`` picks the
    *inner* per-stream solver as a registry :class:`PolicySpec` (or a bare
    registered name); the legacy ``policy_name``/``alpha`` pair is still
    accepted when ``policy`` is left unset.  ``device`` is where a policy
    that plans with tensor ops runs (see ``PolicySpec.build``).
    """

    client_id: int
    stream: StreamSpec
    models: Sequence[ModelProfile]
    weight: float = 1.0
    priority: int = 0
    policy: PolicySpec | str | None = None
    policy_name: str = "max_accuracy"  # legacy; used only when policy is None
    alpha: float | None = None  # legacy; used only when policy is None
    device: Any = "cuda"

    def __post_init__(self) -> None:
        self.policy = PolicySpec.coerce(self.policy, policy_name=self.policy_name, alpha=self.alpha)
        self.policy_name = self.policy.name
        self._policy = self.policy.build(device=self.device)

    def plan(self, net: NetworkState, *, npu_free: float):
        """One inner-solver round against this client's allocated bandwidth."""
        return self._policy(list(self.models), self.stream, net, npu_free=npu_free)


@dataclass
class _Lease:
    """An in-flight offload: granted uplink rate + a server worker slot.

    The link portion frees when the upload completes (``release_link``); the
    worker slot frees when the server finishes the job (``release``).
    """

    client_id: int
    bps: float
    link_active: bool = True


@dataclass
class SchedulerAudit:
    """Counters the tests and reports read (``Session.run_multi``'s meta)."""

    grants: int = 0
    denials: int = 0
    max_concurrent_bps: float = 0.0  # peak sum of simultaneously leased bandwidth
    max_concurrent_jobs: int = 0


class EdgeServerScheduler:
    """Admission + bandwidth allocation for N streams sharing one edge server.

    Usage (the simulator drives this loop):

        grant_bps = sched.allocate(client_id, t, net)   # 0.0 => go local
        ... client plans against NetworkState(grant_bps, net.rtt) ...
        sched.register(client_id, grant_bps)            # if the plan offloads
        ... upload completes ...
        sched.release_link(client_id)                   # frees bandwidth
        ... server job completes ...
        sched.release(client_id)                        # frees the worker slot

    ``capacity`` is the server's worker-slot count: at most ``capacity``
    offload jobs may be in flight (uploading or executing) at once — except
    under the uncoordinated ``fifo`` policy, where admission is a no-op and
    the pain shows up as queueing delay instead.

    Server-model capacity is rationed with a backlog gate: ``register`` feeds
    each admitted job's server seconds into an aggregate busy-until estimate
    (work divided across the ``capacity`` workers), and ``allocate`` denies
    offloads while the expected queue delay exceeds ``backlog_limit`` seconds.
    Without this gate a single client at 30 fps can legally submit 69 ms jobs
    every 33 ms and build an unbounded queue that misses every deadline.
    """

    def __init__(
        self,
        clients: Sequence[EdgeClient],
        *,
        policy: str = "weighted_fair",
        capacity: int = 4,
        backlog_limit: float = 0.0,
    ):
        if policy not in ALLOCATION_POLICIES:
            raise ValueError(f"unknown allocation policy {policy!r}; want one of {ALLOCATION_POLICIES}")
        self.clients = {c.client_id: c for c in clients}
        if len(self.clients) != len(clients):
            raise ValueError("duplicate client_id in clients")
        self.policy = policy
        self.capacity = int(capacity)
        self.backlog_limit = float(backlog_limit)
        # One client may hold several leases at once (a policy that offloads
        # several frames per round, or an upload stretched past the client's
        # next round) — hence a list per client, drained FIFO.
        self.leases: dict[int, list[_Lease]] = {}
        self.server_busy_until = 0.0  # abs time the admitted server work drains
        self.audit = SchedulerAudit()

    # -- weights -----------------------------------------------------------
    def _effective_weight(self, c: EdgeClient) -> float:
        return effective_weight(self.policy, c.weight, c.priority)

    def _total_weight(self) -> float:
        return sum(self._effective_weight(c) for c in self.clients.values()) or 1.0

    # -- allocation --------------------------------------------------------
    def allocate(self, client_id: int, t: float, net: NetworkState) -> float:
        """Grant an uplink rate (bps) for one offload round; 0.0 means denied.

        A grant is only a *quote* — it reserves nothing until ``register`` is
        called (the client may plan a pure-local round and never lease).
        """
        c = self.clients[client_id]
        if self.policy == "fifo":
            # Uncoordinated: everyone believes the link is theirs.
            self.audit.grants += 1
            return net.bandwidth_bps

        # ONE of the client's own still-held leases (typically the server
        # tail of its previous round) never blocks its next request — but
        # only one, else a single client could queue unboundedly many jobs
        # past ``capacity`` whenever backlog_limit is loosened.
        own = len(self.leases.get(client_id, ()))
        effective = self._n_leases() - min(own, 1)
        backlogged = self.server_busy_until - t > self.backlog_limit
        if effective >= self.capacity or backlogged or self._slots_reserved_above(c):
            self.audit.denials += 1
            return 0.0

        used = self._link_reserved(exclude=client_id)
        available = max(net.bandwidth_bps - used, 0.0)
        share = fair_share(net.bandwidth_bps, self._effective_weight(c), self._total_weight())
        grant = min(share, available)
        if grant <= 0.0:
            self.audit.denials += 1
            return 0.0
        self.audit.grants += 1
        return grant

    def _n_leases(self) -> int:
        return sum(len(ls) for ls in self.leases.values())

    def _link_reserved(self, exclude: int | None = None) -> float:
        """Bandwidth currently reserved on the link.  A client's uplink is
        serial (the simulator transmits its oldest upload only), so its many
        leases reserve max(bps), not the sum."""
        return sum(
            max((l.bps for l in ls if l.link_active), default=0.0)
            for cid, ls in self.leases.items()
            if cid != exclude
        )

    def _slots_reserved_above(self, c: EdgeClient) -> bool:
        """Priority policy: hold free slots for higher-priority slotless clients."""
        if self.policy != "priority":
            return False
        free = self.capacity - self._n_leases()
        higher_waiting = sum(
            1
            for other in self.clients.values()
            if other.priority > c.priority and not self.leases.get(other.client_id)
        )
        return free <= higher_waiting

    # -- lease lifecycle ---------------------------------------------------
    def register(self, client_id: int, bps: float, *, t: float = 0.0, server_s: float = 0.0) -> None:
        """The client's round really does offload: consume the granted lease.

        ``server_s`` is the admitted job's server-side service time; it feeds
        the backlog gate (conservatively anchored at ``t``, i.e. as if the job
        reached the server instantly — uploads only push it later).
        """
        if self.policy != "fifo":
            self.server_busy_until = max(self.server_busy_until, t) + server_s / max(self.capacity, 1)
        self.leases.setdefault(client_id, []).append(_Lease(client_id, bps))
        self.audit.max_concurrent_jobs = max(self.audit.max_concurrent_jobs, self._n_leases())
        if self.policy != "fifo":
            self.audit.max_concurrent_bps = max(
                self.audit.max_concurrent_bps, self._link_reserved()
            )

    def release_link(self, client_id: int) -> None:
        """The client's oldest in-flight upload finished: free its bandwidth."""
        for lease in self.leases.get(client_id, []):
            if lease.link_active:
                lease.link_active = False
                return

    def release(self, client_id: int) -> None:
        """The client's oldest admitted job left the server: free its slot."""
        ls = self.leases.get(client_id)
        if ls:
            ls.pop(0)
            if not ls:
                del self.leases[client_id]

    def reset(self) -> None:
        """Forget all leases, backlog, and audit counters.

        ``simulate_multi`` calls this on entry so one scheduler can be
        replayed across runs: without it the backlog estimate
        (``server_busy_until``) from a previous run — whose clock also
        started at 0 — would deny every offload of the next one.
        """
        self.leases.clear()
        self.server_busy_until = 0.0
        self.audit = SchedulerAudit()


def make_fleet(
    n: int,
    *,
    stream: StreamSpec | None = None,
    models: Sequence[ModelProfile] | None = None,
    policy: PolicySpec | str | None = None,
    policy_name: str = "max_accuracy",
    alpha: float | None = None,
    weights: Sequence[float] | None = None,
    priorities: Sequence[int] | None = None,
    device: Any = "cuda",
) -> list[EdgeClient]:
    """Convenience: N identical tenants (benchmarks, tests, the demo)."""
    from .profiles import PAPER_MODELS, PAPER_STREAM

    stream = stream if stream is not None else PAPER_STREAM
    models = list(models) if models is not None else list(PAPER_MODELS)
    # One coercion up front so all N clients share a single validated spec.
    policy = PolicySpec.coerce(policy, policy_name=policy_name, alpha=alpha)
    return [
        EdgeClient(
            client_id=i,
            stream=stream,
            models=models,
            weight=weights[i] if weights is not None else 1.0,
            priority=priorities[i] if priorities is not None else 0,
            policy=policy,
            device=device,
        )
        for i in range(n)
    ]
