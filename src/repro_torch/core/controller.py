"""Online streaming controller: the piece that makes FastVA deployable.

The paper assumes B and T_c are known; a real deployment estimates them from
observed transfers.  ``OnlineController`` keeps EWMA estimates (with a
pessimism factor for deadline safety), invokes the configured policy per
round, and exposes the same plan stream the simulator consumes — so the
whole controller can be replayed deterministically in tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from .profiles import ModelProfile, NetworkState, StreamSpec
from .registry import PolicySpec
from .schedule import RoundPlan
from .simulator import Policy


@dataclass
class BandwidthEstimator:
    """EWMA over observed (bytes, seconds) upload samples.

    ``pessimism`` < 1 shades the estimate down so a late sample does not blow
    a deadline: the scheduler plans against bandwidth * pessimism.
    """

    init_bps: float = 2e6
    beta: float = 0.3  # EWMA weight of the newest sample
    pessimism: float = 0.9
    _bps: float = field(default=0.0, init=False)
    _rtt: float = field(default=0.1, init=False)  # stub prior until the first sample
    samples: int = field(default=0, init=False)
    rtt_samples: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        self._bps = self.init_bps

    def observe_upload(self, nbytes: float, seconds: float) -> None:
        if seconds <= 0 or nbytes <= 0:
            return
        sample = nbytes * 8.0 / seconds
        self._bps = (1 - self.beta) * self._bps + self.beta * sample
        self.samples += 1

    def observe_rtt(self, seconds: float) -> None:
        # The 0.1 s default is a stub prior, not a measurement: the first real
        # sample replaces it outright; later samples blend in by EWMA.
        if self.rtt_samples == 0:
            self._rtt = seconds
        else:
            self._rtt = (1 - self.beta) * self._rtt + self.beta * seconds
        self.rtt_samples += 1

    def state(self) -> NetworkState:
        return NetworkState(bandwidth_bps=self._bps * self.pessimism, rtt=self._rtt)


@dataclass
class OnlineController:
    """Drives a policy over a live stream with estimated network state.

    The policy is a registry :class:`PolicySpec` (or a bare name).  The
    legacy ``policy_name``/``alpha`` pair is still accepted when ``policy``
    is left unset, and is folded into a spec — so the controller itself is
    serializable as part of a ``ScenarioSpec``.
    """

    models: Sequence[ModelProfile]
    stream: StreamSpec
    policy: PolicySpec | str | None = None
    policy_name: str = "max_accuracy"  # legacy; used only when policy is None
    alpha: float | None = None  # legacy; used only when policy is None
    estimator: BandwidthEstimator = field(default_factory=BandwidthEstimator)
    _policy: Policy = field(init=False)
    npu_busy_abs: float = field(default=0.0, init=False)
    rounds: int = field(default=0, init=False)

    def __post_init__(self) -> None:
        self.policy = PolicySpec.coerce(self.policy, policy_name=self.policy_name, alpha=self.alpha)
        self.policy_name = self.policy.name
        self._policy = self.policy.build()

    def next_plan(self, head_frame: int) -> RoundPlan:
        t0 = head_frame * self.stream.gamma
        plan = self._policy(
            self.models,
            self.stream,
            self.estimator.state(),
            npu_free=max(0.0, self.npu_busy_abs - t0),
        )
        self.npu_busy_abs = t0 + plan.npu_busy_until
        self.rounds += 1
        return plan

    # Feedback hooks called by the serving runtime after real transfers run.
    def report_upload(self, nbytes: float, seconds: float) -> None:
        self.estimator.observe_upload(nbytes, seconds)

    def report_rtt(self, seconds: float) -> None:
        self.estimator.observe_rtt(seconds)
