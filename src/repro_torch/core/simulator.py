"""Stream-replay types: the plan-round ``Policy`` protocol and the network
``Trace`` (bandwidth/RTT as functions of time).

The audited replay loops themselves (``simulate``/``simulate_multi``) are
not ported yet; ``VideoServer`` and ``OnlineController`` only need these two
types.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Protocol, Sequence

from .profiles import ModelProfile, NetworkState, StreamSpec
from .schedule import RoundPlan


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
