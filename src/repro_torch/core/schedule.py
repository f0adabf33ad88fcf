"""Schedule data types shared by all scheduling policies.

A *round* is the paper's planning unit: one head frame considered for
offload plus the ``n_l`` frames that arrive while the link is busy.  Each
policy returns a ``RoundPlan``; the simulator executes plans back-to-back
and re-invokes the policy whenever the link frees up.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Sequence


class Where(enum.Enum):
    NPU = "npu"  # local quantized path
    SERVER = "server"  # edge offload
    SKIP = "skip"  # dropped (Max-Utility only)


@dataclass(frozen=True)
class Decision:
    """(i, j, r) triple from the paper, plus the execution window we planned."""

    frame: int  # i — index relative to the round's head frame
    where: Where
    model: int = -1  # j — index into the profile list; -1 for SKIP
    resolution: int = -1  # r — offload resolution; r_max implied for NPU
    start: float = 0.0  # planned processing start (round-relative seconds)
    finish: float = 0.0  # planned completion incl. network for offloads

    def is_processed(self) -> bool:
        return self.where is not Where.SKIP


@dataclass
class RoundPlan:
    """One scheduling round.  ``horizon`` = frames consumed (>= 1)."""

    decisions: list[Decision] = field(default_factory=list)
    horizon: int = 1
    expected_accuracy_sum: float = 0.0
    expected_utility: float = 0.0
    npu_busy_until: float = 0.0  # relative to round start; carried to next round
    net_busy_until: float = 0.0

    @property
    def processed(self) -> int:
        return sum(1 for d in self.decisions if d.is_processed())


@dataclass
class StreamStats:
    """Accumulated over a simulated stream; what the figures plot."""

    frames_total: int = 0
    frames_processed: int = 0
    frames_missed_deadline: int = 0
    frames_offloaded: int = 0  # subset of processed that ran on the edge
    accuracy_sum: float = 0.0
    elapsed: float = 0.0
    schedule_calls: int = 0
    schedule_time: float = 0.0
    # NPU busy-seconds, kept so the JSON of StreamStats matches the
    # reference's; 0.0 where untracked (every engine ported so far).
    npu_busy_s: float = 0.0

    @property
    def mean_accuracy(self) -> float:
        """Paper's Max-Accuracy objective: mean over *all* frames (missed = 0)."""
        if self.frames_total == 0:
            return 0.0
        return self.accuracy_sum / self.frames_total

    @property
    def processed_accuracy(self) -> float:
        if self.frames_processed == 0:
            return 0.0
        return self.accuracy_sum / self.frames_processed

    def utility(self, alpha: float) -> float:
        """Paper Eq. (9): rate + alpha * mean accuracy over processed frames."""
        if self.elapsed <= 0:
            return 0.0
        rate = self.frames_processed / self.elapsed
        return rate + alpha * self.processed_accuracy


@dataclass(frozen=True)
class PlanError:
    """One feasibility violation of a plan; ``frame`` is round-relative.

    Stringifies to the human-readable message, so audit loops can use the
    structured ``frame`` field while assertions still print useful text.
    """

    frame: int
    message: str

    def __str__(self) -> str:
        return self.message


def validate_plan(
    plan: RoundPlan,
    *,
    gamma: float,
    deadline: float,
    tol: float = 1e-9,
) -> list[PlanError]:
    """Feasibility audit used by tests and the simulator (defence in depth).

    Checks the paper's constraints (2)/(3)/(10)/(11): every processed frame
    finishes within ``arrival + deadline``; NPU decisions do not overlap;
    offloads do not overlap on the link.
    """
    errors: list[PlanError] = []
    npu_prev_end = -float("inf")
    for d in sorted(plan.decisions, key=lambda d: (d.start, d.frame)):
        if not d.is_processed():
            continue
        arrival = d.frame * gamma
        if d.finish > arrival + deadline + tol:
            errors.append(PlanError(
                d.frame, f"frame {d.frame}: finish {d.finish:.4f} > deadline {arrival + deadline:.4f}"
            ))
        if d.start + tol < arrival:
            errors.append(PlanError(
                d.frame, f"frame {d.frame}: starts {d.start:.4f} before arrival {arrival:.4f}"
            ))
        if d.where is Where.NPU:
            if d.start + tol < npu_prev_end:
                errors.append(PlanError(
                    d.frame, f"frame {d.frame}: NPU overlap ({d.start:.4f} < {npu_prev_end:.4f})"
                ))
            npu_prev_end = d.finish if d.finish > npu_prev_end else npu_prev_end
    return errors


def plan_accuracy(decisions: Sequence[Decision], models, stream) -> float:
    total = 0.0
    for d in decisions:
        if not d.is_processed():
            continue
        m = models[d.model]
        if d.where is Where.SERVER:
            total += m.accuracy(d.resolution, where="server")
        else:
            total += m.accuracy(stream.r_max, where="npu")
    return total
