"""Backend-neutral plan-audit semantics — ONE definition of "what counts".

Every execution engine (the per-frame loops in ``simulator.py`` and
``session.Session.run_online``) must account a round plan identically, or
the figures stop being comparable across engines and across the two
packages.  The contract, transcribed verbatim from the reference:

  1. ``horizon = max(plan.horizon, 1)`` frames are consumed per round.
  2. When ``strict``, the plan is validated (:func:`schedule.validate_plan`)
     with tolerance :data:`AUDIT_TOL`; each violating frame lands in the
     round's *bad set* (single-stream engines validate every decision,
     shared-link engines validate the NPU subset only — offloads are audited
     at actual completion instead).
  3. A processed decision contributes stats only when its frame is inside
     the plan horizon AND inside the stream (``head + frame < n_frames``)
     AND not in the bad set; NPU decisions score ``accuracy(r_max)``,
     server decisions ``accuracy(r)`` at the offloaded resolution.
  4. ``frames_missed_deadline`` grows by the bad-set size of every round —
     even for frames beyond the end of the stream (the plan was still
     infeasible there; a policy does not get audit amnesty for overrunning).
  5. Accuracy accumulates in decision order, round by round, in float64, so
     ``accuracy_sum`` is bit-identical to the reference's, not approximately
     equal.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

from .profiles import ModelProfile, StreamSpec
from .schedule import RoundPlan, StreamStats, Where, validate_plan

__all__ = [
    "AUDIT_TOL",
    "TrackState",
    "apply_round",
    "apply_track_round",
    "audit_round",
]

# Feasibility tolerance (seconds) shared by every engine, batched included.
AUDIT_TOL = 1e-9


def audit_round(
    plan: RoundPlan,
    *,
    gamma: float,
    deadline: float,
    strict: bool = True,
    npu_only: bool = False,
) -> tuple[int, set[int]]:
    """Validate one round plan; return ``(horizon, bad_frames)``.

    ``npu_only=True`` restricts validation to NPU decisions — the
    shared-link engines (``simulate_multi``, ``run_online``) audit offloads
    at *actual* completion time instead of against the plan's own estimate.
    """
    horizon = max(plan.horizon, 1)
    if not strict:
        return horizon, set()
    audited = plan
    if npu_only:
        audited = RoundPlan(
            decisions=[d for d in plan.decisions if d.where is Where.NPU],
            horizon=horizon,
        )
    errors = validate_plan(audited, gamma=gamma, deadline=deadline, tol=AUDIT_TOL)
    return horizon, {e.frame for e in errors}


def apply_round(
    stats: StreamStats,
    plan: RoundPlan,
    *,
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    head: int,
    n_frames: int,
    horizon: int,
    bad_frames: set[int],
    on_offload: Callable[..., None] | None = None,
) -> None:
    """Account one audited round into ``stats`` (contract points 3-5 above).

    ``on_offload(decision, model)`` diverts SERVER decisions to the caller
    (shared-link engines hand them to the fluid uplink / true-trace replay);
    when it is ``None`` the offload is credited from the plan directly, as
    the single-stream reference simulator does.
    """
    for d in plan.decisions:
        if d.frame >= horizon or head + d.frame >= n_frames:
            continue
        if not d.is_processed():
            continue
        m = models[d.model]
        if d.where is Where.NPU:
            if d.frame in bad_frames:
                continue
            stats.frames_processed += 1
            stats.accuracy_sum += m.accuracy(stream.r_max, where="npu")
        elif on_offload is not None:
            on_offload(d, m)
        else:
            if d.frame in bad_frames:
                continue
            stats.frames_processed += 1
            stats.frames_offloaded += 1
            stats.accuracy_sum += m.accuracy(d.resolution, where="server")
    stats.frames_missed_deadline += len(bad_frames)


class TrackState(NamedTuple):
    """Detection-age state carried across rounds by the tracking workload.

    ``det_acc`` is the accuracy of the last successful detection and
    ``det_frame`` its absolute frame index (-1 before any detection, so a
    frame-0 detection is strictly newer than the initial state).  The zero
    initial accuracy makes pre-detection tracked frames score 0 with no
    special-casing (any age times ``det_acc = 0`` is 0).
    """

    det_acc: float = 0.0
    det_frame: int = -1


def apply_track_round(
    stats: StreamStats,
    plan: RoundPlan,
    *,
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    state: TrackState,
    head: int,
    n_frames: int,
    horizon: int,
    bad_frames: set[int],
    retention: float,
    on_offload: Callable[..., None] | None = None,
) -> TrackState:
    """Account one audited *tracking* round; return the new detection state.

    Tracking extension of the audit contract: a round carries at most one
    detection (the frame-0 decision) plus ``horizon`` tracker-carried
    frames.  Accounting order is detection first, then tracked frames in
    ascending frame order:

      * good detection — scores its fresh accuracy (processed, +offloaded
        for SERVER) and refreshes the state to ``(accuracy, head)``; the
        remaining ``horizon - 1`` frames track the *new* state;
      * bad detection (in the bad set) — counts in
        ``frames_missed_deadline`` via the bad set, the state is
        unchanged, and the head frame is neither scored nor tracked;
      * no detection (SKIP round) — every frame of the horizon, the head
        included, coasts on the stale state;
      * tracked frame ``f`` — always processed (the tracker is a cheap
        local op that cannot miss), scoring
        ``det_acc * retention ** (f - det_frame)``.

    ``on_offload(decision, model)`` diverts a SERVER detection to the
    shared-link engines; they score it — and refresh the state, guarded by
    detection recency — at *actual* upload completion, so this helper
    leaves the state untouched for that case.
    """
    det = next((d for d in plan.decisions if d.is_processed()), None)
    track_from = head + 1
    if det is None:
        track_from = head  # SKIP round: the tracker carries the head too
    elif det.frame in bad_frames:
        pass  # audited infeasible: missed via the bad set, state unchanged
    else:
        m = models[det.model]
        if det.where is Where.NPU:
            acc = m.accuracy(stream.r_max, where="npu")
            stats.frames_processed += 1
            stats.accuracy_sum += acc
            state = TrackState(acc, head)
        elif on_offload is not None:
            on_offload(det, m)  # scored + state-refreshed at completion
        else:
            acc = m.accuracy(det.resolution, where="server")
            stats.frames_processed += 1
            stats.frames_offloaded += 1
            stats.accuracy_sum += acc
            state = TrackState(acc, head)
    for f in range(track_from, min(head + horizon, n_frames)):
        stats.frames_processed += 1
        stats.accuracy_sum += state.det_acc * retention ** (f - state.det_frame)
    stats.frames_missed_deadline += len(bad_frames)
    return state
