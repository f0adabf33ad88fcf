"""The port's detect+track workload and audit contract against the
reference's: decay tables, intervals, both track planners, the exhaustive
oracle, and the audit helpers on crafted plans.  Plain float64 Python on
both sides, so every comparison is exact.
"""
from __future__ import annotations

import itertools

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro.core import audit as jaudit
from repro.core import profiles as jprofiles
from repro.core import registry as jregistry
from repro.core import schedule as jschedule
from repro.core import tracking as jtracking
from repro_torch.core import audit as taudit
from repro_torch.core import profiles as tprofiles
from repro_torch.core import registry as tregistry
from repro_torch.core import schedule as tschedule
from repro_torch.core import tracking as ttracking


@pytest.mark.parametrize("decay,density", [(0.0, 1.0), (0.15, 1.0), (0.3, 2.5), (0.05, 0.4), (1.0, 1.0)])
def test_decay_tables_equal_reference(decay, density):
    r = ttracking.retention(decay, density)
    assert r == jtracking.retention(decay, density)
    assert ttracking.WorkloadSpec("track", decay, density).retention == \
        jtracking.WorkloadSpec("track", decay, density).retention == r
    for n in (0, 1, 5, 40):
        assert ttracking.retention_powers(r, n) == jtracking.retention_powers(r, n)
    for k_max in (0, 1, 8, 17):
        assert ttracking.interval_means(r, k_max) == jtracking.interval_means(r, k_max)


def test_intervals_equal_reference():
    assert ttracking.DEFAULT_K_MAX == jtracking.DEFAULT_K_MAX
    for t, gamma in itertools.product((0.0, 0.01, 0.0333, 0.1, 0.241, 0.5), (1 / 30, 1 / 15, 0.1)):
        assert ttracking.npu_interval(t, gamma) == jtracking.npu_interval(t, gamma)
        assert ttracking.upload_interval(t, gamma) == jtracking.upload_interval(t, gamma)


def _plan_key(plan):
    return (
        tuple((d.frame, d.where.value, d.model, d.resolution, d.start, d.finish) for d in plan.decisions),
        plan.horizon, plan.expected_accuracy_sum, plan.expected_utility,
        plan.npu_busy_until, plan.net_busy_until,
    )


GRID = list(itertools.product(
    (0.3, 1.5, 2.5, 8.0, 30.0),  # Mbps
    (10.0, 30.0),  # fps
    (0.1, 0.2, 0.4),  # deadline, s
    (0.0, 0.05, 0.25),  # npu_free, s
))


@pytest.mark.parametrize("name,params", [
    ("track_accuracy", {}),
    ("track_accuracy", {"decay": 0.4, "density": 2.0, "k_max": 3}),
    ("track_fixed", {"k": 1}),
    ("track_fixed", {"k": 4}),
], ids=str)
def test_track_planners_equal_reference(name, params):
    jpol = jregistry.PolicySpec(name, params).build()
    tpol = tregistry.PolicySpec(name, params).build()
    for mbps, fps, deadline, npu_free in GRID:
        jplan = jpol(jprofiles.PAPER_MODELS, jprofiles.StreamSpec(fps=fps, deadline=deadline),
                     jprofiles.network_mbps(mbps), npu_free=npu_free)
        tplan = tpol(tprofiles.PAPER_MODELS, tprofiles.StreamSpec(fps=fps, deadline=deadline),
                     tprofiles.network_mbps(mbps), npu_free=npu_free)
        assert _plan_key(tplan) == _plan_key(jplan), (mbps, fps, deadline, npu_free)


def test_track_params_are_bounded_like_reference():
    for registry in (jregistry, tregistry):
        for name, params in (("track_fixed", {"k": 0}), ("track_accuracy", {"decay": 1.5}),
                             ("track_accuracy", {"k_max": 0}), ("track_accuracy", {"density": -1.0})):
            with pytest.raises(ValueError, match="must be in"):
                registry.PolicySpec(name, params)


@pytest.mark.parametrize("mbps,fps,n", [(2.5, 30.0, 9), (8.0, 10.0, 7), (0.5, 30.0, 10), (30.0, 15.0, 8)])
def test_exhaustive_track_best_equals_reference(mbps, fps, n):
    for ret in (0.85, 0.5):
        j = jtracking.exhaustive_track_best(jprofiles.PAPER_MODELS, jprofiles.StreamSpec(fps=fps),
                                            jprofiles.network_mbps(mbps), n, retention=ret, k_max=4)
        t = ttracking.exhaustive_track_best(tprofiles.PAPER_MODELS, tprofiles.StreamSpec(fps=fps),
                                            tprofiles.network_mbps(mbps), n, retention=ret, k_max=4)
        assert t == j


def _plans(schedule):
    """Crafted plans, feasible and not: an overlapping NPU pair, a late
    finish, an offload, a skip, and decisions past the horizon."""
    D, W = schedule.Decision, schedule.Where
    return [
        schedule.RoundPlan([D(0, W.NPU, 0, 224, 0.0, 0.0691), D(1, W.NPU, 1, 224, 0.0691, 0.0853)], horizon=2),
        schedule.RoundPlan([D(0, W.NPU, 0, 224, 0.0, 0.0691), D(1, W.NPU, 0, 224, 0.05, 0.12)], horizon=2),
        schedule.RoundPlan([D(0, W.NPU, 0, 224, 0.0, 0.35)], horizon=1),
        schedule.RoundPlan([D(0, W.SERVER, 1, 134, 0.0, 0.18), D(1, W.NPU, 1, 224, 0.0333, 0.0495)], horizon=2),
        schedule.RoundPlan([D(0, W.SKIP)], horizon=3),
        schedule.RoundPlan([D(0, W.NPU, 1, 224, 0.0, 0.0162), D(3, W.NPU, 1, 224, 0.1, 0.1162)], horizon=2),
        schedule.RoundPlan([D(0, W.SERVER, 0, 224, 0.0, 0.5)], horizon=4),
    ]


@pytest.mark.parametrize("strict,npu_only", [(True, False), (True, True), (False, False)])
def test_audit_contract_equals_reference(strict, npu_only):
    assert taudit.AUDIT_TOL == jaudit.AUDIT_TOL
    out = []
    for audit, schedule, prof, trk in ((jaudit, jschedule, jprofiles, jtracking),
                                       (taudit, tschedule, tprofiles, ttracking)):
        stats = schedule.StreamStats(frames_total=20)
        tstats = schedule.StreamStats(frames_total=20)
        state = audit.TrackState()
        offloads = []
        rows = []
        for i, plan in enumerate(_plans(schedule)):
            horizon, bad = audit.audit_round(plan, gamma=1 / 30, deadline=0.2, strict=strict, npu_only=npu_only)
            head = 3 * i
            audit.apply_round(stats, plan, models=prof.PAPER_MODELS, stream=prof.PAPER_STREAM, head=head,
                              n_frames=20, horizon=horizon, bad_frames=bad,
                              on_offload=(lambda d, m: offloads.append((d.frame, m.name))) if i % 2 else None)
            state = audit.apply_track_round(tstats, plan, models=prof.PAPER_MODELS, stream=prof.PAPER_STREAM,
                                            state=state, head=head, n_frames=20, horizon=horizon,
                                            bad_frames=bad, retention=trk.retention(0.2, 1.5))
            rows.append((horizon, sorted(bad), tuple(state)))
        out.append((rows, offloads, [vars(s) for s in (stats, tstats)]))
    assert out[1] == out[0]
