"""The port's on-device DPs (``core/jax_sched``) against the reference's
jitted ones, on the CPU.

Both run the same float32 recurrences.  The reference's XLA CPU backend
fuses ``a * b + c`` into one rounding where a multiply feeds an add in one
fused loop; the port rounds those once too (``_fma32``), so the contract
is exact: the same DP value (float32, bit for bit), the same picks, the same
RoundPlans.  Model sets are drawn from numpy seeds, with ``npu_free > 0``,
``first_arrival > 0`` and tied models among them.
"""
from __future__ import annotations

from fractions import Fraction

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import numpy as np
import pytest
import torch

from repro.core import jax_sched as jsched
from repro.core import profiles as jprofiles
from repro.core import registry as jregistry
from repro_torch.core import jax_sched as tsched
from repro_torch.core import max_accuracy as tmax_accuracy
from repro_torch.core import max_utility as tmax_utility
from repro_torch.core import profiles as tprofiles
from repro_torch.core import registry as tregistry

CPU = "cpu"
SEEDS = range(24)


def _models(prof, seed: int):
    """1-3 random local models (plus, for some seeds, a server-only one and a
    twin of model 0, so ties between models occur)."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(int(rng.integers(1, 4))):
        t_npu = float(rng.uniform(0.008, 0.15))
        acc = float(np.round(rng.uniform(0.3, 0.9), 3))
        out.append(prof.profile_ms(f"m{j}", t_npu_ms=t_npu * 1e3, t_server_ms=50.0,
                                   acc_server={224: acc + 0.05}, acc_npu={224: acc}))
    if seed % 3 == 0:
        out.append(prof.profile_ms("twin", t_npu_ms=out[0].t_npu * 1e3, t_server_ms=50.0,
                                   acc_server=dict(out[0].acc_server), acc_npu=dict(out[0].acc_npu)))
    if seed % 4 == 1:
        out.insert(0, prof.profile_ms("edge-only", t_npu_ms=float("inf"), t_server_ms=40.0,
                                      acc_server={224: 0.9}, acc_npu={}))
    return out


def _case(seed: int) -> dict:
    rng = np.random.default_rng(1000 + seed)
    nf = int(rng.integers(1, 12))
    gamma = float(rng.choice([1 / 30, 1 / 15, 0.1, 0.05]))
    return dict(
        n_frames=nf,
        gamma=gamma,
        deadline=float(rng.choice([0.1, 0.2, 0.3])),
        npu_free=float(rng.uniform(0.0, 0.2)) if seed % 2 else 0.0,
        first_arrival=float(rng.uniform(0.0, 0.1)) if seed % 3 == 2 else 0.0,
        alpha=float(rng.choice([1.0, 50.0, 200.0])),
        window=nf * gamma,
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_accuracy_dp_equals_reference(seed):
    c = _case(seed)
    kw = {k: c[k] for k in ("n_frames", "gamma", "deadline", "npu_free", "first_arrival")}
    j = jsched.local_accuracy_dp_jax(_models(jprofiles, seed), **kw)
    t = tsched.local_accuracy_dp_jax(_models(tprofiles, seed), **kw, device=CPU)
    assert t == j


@pytest.mark.parametrize("seed", SEEDS)
def test_utility_dp_equals_reference(seed):
    c = _case(seed)
    kw = {k: c[k] for k in ("n_frames", "gamma", "deadline", "alpha", "npu_free", "first_arrival", "window")}
    j = jsched.local_utility_dp_jax(_models(jprofiles, seed), **kw)
    t = tsched.local_utility_dp_jax(_models(tprofiles, seed), **kw, device=CPU)
    assert t == j


def test_ties_keep_the_reference_order():
    """Identical models tie in both DPs (the first maximum wins), and slot 0
    starts at u = 0.0, whose negation -0.0 must sort level with +0.0."""
    for width in (64, 3):
        kw = dict(n_frames=8, gamma=1 / 30, deadline=0.2, npu_free=0.02, first_arrival=0.0)
        pair = [
            [prof.profile_ms(n, t_npu_ms=40.0, t_server_ms=50.0, acc_server={224: 0.7}, acc_npu={224: 0.6})
             for n in ("a", "b")]
            for prof in (jprofiles, tprofiles)
        ]
        assert tsched.local_accuracy_dp_jax(pair[1], **kw, device=CPU) == \
            jsched.local_accuracy_dp_jax(pair[0], **kw)
        for alpha in (0.0, 1e-9, 200.0):
            ukw = dict(kw, alpha=alpha, window=8 / 30, width=width)
            assert tsched.local_utility_dp_jax(pair[1], **ukw, device=CPU) == \
                jsched.local_utility_dp_jax(pair[0], **ukw)


GRID = [
    (fps, deadline, npu_free)
    for fps in (10.0, 15.0, 30.0)
    for deadline in (0.1, 0.2, 0.3)
    for npu_free in (0.0, 0.013, 0.07)
]


def _plan_key(plan):
    return (
        tuple((d.frame, d.where.value, d.model, d.resolution, d.start, d.finish) for d in plan.decisions),
        plan.horizon, plan.expected_accuracy_sum, plan.expected_utility,
        plan.npu_busy_until, plan.net_busy_until,
    )


@pytest.mark.parametrize("name,params", [
    ("jax_accuracy", {}),
    ("jax_accuracy", {"window_frames": 9, "grid": 2e-3}),
    ("jax_utility", {"alpha": 200.0}),
    ("jax_utility", {"alpha": 30.0, "window_frames": 10, "width": 8}),
], ids=str)
def test_policies_equal_reference(name, params):
    jpol = jregistry.PolicySpec(name, params).build()
    tpol = tregistry.PolicySpec(name, params).build(device=CPU)
    for seed in (0, 3, 5):
        jm, tm = list(jprofiles.PAPER_MODELS) + _models(jprofiles, seed), \
            list(tprofiles.PAPER_MODELS) + _models(tprofiles, seed)
        for fps, deadline, npu_free in GRID:
            jplan = jpol(jm, jprofiles.StreamSpec(fps=fps, deadline=deadline),
                         jprofiles.network_mbps(2.5), npu_free=npu_free)
            tplan = tpol(tm, tprofiles.StreamSpec(fps=fps, deadline=deadline),
                         tprofiles.network_mbps(2.5), npu_free=npu_free)
            assert _plan_key(tplan) == _plan_key(jplan), (seed, fps, deadline, npu_free)


@pytest.mark.parametrize("seed", range(8))
def test_dps_agree_with_the_ports_python_dps(seed):
    """The float32 DPs against the port's own float64 ``max_accuracy`` /
    ``max_utility`` local phases (tests/test_scheduler_properties.py's
    property, on seeded model sets): the accuracy DP's value within 1e-4;
    the utility DP's schedule feasible and, re-evaluated in float64,
    within 1e-3 of the Python DP's utility."""
    models = _models(tprofiles, seed)
    c = _case(seed)
    n, gamma, T = c["n_frames"], c["gamma"], c["deadline"]
    py = tmax_accuracy.local_dp(models, n_frames=n, gamma=gamma, deadline=T, npu_free=0.0, first_arrival=gamma)
    total, _ = tsched.local_accuracy_dp_jax(models, n_frames=n, gamma=gamma, deadline=T, npu_free=0.0,
                                            first_arrival=gamma, device=CPU)
    if py.feasible:
        assert abs(py.total_accuracy - total) < 1e-4
    else:
        assert total < -1e17
    w, alpha = n * gamma, 100.0
    pu = tmax_utility.local_utility_dp(models, n_frames=n, gamma=gamma, deadline=T, alpha=alpha,
                                       npu_free=0.0, first_arrival=0.0, window=w)
    _, picks = tsched.local_utility_dp_jax(models, n_frames=n, gamma=gamma, deadline=T, alpha=alpha,
                                           npu_free=0.0, first_arrival=0.0, window=w, device=CPU)
    t, acc_sum = 0.0, 0.0
    for k, j in picks:
        start = max(t, k * gamma)
        t = start + models[j].t_npu
        assert t <= k * gamma + T + 1e-5, "schedule infeasible"
        acc_sum += models[j].acc_npu[224]
    u64 = (len(picks) / w + alpha * acc_sum / len(picks)) if picks else 0.0
    assert abs(u64 - pu.utility) <= max(1e-3, 1e-3 * abs(pu.utility))


def test_fused_rounding_is_correct_rounding():
    """``_fma32`` equals a * b + c computed exactly and rounded once to
    float32 (round half to even), including sums that need more than
    float64's 53 bits."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32) * np.float32(2.0) ** rng.integers(-20, 20, 4000)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.standard_normal(4000) * 2.0 ** rng.integers(-60, 20, 4000)).astype(np.float32)
    got = tsched._fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))  # within one float32 ulp of exact
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        winners = [v for v, e in zip(cands, errs) if e == best]
        want = winners[0] if len(winners) == 1 else next(
            v for v in winners if int(np.float32(v).view(np.int32)) % 2 == 0)
        assert g == want, (x, y, z)


def test_building_on_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tregistry.PolicySpec("jax_accuracy").build()
    tregistry.PolicySpec("max_accuracy").build()  # plain-Python planners take no device
