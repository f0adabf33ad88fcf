"""The port's edge-server scheduler against the reference's.

Plain float64 Python on both sides, in the same order, so every comparison
is exact: water-filled rates, grants, lease state, backlog and the audit
counters after every step of seeded allocate/register/release traces.
"""
from __future__ import annotations

import math

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import numpy as np
import pytest
import torch

from repro.core import edge_server as jedge
from repro.core import profiles as jprofiles
from repro.core import registry as jregistry
from repro_torch.core import edge_server as tedge
from repro_torch.core import profiles as tprofiles
from repro_torch.core import registry as tregistry

CPU = "cpu"


@pytest.mark.parametrize("seed", range(8))
def test_fluid_rates_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(0, 6))
        weights = [float(w) for w in rng.uniform(0.1, 4.0, n)]
        caps = [math.inf if rng.random() < 0.3 else float(c) for c in rng.uniform(0.0, 6e6, n)]
        bw = float(rng.choice([0.0, rng.uniform(1e5, 2e7)]))
        assert tedge.fluid_rates(bw, weights, caps) == jedge.fluid_rates(bw, weights, caps)
        assert tedge.fluid_rates(bw, weights, caps, eps=1e-3) == jedge.fluid_rates(bw, weights, caps, eps=1e-3)


def test_weights_and_shares_equal_reference():
    for policy in tedge.ALLOCATION_POLICIES:
        for w, p in ((1.0, 0), (2.5, 1), (0.5, 3), (3.0, -1)):
            assert tedge.effective_weight(policy, w, p) == jedge.effective_weight(policy, w, p)
    assert tedge.fair_share(7.3e6, 2.0, 5.5) == jedge.fair_share(7.3e6, 2.0, 5.5)
    assert tedge.ALLOCATION_POLICIES == jedge.ALLOCATION_POLICIES


def _state(sched):
    return (
        {cid: [(l.client_id, l.bps, l.link_active) for l in ls] for cid, ls in sched.leases.items()},
        sched.server_busy_until,
        (sched.audit.grants, sched.audit.denials, sched.audit.max_concurrent_bps, sched.audit.max_concurrent_jobs),
    )


@pytest.mark.parametrize("policy", ["weighted_fair", "priority", "fifo"])
@pytest.mark.parametrize("seed", range(3))
def test_allocation_and_lease_traces_equal_reference(policy, seed):
    """A seeded sequence of allocate / register / release_link / release
    calls gives the same grants and the same scheduler state at every step."""
    rng = np.random.default_rng(seed)
    n = 4
    weights = [float(w) for w in rng.uniform(0.5, 3.0, n)]
    priorities = [int(p) for p in rng.integers(0, 3, n)]
    capacity = int(rng.integers(1, 4))
    backlog = float(rng.choice([0.0, 0.05]))
    scheds = []
    for edge, registry, kw in ((jedge, jregistry, {}), (tedge, tregistry, {"device": CPU})):
        clients = edge.make_fleet(n, policy=registry.PolicySpec("max_accuracy"), weights=weights,
                                  priorities=priorities, **kw)
        scheds.append((edge, edge.EdgeServerScheduler(clients, policy=policy, capacity=capacity,
                                                      backlog_limit=backlog)))
    t = 0.0
    for _ in range(120):
        op = int(rng.integers(0, 4))
        cid = int(rng.integers(0, n))
        t += float(rng.uniform(0.0, 0.02))
        out = []
        for edge, sched in scheds:
            prof = jprofiles if edge is jedge else tprofiles
            if op == 0:
                out.append(sched.allocate(cid, t, prof.network_mbps(float(8 + cid))))
            elif op == 1:
                sched.register(cid, 1.5e6 + 1e5 * cid, t=t, server_s=0.03 + 0.01 * cid)
            elif op == 2:
                sched.release_link(cid)
            else:
                sched.release(cid)
            out.append(_state(sched))
        assert out[len(out) // 2:] == out[: len(out) // 2]
    for _, sched in scheds:
        sched.reset()
    assert _state(scheds[1][1]) == _state(scheds[0][1]) == ({}, 0.0, (0, 0, 0.0, 0))


def test_scheduler_validation_equals_reference():
    for edge, registry, kw in ((jedge, jregistry, {}), (tedge, tregistry, {"device": CPU})):
        clients = edge.make_fleet(2, policy=registry.PolicySpec("local"), **kw)
        with pytest.raises(ValueError, match="unknown allocation policy"):
            edge.EdgeServerScheduler(clients, policy="round_robin")
        with pytest.raises(ValueError, match="duplicate client_id"):
            edge.EdgeServerScheduler([clients[0], clients[0]])


def test_fleet_clients_plan_like_reference():
    """make_fleet's clients (weights, priorities, the one shared spec) and
    their inner rounds against allocated bandwidth."""
    kw = dict(weights=(1.0, 2.0, 0.5), priorities=(0, 2, 1))
    jc = jedge.make_fleet(3, policy=jregistry.PolicySpec("max_utility", {"alpha": 150.0}), **kw)
    tc = tedge.make_fleet(3, policy=tregistry.PolicySpec("max_utility", {"alpha": 150.0}), device=CPU, **kw)
    for j, t in zip(jc, tc):
        assert (t.client_id, t.weight, t.priority, t.policy.to_json(), t.policy_name) == \
            (j.client_id, j.weight, j.priority, j.policy.to_json(), j.policy_name)
        for mbps, free in ((0.0, 0.0), (1.5, 0.02), (6.0, 0.0)):
            jp = j.plan(jprofiles.network_mbps(mbps), npu_free=free)
            tp = t.plan(tprofiles.network_mbps(mbps), npu_free=free)
            assert [(d.frame, d.where.value, d.model, d.resolution, d.start, d.finish) for d in tp.decisions] == \
                [(d.frame, d.where.value, d.model, d.resolution, d.start, d.finish) for d in jp.decisions]
    legacy = tedge.EdgeClient(0, tprofiles.PAPER_STREAM, tprofiles.PAPER_MODELS, policy_name="offload", alpha=5.0)
    assert legacy.policy == tregistry.PolicySpec("offload", {"alpha": 5.0})


def test_fleet_hands_its_device_to_tensor_planners(monkeypatch):
    clients = tedge.make_fleet(2, policy=tregistry.PolicySpec("jax_accuracy"), device=CPU)
    plan = clients[0].plan(tprofiles.network_mbps(2.5), npu_free=0.0)
    assert plan.horizon == 6 and all(d.where.value == "npu" for d in plan.decisions)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tedge.make_fleet(2, policy=tregistry.PolicySpec("jax_accuracy"))  # default "cuda", no card
