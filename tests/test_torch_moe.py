"""The port's MoE layer (``layers._dispatch_indices``, ``layers.moe``) against
the reference, on the CPU.

Tolerances and why:
  * the dispatch plan (token_idx, slot_valid, pos, kept) and the routed
    experts: integers, exactly equal;
  * ``moe``'s output and aux loss in f32: rtol 1e-4 / atol 2e-5, the same
    f32 arithmetic summed in another order (the combine is a scatter-add on
    both sides);
  * in the port alone: one expert with top-1 and ample capacity equals
    ``swiglu`` with that expert (rtol/atol 1e-5, the reference's own test).
"""
from __future__ import annotations

from test_torch_ref import CPU  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import common
from repro_torch.models import layers as L

F32 = dict(rtol=1e-4, atol=2e-5)
# the reference's functions jitted (eager, each op compiles on its own)
jdispatch = jax.jit(JL._dispatch_indices, static_argnums=(1, 2))
jmoe = jax.jit(JL.moe, static_argnums=0)

# (N, n_experts, capacity, ids): random ids, one expert only, capacities from
# 1 to ample, ids that leave experts empty
DISPATCH_CASES = {
    "random": (24, 4, 6, None),
    "tight": (96, 8, 2, None),
    "ample": (40, 8, 40, None),
    "one-expert": (16, 4, 4, np.zeros(16, np.int32)),
    "gaps": (12, 8, 3, np.array([7, 7, 2, 2, 2, 2, 7, 0, 0, 2, 7, 7], np.int32)),
    "capacity-1": (30, 6, 1, None),
}


def _ids(case):
    N, E, _, ids = DISPATCH_CASES[case]
    if ids is None:
        ids = np.random.default_rng(N * E).integers(0, E, N).astype(np.int32)
    return ids


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_indices_equal_reference(case):
    N, E, cap, _ = DISPATCH_CASES[case]
    ids = _ids(case)
    want = jdispatch(jnp.asarray(ids), E, cap)
    got = L._dispatch_indices(torch.tensor(ids), E, cap)
    for name, g, w in zip(("token_idx", "slot_valid", "pos", "kept"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_dispatch_indices_batched_rows_equal_vmapped_reference():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 8, (5, 48)).astype(np.int32)
    ids[1] = 3  # one row all on one expert
    want = jax.jit(jax.vmap(lambda e: JL._dispatch_indices(e, 8, 7)))(jnp.asarray(ids))
    got = L._dispatch_indices(torch.tensor(ids), 8, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dispatch_invariants():
    """tests/test_models.py's invariants: a huge capacity drops nothing, every
    valid slot reads a token routed to its expert, one slot per token."""
    N, E = 24, 4
    eid = torch.tensor(np.random.default_rng(0).integers(0, E, N))
    cap = int(round(N / E * 8.0))
    token_idx, slot_valid, pos, kept = L._dispatch_indices(eid, E, cap)
    assert bool(kept.all())
    for e in range(E):
        for c in range(cap):
            if bool(slot_valid[e, c]):
                assert int(eid[token_idx[e, c]]) == e
    assert int(slot_valid.sum()) == N


def test_capacity_drops_tokens():
    token_idx, slot_valid, pos, kept = L._dispatch_indices(torch.zeros(16, dtype=torch.int32), 4, 4)
    assert int(kept.sum()) == 4 and int(slot_valid[0].sum()) == 4
    assert pos.tolist() == list(range(16))


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.05, 0.3], [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    wj, ej = jax.lax.top_k(jnp.asarray(probs), 3)
    wt, et = L._top_k(torch.tensor(probs), 3)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def _moe_params(rng, c):
    return {
        "router": (rng.standard_normal((c.d_model, c.n_experts)) * 0.5).astype(np.float32),
        "experts": {k: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32) for k, s in (
            ("w_gate", (c.n_experts, c.d_model, c.d_ff_expert)), ("w_up", (c.n_experts, c.d_model, c.d_ff_expert)),
            ("w_down", (c.n_experts, c.d_ff_expert, c.d_model)))},
        **({"shared": {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for k, s in (
            ("w_gate", (c.d_model, c.d_ff_shared)), ("w_up", (c.d_model, c.d_ff_shared)),
            ("w_down", (c.d_ff_shared, c.d_model)))}} if c.n_shared else {}),
    }


def _to_torch(tree):
    return {k: _to_torch(v) for k, v in tree.items()} if isinstance(tree, dict) else torch.tensor(tree)


# the smoke MoE configs of qwen2-moe (8 experts, top-4, 2 shared) and
# deepseek-moe (8, top-6, 2 shared), a tight capacity that drops tokens, and
# one without shared experts
MOE_CASES = {
    "qwen2-moe-smoke": (dict(d_model=64, d_ff_expert=32, n_experts=8, top_k=4, n_shared=2, d_ff_shared=128), (2, 12)),
    "deepseek-moe-smoke": (dict(d_model=64, d_ff_expert=32, n_experts=8, top_k=6, n_shared=2, d_ff_shared=64), (2, 12)),
    "drops": (dict(d_model=32, d_ff_expert=16, n_experts=4, top_k=2, capacity_factor=0.5), (3, 16)),
    "decode-step": (dict(d_model=32, d_ff_expert=16, n_experts=16, top_k=3, n_shared=1, d_ff_shared=48), (4, 1)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    kw, (B, S) = MOE_CASES[case]
    cj, c = JL.MoECfg(**kw), L.MoECfg(**kw)
    assert common.param_count(L.moe_specs(c)) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(JL.moe_specs(cj), is_leaf=lambda x: hasattr(x, "axes")))
    rng = np.random.default_rng(len(case))
    p = _moe_params(rng, c)
    x = rng.standard_normal((B, S, c.d_model)).astype(np.float32)
    yj, auxj = jmoe(cj, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    yt, auxt = L.moe(c, _to_torch(p), torch.tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32)
    np.testing.assert_allclose(float(auxt), float(auxj), **F32)
    # the routing the output came from: the same experts, and the same kept tokens
    logits = np.einsum("bsd,de->bse", x, p["router"])
    ej = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), c.top_k)[1])
    et = L._top_k(torch.softmax(torch.tensor(logits), -1), c.top_k)[1].numpy()
    np.testing.assert_array_equal(et, ej)
    cap = int(max(1, round(S * c.top_k / c.n_experts * c.capacity_factor)))
    kept_t = L._dispatch_indices(torch.tensor(et.reshape(B, -1)), c.n_experts, cap)[3]
    kept_j = jax.vmap(lambda e: jdispatch(e, c.n_experts, cap)[3])(jnp.asarray(ej.reshape(B, -1)))
    np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_j))
    if case == "drops":
        assert not bool(kept_t.all())


def test_moe_bf16_runs_in_bf16():
    c = L.MoECfg(**MOE_CASES["qwen2-moe-smoke"][0])
    p = common.tree_map(lambda t: t.to(torch.bfloat16), _to_torch(_moe_params(np.random.default_rng(0), c)))
    y, aux = L.moe(c, p, torch.randn(2, 12, 64, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 12, 64) and aux.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())


def test_single_expert_top1_equals_swiglu():
    """1 expert + top-1 + ample capacity == plain SwiGLU with that expert."""
    c = L.MoECfg(d_model=32, d_ff_expert=64, n_experts=1, top_k=1, capacity_factor=2.0)
    p = common.init_tree(torch.Generator().manual_seed(0), L.moe_specs(c), device=CPU)
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(1))
    out, aux = L.moe(c, p, x)
    dense = L.swiglu({k: w[0] for k, w in p["experts"].items()}, x)
    torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-5)
