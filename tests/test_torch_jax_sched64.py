"""The port's lane-batched DPs (``core/jax_sched``) against the reference,
on the CPU.

  * ``_accuracy_dp64``, the float64 twin of ``max_accuracy.local_dp``, runs
    ``B`` lanes at once; each lane's prefix records, choices and parents
    equal the reference's kernel on that lane's inputs, traced under
    ``enable_x64``, bit for bit.
  * ``_utility_dp64``, the twin of ``max_utility.local_utility_dp``: its
    exact form (the reference's keep rule and cap truncation) at the fast
    width and at a narrow width that forces the truncation, and its fast
    form wherever that form raises no flag, equal lane by lane a Python-float
    emulation of the reference's DP (itself held equal to
    ``local_utility_dp``).  The reference's XLA kernel rounds ``mean_term``
    as that emulation does for some model counts and as one fused
    multiply-add for others; where it rounds as the Python reference, the
    port equals it bit for bit.
  * ``_accuracy_dp`` / ``_utility_dp``, the float32 DPs of the ``jax_*``
    planners (one stream is one lane), equal lane by lane the same DP run
    on that lane alone and the reference's kernels under x64 (where
    ``_utility_dp`` sorts ``okey << 32 | index`` keys, the branch the
    reference's sweep takes).

Inputs come from numpy seeds: 1-6 models with twins (tied candidates),
``npu_free > 0``, both ``first_arrival`` values, frames past ``n_active``,
and (seeds % 4 == 3) fast models whose fronts outgrow 64 entries.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_sched as jsched
from repro.core import max_utility as jmax_utility
from repro.core import profiles as jprofiles
from repro_torch.core import jax_sched as tsched
from repro_torch.core.jax_sched import BIG_T, NEG

SEEDS = range(24)
LANES = 4
W = 10  # frames of every DP instance (static in the reference: one compile per model count)
NBINS = 384


def _models(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(t_npu [J], acc [J]) float64: the DP's model table."""
    rng = np.random.default_rng(seed)
    if seed % 4 == 3:  # many fast models of distinct speed and accuracy: wide fronts
        J = 5
        t = np.sort(rng.uniform(0.004, 0.03, J))
        acc = np.round(np.sort(rng.uniform(0.3, 0.9, J)), 4)
    else:
        J = int(rng.integers(1, 4))
        t = rng.uniform(0.008, 0.15, J)
        acc = np.round(rng.uniform(0.3, 0.9, J), 3)
    if seed % 3 == 0:  # a twin of model 0: tied candidates
        t, acc = np.append(t, t[0]), np.append(acc, acc[0])
    return t, acc


def _lanes(seed: int) -> dict:
    """Per-lane scalars of ``LANES`` DP instances."""
    rng = np.random.default_rng(1000 + seed)
    gamma = rng.choice([1 / 30, 1 / 15, 0.05, 1 / 60], LANES)
    deadline = rng.choice([0.1, 0.2, 0.35], LANES)
    return dict(
        gamma=gamma,
        deadline=deadline,
        grid=rng.choice([1e-3, 2e-3], LANES),
        alpha=rng.choice([1.0, 50.0, 200.0], LANES),
        npu_free=np.where(np.arange(LANES) % 2 == 1, rng.uniform(0.0, 0.2, LANES), 0.0),
        first_arrival=np.where(np.arange(LANES) % 3 == 2, gamma, 0.0),
        n_active=np.full(LANES, W) if seed % 4 == 3 else rng.integers(1, W + 1, LANES),
    )


def _bins(t_npu, L):
    """The sweep planners' host-side bin arithmetic (float64 numpy)."""
    ks = np.arange(W)[None, :]
    arrivals = L["first_arrival"][:, None] + ks * L["gamma"][:, None]
    grid = L["grid"][:, None]
    arr = np.ceil(arrivals / grid).astype(np.int32)
    dl = np.floor((arrivals + L["deadline"][:, None]) / grid).astype(np.int32)
    dur = np.minimum(np.ceil(t_npu[None, :] / grid), NBINS).astype(np.int32)
    start = np.ceil(L["npu_free"] / L["grid"]).astype(np.int32)
    return arr, dl, dur, start


def _t(a) -> torch.Tensor:
    """A host array as a tensor: integers as int64, floats as float64."""
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.astype(np.float64))


@pytest.mark.parametrize("seed", SEEDS)
def test_accuracy_dp64_equals_reference(seed):
    t_npu, acc = _models(seed)
    L = _lanes(seed)
    arr, dl, dur, start = _bins(t_npu, L)
    cho, par, mh, ab, alive = tsched._accuracy_dp64(
        _t(dur), torch.from_numpy(acc), _t(arr), _t(dl), _t(start), nbins=NBINS)
    cho, par = torch.stack(cho, 1).numpy(), torch.stack(par, 1).numpy()
    with jax.experimental.enable_x64():
        for b in range(LANES):
            ref = jsched._accuracy_dp64(
                jnp.asarray(dur[b]), jnp.asarray(acc, jnp.float64), jnp.asarray(arr[b]),
                jnp.asarray(dl[b]), jnp.int32(start[b]), n_frames=W, nbins=NBINS)
            r_cho, r_par, r_mh, r_ab, r_alive = (np.asarray(x) for x in ref)
            assert (cho[b] == r_cho).all() and (par[b] == r_par).all(), b
            assert (mh[b].numpy() == r_mh).all() and (ab[b].numpy() == r_ab).all(), b
            assert (alive[b].numpy() == r_alive).all(), b


def _utility_kw(L, dtype):
    f = {"float64": torch.float64, "float32": torch.float32}[dtype]
    window = np.maximum(L["n_active"] * L["gamma"], L["gamma"])
    return dict(gamma=_t(L["gamma"]).to(f), deadline=_t(L["deadline"]).to(f), alpha=_t(L["alpha"]).to(f),
                npu_free=_t(L["npu_free"]).to(f), first_arrival=_t(L["first_arrival"]).to(f),
                window=_t(window).to(f)), window


def _ref_utility64(t_npu, acc, L, window, b, width):
    with jax.experimental.enable_x64():
        out = jsched._utility_dp64(
            jnp.asarray(t_npu, jnp.float64), jnp.asarray(acc, jnp.float64), jnp.int32(L["n_active"][b]),
            n_frames=W, width=width, gamma=jnp.float64(L["gamma"][b]), deadline=jnp.float64(L["deadline"][b]),
            alpha=jnp.float64(L["alpha"][b]), npu_free=jnp.float64(L["npu_free"][b]),
            first_arrival=jnp.float64(L["first_arrival"][b]), window=jnp.float64(window[b]))
        (rt, ru, rm, rv), rpar, ract, rov = out
        return [np.asarray(x) for x in (rt, ru, rm, rv, rpar, ract)], bool(rov)


def _front_dp(t_npu, acc, L, b, width, *, fused):
    """``max_utility.local_utility_dp`` with ``_prune`` at cap ``width``, in
    Python floats, laid out as the kernels lay out their results (final
    front in slots, per-frame parent slot and model).  ``fused=True`` rounds
    ``mean_term`` once, as one fused multiply-add would."""
    g, dl, al, fa = (float(L[k][b]) for k in ("gamma", "deadline", "alpha", "first_arrival"))
    n = int(L["n_active"][b])
    window = max(n * g, g)
    front = [(max(float(L["npu_free"][b]), 0.0), 0.0, 0)]
    parents = np.tile(np.arange(width), (W, 1))
    actions = np.full((W, width), -1)
    for k in range(n):
        arrival = fa + k * g
        cands = [(t, u, m, s, -1) for s, (t, u, m) in enumerate(front)]
        for s, (t, u, m) in enumerate(front):
            for j in range(len(t_npu)):
                t2 = max(t, arrival) + float(t_npu[j])
                if t2 > arrival + dl + 1e-12:
                    continue
                a, c, q = m / (m + 1), u - m / window, al * float(acc[j]) / (m + 1)
                mean = float(Fraction(a) * Fraction(c) + Fraction(q)) if fused else a * c + q
                cands.append((t2, mean + (m + 1) / window, m + 1, s, j))
        cands.sort(key=lambda x: (x[0], -x[1]))
        kept, best = [], NEG
        for x in cands:
            if x[1] > best + 1e-12:
                kept.append(x)
                best = x[1]
        kept = kept[-width:]
        front = [x[:3] for x in kept]
        parents[k] = -1
        actions[k] = -1
        parents[k, : len(kept)] = [x[3] for x in kept]
        actions[k, : len(kept)] = [x[4] for x in kept]
    pad = width - len(front)
    return [np.array([x[0] for x in front] + [BIG_T] * pad), np.array([x[1] for x in front] + [NEG] * pad),
            np.array([x[2] for x in front] + [0] * pad), np.arange(width) < len(front), parents, actions]


def _port_utility64(t_npu, acc, L, width, exact):
    kw, _ = _utility_kw(L, "float64")
    (t, u, m, v), par, act, flag = tsched._utility_dp64(
        torch.from_numpy(t_npu), torch.from_numpy(acc), _t(L["n_active"]), width=width, n_frames=W,
        exact=exact, **kw)
    return [x.numpy() for x in (t, u, m, v, torch.stack(par, 1), torch.stack(act, 1))], flag.numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_utility_dp64_equals_python_reference(seed):
    """Exact form at the fast width and at a width of 4 (cap truncation),
    fast form wherever it raises no flag: the Python reference's front,
    parents and actions, bit for bit, lane by lane."""
    t_npu, acc = _models(seed)
    L = _lanes(seed)
    for width in (64, 4):
        exact, flag = _port_utility64(t_npu, acc, L, width, True)
        fast, fast_flag = _port_utility64(t_npu, acc, L, width, False)
        for b in range(LANES):
            want = _front_dp(t_npu, acc, L, b, width, fused=False)
            assert all((g[b] == w).all() for g, w in zip(exact, want)), (width, b)
            if not fast_flag[b]:
                assert all((g[b] == w).all() for g, w in zip(fast, want)), (width, b)
            if flag[b]:
                assert fast_flag[b], (width, b)  # a cap overflow always flags the fast form


@pytest.mark.parametrize("seed", SEEDS)
def test_python_twin_is_the_reference_local_utility_dp(seed):
    """The emulation above is ``max_utility.local_utility_dp`` (at the
    reference's cap): same best utility, decisions, finish time and count."""
    t_npu, acc = _models(seed)
    L = _lanes(seed)
    models = [jprofiles.profile_ms(f"m{j}", t_npu_ms=float(t) * 1e3, t_server_ms=50.0,
                                   acc_server={224: 0.9}, acc_npu={224: float(a)})
              for j, (t, a) in enumerate(zip(t_npu, acc))]
    for b in range(LANES):
        t, u, m, v, par, act = _front_dp(t_npu, acc, L, b, 256, fused=False)
        models_t = [dataclasses.replace(x, t_npu=float(tn)) for x, tn in zip(models, t_npu)]
        n = int(L["n_active"][b])
        ref = jmax_utility.local_utility_dp(
            models_t, n_frames=n, gamma=float(L["gamma"][b]), deadline=float(L["deadline"][b]),
            alpha=float(L["alpha"][b]), npu_free=float(L["npu_free"][b]),
            first_arrival=float(L["first_arrival"][b]), window=max(n * L["gamma"][b], L["gamma"][b]))
        s = int(np.argmax(u))
        decisions = []
        for k in range(W - 1, -1, -1):
            if act[k, s] >= 0:
                decisions.append((k, int(act[k, s])))
            s = int(par[k, s])
        assert (u.max(), decisions[::-1], t[int(np.argmax(u))], m[int(np.argmax(u))]) == \
            (ref.utility, ref.decisions, ref.npu_free, ref.processed), b


@pytest.mark.parametrize("seed", SEEDS)
def test_utility_dp64_equals_reference_kernel(seed):
    """The reference's XLA-compiled ``_utility_dp64`` on jax 0.9 rounds
    ``mean_term`` twice, as the Python reference does, for some model counts
    (2 and 4 here), and once — a fused multiply-add past its ``_no_fma``
    guard — for others (3, 5 and 6): it equals one of the two emulations in
    every lane.  Where it rounds as the Python reference, the port equals it
    bit for bit; the port always equals the Python reference (above)."""
    t_npu, acc = _models(seed)
    L = _lanes(seed)
    _, window = _utility_kw(L, "float64")
    port, _ = _port_utility64(t_npu, acc, L, 64, True)
    for b in range(LANES):
        ref, _ = _ref_utility64(t_npu, acc, L, window, b, 64)
        plain = all((r == p).all() for r, p in zip(ref, _front_dp(t_npu, acc, L, b, 64, fused=False)))
        fused = all((r == f).all() for r, f in zip(ref, _front_dp(t_npu, acc, L, b, 64, fused=True)))
        assert plain or fused, b
        if plain:
            assert all((g[b] == r).all() for g, r in zip(port, ref)), b
        if len(t_npu) in (2, 4):
            assert plain, b


def test_wide_fronts_occur():
    """Some seeded instances grow fronts past the fast width of 64: the
    exact form flags the cap overflow there (and the comparisons above
    cover its truncation)."""
    wide = 0
    for seed in SEEDS:
        t_npu, acc = _models(seed)
        _, flag = _port_utility64(t_npu, acc, _lanes(seed), 64, True)
        wide += int(flag.sum())
    assert wide > 0


def test_utility_dp64_epsilon_ties_flag_the_fast_form():
    """Three candidates 0.6e-12 apart in utility, rising in time: the
    reference keeps the first and the third (its bar is the last KEPT
    utility); a running maximum of all candidates would drop the third.
    The exact form keeps both; the fast form flags the lane for the rerun."""
    t_npu = np.array([0.020, 0.021, 0.022])
    acc = np.array([0.5, 0.5 + 6e-13, 0.5 + 1.2e-12])
    L = dict(gamma=np.array([1 / 30]), deadline=np.array([0.2]), alpha=np.array([1.0]),
             npu_free=np.array([0.0]), first_arrival=np.array([0.0]), n_active=np.array([W]))
    want = _front_dp(t_npu, acc, L, 0, 64, fused=False)
    exact, flag = _port_utility64(t_npu, acc, L, 64, True)
    fast, fast_flag = _port_utility64(t_npu, acc, L, 64, False)
    assert all((g[0] == w).all() for g, w in zip(exact, want)) and not flag[0]
    assert fast_flag[0] and not all((g[0] == w).all() for g, w in zip(fast, want))


@pytest.mark.parametrize("seed", SEEDS)
def test_accuracy_dp_lanes_equal_one_lane_and_reference(seed):
    t_npu, acc = _models(seed)
    L = _lanes(seed)
    L["first_arrival"] = np.zeros(LANES)
    arr, dl, dur, start = _bins(t_npu, L)
    acc32 = torch.from_numpy(acc.astype(np.float32))
    n_act = L["n_active"]
    H, cho, par = tsched._accuracy_dp(_t(dur), acc32, _t(arr), _t(dl), _t(start), _t(n_act), nbins=NBINS)
    got = [H.numpy(), torch.stack(cho, 1).numpy(), torch.stack(par, 1).numpy()]
    for b in range(LANES):
        one_lane = slice(b, b + 1)
        oH, oc, op = tsched._accuracy_dp(_t(dur[one_lane]), acc32, _t(arr[one_lane]), _t(dl[one_lane]),
                                         _t(start[one_lane]), _t(n_act[one_lane]), nbins=NBINS)
        one = [oH.numpy(), torch.stack(oc, 1).numpy(), torch.stack(op, 1).numpy()]
        assert all((g[b] == o[0]).all() for g, o in zip(got, one)), b
        with jax.experimental.enable_x64():
            ref = [np.asarray(x) for x in jsched._accuracy_dp(
                jnp.asarray(dur[b]), jnp.asarray(acc.astype(np.float32)), jnp.asarray(arr[b]), jnp.asarray(dl[b]),
                jnp.int32(start[b]), jnp.int32(n_act[b]), n_frames=W, nbins=NBINS)]
        assert all((g[b] == r).all() for g, r in zip(got, ref)), b


def _utility32(t32, a32, L, lanes):
    kw, _ = _utility_kw({k: v[lanes] for k, v in L.items()}, "float32")
    (t, u, m, v), par, act = tsched._utility_dp(
        torch.from_numpy(t32), torch.from_numpy(a32), _t(L["n_active"][lanes]), width=64, n_frames=W, **kw)
    return [x.numpy() for x in (t, u, m, v, torch.stack(par, 1), torch.stack(act, 1))]


@pytest.mark.parametrize("seed", SEEDS)
def test_utility_dp_lanes_equal_one_lane_and_reference_x64(seed):
    t_npu, acc = _models(seed)
    L = _lanes(seed)
    t32, a32 = t_npu.astype(np.float32), acc.astype(np.float32)
    _, window = _utility_kw(L, "float32")
    got = _utility32(t32, a32, L, slice(None))
    for b in range(LANES):
        one = _utility32(t32, a32, L, slice(b, b + 1))
        assert all((g[b] == o[0]).all() for g, o in zip(got, one)), b
        with jax.experimental.enable_x64():
            assert jnp.asarray(np.int64(1)).dtype == jnp.int64  # the okey branch
            (rt, ru, rm, rv), rpar, ract, _ = jsched._utility_dp(
                jnp.asarray(t32), jnp.asarray(a32), jnp.int32(L["n_active"][b]), n_frames=W, width=64,
                **{k: jnp.float32(L[k][b]) for k in ("gamma", "deadline", "alpha", "npu_free", "first_arrival")},
                window=jnp.float32(window[b]))
        ref = [np.asarray(x) for x in (rt, ru, rm, rv, rpar, ract)]
        assert all((g[b] == r).all() for g, r in zip(got, ref)), b
