"""On-device implementations of the two scheduling DPs, in float32.

The Python implementations in max_accuracy/max_utility are the reference
semantics; these run the same recurrences as fixed-shape tensor programs on
a torch device, so a serving loop can schedule on the card:

  local_accuracy_dp_jax   H(k, t) over a time grid     (loop over frames)
  local_utility_dp_jax    fixed-width Pareto front DP  (loop over frames)

The module keeps the reference's name, and its two policies keep
theirs (``jax_accuracy``, ``jax_utility``): they are part of the
``ScenarioSpec`` JSON schema, so one spec file runs in either package.

Both DPs carry a leading lane axis ``B``: the sweep engine
(:mod:`repro_torch.core.sim_batch`) runs a group of scenarios at once, and
one stream is one lane.  A DP is a Python loop over the window's frames of
tensor ops on ``device``, with no host synchronization inside the loop;
frames past a lane's ``n_active`` pass through.  A one-stream round copies
its inputs to the device once and its choice/parent rows back once, for the
backtrack.

Every quantity is float32, as in the reference, and every operation is
chosen to round exactly as the reference's does:
  * scalars (gamma, deadline, alpha, window, ...) are float32 tensors on
    ``device`` — a division by a Python number may be lowered to a
    multiply by its reciprocal on the card, one ulp off;
  * where the reference's XLA CPU backend fuses a multiply into the add
    that consumes it (``arrival = first_arrival + k * gamma`` and the
    utility's ``mean_term``), the port rounds once too (:func:`_fma32`):
    rounding the product first moves 19 of 200 seeded utilities by 1-2 ulp
    and changes the picks of 3;
  * ties keep the first maximum (``torch.argmax``, like ``jnp.argmax``);
  * the candidate sort ``lax.sort((t, -u, idx), num_keys=2, is_stable=True)``
    is two stable sorts, by ``-u`` then by ``t``; both keys have ``+ 0.0``
    added so ``-0.0`` and ``+0.0`` compare equal, as in ``lax.sort``.

``_accuracy_dp64`` / ``_utility_dp64`` are the float64 twins of the paper's
``max_accuracy`` / ``max_utility`` local phases, for the sweep engine's
network-aware planners.  They keep every sequential tie-break of those
Python references (first model wins ties, case A beats case B, stable
``(t, -u)`` order, the last KEPT utility as the dominance bar) and round
every product before the add it feeds, as Python does.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .profiles import ModelProfile, NetworkState, StreamSpec
from .registry import Param, register_policy
from .schedule import Decision, RoundPlan, Where

NEG = -1e18
BIG_T = 1e9

__all__ = [
    "NEG",
    "local_accuracy_dp_jax",
    "local_utility_dp_jax",
    "plan_round_accuracy",
    "plan_round_utility",
]


def _lane(x: float, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A one-lane ``[1]`` tensor on ``device``, made by a fill kernel (a
    float rounds to nearest as ``np.float32`` rounds it), so no host copy
    and no stream synchronization."""
    return torch.full((1,), x, dtype=dtype, device=device)


def _to_device(device: torch.device, *parts: Sequence[float]) -> list[torch.Tensor]:
    """Several host vectors (model tables, frame bins) in one float64 copy
    to the device per round, split back into one tensor each."""
    flat = torch.from_numpy(np.concatenate([np.asarray(p, np.float64) for p in parts])).to(device)
    return list(torch.split(flat, [len(p) for p in parts]))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors with ONE rounding, as a fused
    multiply-add rounds it.

    The reference's XLA CPU backend contracts a multiply feeding an add
    inside one fused loop into an FMA; plain tensor ops would round the
    product first and land one ulp away.  The product of two float32
    numbers is exact in float64; the float64 sum is then rounded to odd
    (TwoSum gives its exact error, ``nextafter`` moves an inexact even
    result toward the true value), and rounding that to float32 is the
    correctly rounded fused result."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(err > 0, s + s.abs() + 1.0, s - s.abs() - 1.0))
    return torch.where((err != 0) & even, away, s).float()


def _to_host(*parts: torch.Tensor) -> list[np.ndarray]:
    """One device-to-host copy for several int64/int32/float32 tensors.

    Float32 parts travel as their int32 bit patterns, so they come back
    bit for bit."""
    flat = [
        (p.view(torch.int32) if p.dtype == torch.float32 else p).reshape(-1).to(torch.int64)
        for p in parts
    ]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for p in parts:
        n = p.numel()
        chunk = host[at : at + n].reshape(tuple(p.shape))
        if p.dtype == torch.float32:
            chunk = chunk.astype(np.int32).view(np.float32)
        out.append(chunk)
        at += n
    return out


# ---------------------------------------------------------------------------
# Max-Accuracy local phase (Eq. 7/8)
# ---------------------------------------------------------------------------


def local_accuracy_dp_jax(
    models: Sequence[ModelProfile],
    *,
    n_frames: int,
    gamma: float,
    deadline: float,
    npu_free: float,
    first_arrival: float,
    grid: float = 1e-3,
    device: Any = "cuda",
):
    """Mirror of max_accuracy.local_dp; returns (total, model per frame) or
    (NEG, []) when infeasible.  ``total`` is the float32 DP value."""
    local = [(j, m) for j, m in enumerate(models) if m.runs_local]
    if n_frames <= 0:
        return 0.0, []
    if not local:
        return NEG, []
    horizon = first_arrival + (n_frames - 1) * gamma + deadline
    nbins = int(np.ceil(horizon / grid)) + 2
    # Bin arithmetic in f64 on the host — identical to max_accuracy.local_dp.
    arrivals = first_arrival + np.arange(n_frames) * gamma
    device = torch.device(device)
    acc, dur, arr_bins, dl_bins = _to_device(
        device,
        [m.acc_npu[max(m.acc_npu)] if m.acc_npu else 0.0 for _, m in local],
        [int(np.ceil(m.t_npu / grid)) for _, m in local],
        np.ceil(arrivals / grid).astype(np.int32),
        np.floor((arrivals + deadline) / grid).astype(np.int32),
    )
    start_bin = _lane(int(np.ceil(max(npu_free, 0.0) / grid)), device, torch.int64)
    H, choices, parents = _accuracy_dp(
        dur.long()[None], acc.float(), arr_bins.long()[None], dl_bins.long()[None], start_bin, nbins=nbins
    )
    H, choices, parents = _to_host(H[0], torch.stack(choices, 1)[0], torch.stack(parents, 1)[0])
    total = float(H.max())
    if total <= NEG / 2:
        return NEG, []
    b = int(H.argmax())
    out = []
    for k in range(n_frames - 1, -1, -1):
        out.append(local[int(choices[k, b])][0])
        b = int(parents[k, b])
    out.reverse()
    return total, out


# ---------------------------------------------------------------------------
# Max-Utility local phase (dominance-pruned triples) — fixed-width front
# ---------------------------------------------------------------------------


def local_utility_dp_jax(
    models: Sequence[ModelProfile],
    *,
    n_frames: int,
    gamma: float,
    deadline: float,
    alpha: float,
    npu_free: float,
    first_arrival: float,
    window: float,
    width: int = 64,
    device: Any = "cuda",
):
    """Mirror of max_utility.local_utility_dp; returns (utility, [(k, j)])."""
    if n_frames <= 0:
        return 0.0, []
    local = [(j, m) for j, m in enumerate(models) if m.runs_local]
    if not local:
        return 0.0, []
    device = torch.device(device)
    t_npu, acc = (x.float() for x in _to_device(
        device,
        [m.t_npu for _, m in local],
        [m.acc_npu[max(m.acc_npu)] if m.acc_npu else 0.0 for _, m in local],
    ))
    # Scalars are rounded to float32 here, as the reference pins them.
    f32 = {k: _lane(np.float32(v), device) for k, v in (
        ("gamma", gamma), ("deadline", deadline), ("alpha", alpha), ("npu_free", npu_free),
        ("first_arrival", first_arrival), ("window", max(window, gamma)))}
    (_, u, _, _), parents, actions = _utility_dp(
        t_npu, acc, _lane(n_frames, device, torch.int64), width=width, n_frames=n_frames, **f32
    )
    u, parents, actions = _to_host(u[0], torch.stack(parents, 1)[0], torch.stack(actions, 1)[0])
    best_slot = int(u.argmax())
    best_u = float(u[best_slot])
    decisions: list[tuple[int, int]] = []
    slot = best_slot
    for k in range(n_frames - 1, -1, -1):
        a = int(actions[k, slot])
        if a >= 0:
            decisions.append((k, local[a][0]))
        slot = int(parents[k, slot])
        if slot < 0:
            break
    decisions.reverse()
    return best_u, decisions


# ---------------------------------------------------------------------------
# Lane-batched DPs for the sweep engine (core/sim_batch).  Every per-scenario
# quantity carries a leading lane axis ``B``; one Python loop over the
# window's frames issues each tensor op once for the whole group of lanes.
# Nothing in these functions copies to or from the host.
# ---------------------------------------------------------------------------


def _accuracy_lanes(dur, acc, arr_bins, dl_bins, start_bin, *, nbins, n_active=None, records=False):
    """H over the time grid for ``B`` lanes at once, in ``acc``'s dtype.

    ``dur`` [B, J] int64 duration bins, ``acc`` [J] the DP's accuracy table,
    ``arr_bins``/``dl_bins`` [B, W] int64, ``start_bin`` [B] int64.  Frames
    ``k >= n_active`` ([B]) are identity pass-throughs.  Returns ``(H,
    choices, parents, rec)``: ``H`` [B, nbins], the per-frame ``[B, nbins]``
    choice/parent rows as lists of length W, and with ``records=True`` the
    per-frame ``(max H, first argmax bin)`` as two [B, W] tensors."""
    B, W = arr_bins.shape
    J = dur.shape[1]
    dtype, device = acc.dtype, acc.device
    bins = torch.arange(nbins, dtype=torch.int64, device=device)
    neg = torch.full((), NEG, dtype=dtype, device=device)
    minus1 = torch.full((), -1, dtype=torch.int64, device=device)
    src = bins - dur[:, :, None]  # [B, J, nbins]
    src_c = src.clamp(0, nbins - 1)
    src_flat = src_c.reshape(B, J * nbins)
    hit_bins = bins[None, None, :]
    a = acc[None, :]  # [1, J]
    H = torch.where(bins == start_bin.clamp(0, nbins - 1)[:, None],
                    torch.zeros((), dtype=dtype, device=device), neg)
    choices, parents, max_h, arg_h = [], [], [], []
    for k in range(W):
        arr_bin = arr_bins[:, k, None]  # [B, 1]
        dl_bin = dl_bins[:, k, None]
        # prefix max (and its first argmax) of H over [0, arr_bin]
        masked = torch.where(bins <= arr_bin, H, neg)
        pre_arg = torch.argmax(masked, dim=1, keepdim=True)  # [B, 1]
        pre_val = masked.gather(1, pre_arg)
        # Case A: NPU free <= arrival, finish at arr_bin + d.
        fbA = arr_bin + dur  # [B, J]
        okA = (fbA <= dl_bin) & (fbA < nbins) & (pre_val > NEG / 2)
        hitA = (hit_bins == fbA[:, :, None]) & okA[:, :, None]  # [B, J, nbins]
        valA = torch.where(hitA, (pre_val + a)[:, :, None], neg)
        parA = torch.where(hitA, pre_arg[:, :, None], minus1)
        # Case B: free after arrival; target b takes from source b - d.
        okB = (src > arr_bin[:, :, None]) & (src >= 0) & (hit_bins <= dl_bin[:, :, None])
        gathered = torch.where(okB, H.gather(1, src_flat).view(B, J, nbins), neg)
        valB = torch.where(gathered > NEG / 2, gathered + a[:, :, None], neg)
        parB = torch.where(valB > NEG / 2, src_c, minus1)
        pickA = valA >= valB
        vals = torch.where(pickA, valA, valB)
        pars = torch.where(pickA, parA, parB)
        best_j = torch.argmax(vals, dim=1, keepdim=True)  # [B, 1, nbins], first maximum
        Hn = vals.gather(1, best_j)[:, 0]
        parent = pars.gather(1, best_j)[:, 0]
        live = Hn > NEG / 2
        choice = torch.where(live, best_j[:, 0], minus1)
        parent = torch.where(live, parent, minus1)
        if n_active is not None:  # padded frame: identity pass-through, no decision
            on = (k < n_active)[:, None]
            Hn = torch.where(on, Hn, H)
            choice = torch.where(on, choice, minus1)
            parent = torch.where(on, parent, bins)
        if records:
            arg = torch.argmax(Hn, dim=1, keepdim=True)
            max_h.append(Hn.gather(1, arg)[:, 0])
            arg_h.append(arg[:, 0])
        choices.append(choice)
        parents.append(parent)
        H = Hn
    rec = (torch.stack(max_h, dim=1), torch.stack(arg_h, dim=1)) if records else None
    return H, choices, parents, rec


def _accuracy_dp(dur, acc, arr_bins, dl_bins, start_bin, n_active=None, *, nbins):
    """The float32 Max-Accuracy DP for ``B`` lanes (``acc`` float32; one
    stream is one lane), frames past ``n_active[b]`` passed through.
    Returns ``(H, choices, parents)``."""
    H, choices, parents, _ = _accuracy_lanes(
        dur, acc, arr_bins, dl_bins, start_bin, nbins=nbins, n_active=n_active)
    return H, choices, parents


def _utility_dp(t_npu, acc, n_active, *, width, gamma, deadline, alpha, npu_free,
                first_arrival, window, n_frames):
    """The float32 fixed-width Pareto-front DP for ``B`` lanes (one stream
    is one lane): ``t_npu``/``acc`` [J] float32, every scalar a float32 [B]
    tensor, frames ``k >= n_active[b]`` passed through.  Candidates are the
    carried slots, then the processed ones model-major, as the reference's;
    its x64 path sorts single int64 keys ``okey << 32 | index``, and two
    stable sorts give the same permutation.  Returns ``((t, u, m, valid),
    parents, actions)``, the last two lists of ``n_frames`` [B, width]
    tensors."""
    device = acc.device
    B, J = gamma.shape[0], t_npu.shape[0]
    M = width * (J + 1)
    f32, i64 = torch.float32, torch.int64
    neg = torch.full((), NEG, dtype=f32, device=device)
    big_t = torch.full((), BIG_T, dtype=f32, device=device)
    zero = torch.zeros((), dtype=f32, device=device)
    zero_i = torch.zeros((), dtype=i64, device=device)
    minus1 = torch.full((), -1, dtype=i64, device=device)
    slots = torch.arange(width, dtype=i64, device=device)
    ranks = torch.arange(1, width + 1, dtype=i64, device=device).expand(B, width).contiguous()
    cparent = torch.cat([slots, slots.repeat(J)]).expand(B, M)
    caction = torch.cat([torch.full((width,), -1, dtype=i64, device=device),
                         torch.arange(J * width, dtype=i64, device=device) // width]).expand(B, M)
    ks = torch.arange(n_frames, dtype=f32, device=device)
    arrivals = _fma32(ks[None, :], gamma[:, None], first_arrival[:, None])  # [B, n_frames]
    limits = (arrivals + deadline[:, None]) + torch.full((), 1e-12, dtype=f32, device=device)
    alpha_acc = (alpha[:, None] * acc[None, :])[:, :, None]  # [B, J, 1]
    win = window[:, None]
    valid = (slots == 0).expand(B, width)
    t = torch.where(valid, torch.maximum(npu_free, zero)[:, None], big_t)
    u = torch.where(valid, zero, neg)
    m = torch.zeros((B, width), dtype=i64, device=device)
    parents, actions = [], []
    for k in range(n_frames):
        t2 = torch.maximum(t, arrivals[:, k, None])[:, None, :] + t_npu[None, :, None]  # [B, J, width]
        ok = valid[:, None, :] & (t2 <= limits[:, k, None, None])
        mf = m.to(f32)
        mf1 = mf + 1
        mean_term = _fma32((mf / mf1)[:, None, :], (u - mf / win)[:, None, :], alpha_acc / mf1[:, None, :])
        u2 = mean_term + (mf1 / win)[:, None, :]
        ct = torch.cat([t, torch.where(ok, t2, big_t).reshape(B, -1)], dim=1)
        cu = torch.cat([u, torch.where(ok, u2, neg).reshape(B, -1)], dim=1)
        cm = torch.cat([m, torch.where(ok, m[:, None, :] + 1, zero_i).reshape(B, -1)], dim=1)
        cok = torch.cat([valid, ok.reshape(B, -1)], dim=1)
        cu = torch.where(cok, cu, neg)
        ct = torch.where(cok, ct, big_t)
        # Stable sort by (t asc, u desc): two stable sorts, -0.0 keys
        # leveled with +0.0 as lax.sort levels them.
        by_u = torch.sort((-cu) + zero, dim=1, stable=True).indices
        by_t = torch.sort(ct.gather(1, by_u) + zero, dim=1, stable=True).indices
        perm = by_u.gather(1, by_t)
        ct, cu, cm = ct.gather(1, perm), cu.gather(1, perm), cm.gather(1, perm)
        cpar, cact = cparent.gather(1, perm), caction.gather(1, perm)
        run = torch.cummax(cu, dim=1).values
        prev_run = torch.cat([neg.expand(B, 1), run[:, :-1]], dim=1)
        keep = cu > prev_run + 1e-12
        csum = torch.cumsum(keep.to(i64), dim=1)
        pos = torch.searchsorted(csum, ranks).clamp(0, M - 1)
        filled = slots < csum[:, -1:]
        nt = torch.where(filled, ct.gather(1, pos), big_t)
        nu = torch.where(filled, cu.gather(1, pos), neg)
        nm = torch.where(filled, cm.gather(1, pos), zero_i)
        npar = torch.where(filled, cpar.gather(1, pos), minus1)
        nact = torch.where(filled, cact.gather(1, pos), minus1)
        on = (k < n_active)[:, None]  # padded frame: identity pass-through
        t = torch.where(on, nt, t)
        u = torch.where(on, nu, u)
        m = torch.where(on, nm, m)
        valid = torch.where(on, filled, valid)
        parents.append(torch.where(on, npar, slots))
        actions.append(torch.where(on, nact, minus1))
    return (t, u, m, valid), parents, actions


# ---------------------------------------------------------------------------
# Float64 twins of the paper's max_accuracy / max_utility local phases, for
# the network-aware sweep planners.  Those Python references run their DPs
# in float64, so the twins do too, and keep every sequential tie-break of
# the reference updates (first model wins ties, case A beats case B within
# a model, stable (t, -u) candidate order, the last KEPT utility as the
# dominance bar).
# ---------------------------------------------------------------------------


def _no_fma(product: torch.Tensor) -> torch.Tensor:
    """Marks a float64 product that must round before the add it feeds.

    The reference's XLA CPU backend would contract such a multiply and add
    into one fused multiply-add, and guards each one with a select that
    stops the contraction.  Eager PyTorch runs the multiply as its own
    kernel, which rounds and stores the product, so nothing is needed here;
    the marker keeps the guarded products at the reference's places.  (No
    fused op — ``addcmul``, ``lerp``, ``alpha=`` — may replace them.)"""
    return product


def _accuracy_dp64(dur, acc, arr_bins, dl_bins, start_bin, *, nbins):
    """f64 twin of ``max_accuracy.local_dp`` for ``B`` lanes, with per-step
    *prefix records*.

    Frame ``k``'s recurrence touches only frame-local bins, so the DP over
    frames ``0..nn-1`` is a strict prefix of the DP over the whole padded
    window: the per-frame records ``(max H, argmax bin, alive)`` equal what
    ``local_dp(n_frames=nn)`` returns for every ``nn``, all from one pass.
    Deadness propagates, so ``alive`` is prefix-monotone.  Returns
    ``(choices, parents, maxH, argb, alive)``: lists of W [B, nbins] rows,
    then three [B, W] tensors."""
    _, choices, parents, (max_h, arg_h) = _accuracy_lanes(
        dur, acc, arr_bins, dl_bins, start_bin, nbins=nbins, records=True)
    return choices, parents, max_h, arg_h, max_h > NEG / 2


def _keep_records(cu: torch.Tensor, width: int):
    """The Pareto prune's keep rule on sorted candidates ``cu`` [B, M], fast
    form: a candidate is kept if its utility beats the running maximum of
    all earlier candidates by 1e-12.

    The reference's bar is the last KEPT utility.  Kept utilities are
    always new running maxima, so the two bars differ only after a rejected
    candidate rose above the bar (within the epsilon).  ``suspect`` [B]
    flags the lanes where one did; elsewhere, by induction over the
    candidates, the two rules keep the same set.  Returns ``(pos, filled,
    count, suspect)``: slot ``s`` holds candidate ``pos[:, s]`` where
    ``filled``, keeping the first ``width`` keepers."""
    B, M = cu.shape
    device = cu.device
    run = torch.cummax(cu, dim=1).values
    prev_run = torch.cat([torch.full((B, 1), NEG, dtype=cu.dtype, device=device), run[:, :-1]], dim=1)
    keep = cu > prev_run + 1e-12
    suspect = (~keep & (cu > prev_run)).any(dim=1)
    csum = torch.cumsum(keep.to(torch.int64), dim=1)
    count = csum[:, -1]
    ranks = torch.arange(1, width + 1, dtype=torch.int64, device=device).expand(B, width).contiguous()
    pos = torch.searchsorted(csum, ranks).clamp(0, M - 1)
    slots = torch.arange(width, dtype=torch.int64, device=device)
    return pos, slots < count[:, None], count, suspect


def _keep_chain(cu: torch.Tensor, width: int):
    """The Pareto prune's keep rule on sorted candidates ``cu`` [B, M],
    exact form: the last kept utility is the bar, and on cap overflow the
    ``width`` highest-utility keepers stay (the LAST ``width`` in order).

    A kept candidate ``i`` is a new running maximum, so the next keeper
    after it is the first ``j`` whose running maximum exceeds ``u_i +
    1e-12``: one ``searchsorted`` gives every candidate's successor, and
    pointer doubling walks the chain from the first keeper.  Returns
    ``(pos, filled, count)`` as :func:`_keep_records` does."""
    B, M = cu.shape
    device = cu.device
    i64 = torch.int64
    run = torch.cummax(cu, dim=1).values
    nxt = torch.searchsorted(run, cu + 1e-12, right=True)  # [B, M] in [0, M]
    first = torch.searchsorted(run, torch.full((B, 1), NEG + 1e-12, dtype=cu.dtype, device=device),
                               right=True)  # [B, 1]
    jumps = [torch.cat([nxt, torch.full((B, 1), M, dtype=i64, device=device)], dim=1)]  # M: past the end
    while (1 << len(jumps)) <= M:
        jumps.append(jumps[-1].gather(1, jumps[-1]))
    at = first
    count = (first < M).to(i64)
    for level in range(len(jumps) - 1, -1, -1):
        cand = jumps[level].gather(1, at)
        step = cand < M
        at = torch.where(step, cand, at)
        count = count + step.to(i64) * (1 << level)
    count = count[:, 0]
    slots = torch.arange(width, dtype=i64, device=device)
    target = (count - width).clamp_min(0)[:, None] + slots  # [B, width] chain ranks kept
    pos = first.expand(B, width)
    for level, jump in enumerate(jumps):
        pos = torch.where(((target >> level) & 1) == 1, jump.gather(1, pos), pos)
    filled = slots < (count - (count - width).clamp_min(0))[:, None]
    return pos.clamp(0, M - 1), filled, count


def _utility_dp64(t_npu, acc, n_active, *, width, gamma, deadline, alpha, npu_free,
                  first_arrival, window, n_frames, exact):
    """f64 twin of ``max_utility.local_utility_dp`` (Pareto triples) for
    ``B`` lanes: ``t_npu``/``acc`` [J] float64 (``inf`` for server-only
    models), every scalar a float64 [B] tensor, frames ``k >= n_active[b]``
    passed through.

    Candidate order (carried triples first, then processed candidates
    slot-major — the reference's ``for tri in U: for j`` loops), the stable
    ``(t, -u)`` sort and the 1e-12 dominance epsilon mirror the Python
    reference.  ``exact=True`` applies its keep rule as it is
    (:func:`_keep_chain`), cap overflow included: at ``width = 256``, the
    reference's cap, that is the reference.  ``exact=False`` is the fast
    form (:func:`_keep_records`): exact unless a front outgrows ``width`` or
    two utilities meet within the epsilon, and the returned ``flag`` [B]
    reports a live frame where either happened; callers rerun those lanes
    with ``exact=True`` at the cap.  With ``exact=True`` the flag reports
    cap overflow.  Returns ``((t, u, m, valid), parents, actions, flag)``."""
    device = acc.device
    B, J = gamma.shape[0], t_npu.shape[0]
    M = width * (J + 1)
    f64, i64 = torch.float64, torch.int64
    neg = torch.full((), NEG, dtype=f64, device=device)
    big_t = torch.full((), BIG_T, dtype=f64, device=device)
    zero = torch.zeros((), dtype=f64, device=device)
    zero_i = torch.zeros((), dtype=i64, device=device)
    minus1 = torch.full((), -1, dtype=i64, device=device)
    slots = torch.arange(width, dtype=i64, device=device)
    cparent = torch.cat([slots, slots.repeat_interleave(J)]).expand(B, M)
    caction = torch.cat([torch.full((width,), -1, dtype=i64, device=device),
                         torch.arange(J, dtype=i64, device=device).repeat(width)]).expand(B, M)
    alpha_acc = alpha[:, None] * acc[None, :]  # [B, J]
    win = window[:, None]
    valid = (slots == 0).expand(B, width)
    t = torch.where(valid, torch.maximum(npu_free, zero)[:, None], big_t)
    u = torch.where(valid, zero, neg)
    m = torch.zeros((B, width), dtype=i64, device=device)
    flag = torch.zeros(B, dtype=torch.bool, device=device)
    parents, actions = [], []
    for k in range(n_frames):
        arrival = (first_arrival + _no_fma(k * gamma))[:, None]  # [B, 1]
        t2 = torch.maximum(t, arrival)[:, :, None] + t_npu  # [B, width, J]: slot-major
        ok = valid[:, :, None] & (t2 <= ((arrival + deadline[:, None]) + 1e-12)[:, :, None])
        mf = m.to(f64)
        mf1 = mf + 1.0
        mean_term = _no_fma((mf / mf1) * (u - mf / win))[:, :, None] + alpha_acc[:, None, :] / mf1[:, :, None]
        u2 = mean_term + (mf1 / win)[:, :, None]
        ct = torch.cat([t, torch.where(ok, t2, big_t).reshape(B, -1)], dim=1)
        cu = torch.cat([u, torch.where(ok, u2, neg).reshape(B, -1)], dim=1)
        cm = torch.cat([m, torch.where(ok, m[:, :, None] + 1, zero_i).reshape(B, -1)], dim=1)
        cok = torch.cat([valid, ok.reshape(B, -1)], dim=1)
        cu = torch.where(cok, cu, neg)
        ct = torch.where(cok, ct, big_t)
        by_u = torch.sort((-cu) + zero, dim=1, stable=True).indices
        by_t = torch.sort(ct.gather(1, by_u) + zero, dim=1, stable=True).indices
        perm = by_u.gather(1, by_t)
        ct, cu, cm = ct.gather(1, perm), cu.gather(1, perm), cm.gather(1, perm)
        cpar, cact = cparent.gather(1, perm), caction.gather(1, perm)
        if exact:
            pos, filled, count = _keep_chain(cu, width)
            step_flag = count > width
        else:
            pos, filled, count, suspect = _keep_records(cu, width)
            step_flag = (count > width) | suspect
        on = k < n_active
        flag = flag | (on & step_flag)
        on = on[:, None]
        t = torch.where(on, torch.where(filled, ct.gather(1, pos), big_t), t)
        u = torch.where(on, torch.where(filled, cu.gather(1, pos), neg), u)
        m = torch.where(on, torch.where(filled, cm.gather(1, pos), zero_i), m)
        valid = torch.where(on, filled, valid)
        parents.append(torch.where(on, torch.where(filled, cpar.gather(1, pos), minus1), slots))
        actions.append(torch.where(on, torch.where(filled, cact.gather(1, pos), minus1), minus1))
    return (t, u, m, valid), parents, actions, flag


# ---------------------------------------------------------------------------
# The on-device DPs as registered policies: local-only rounds.
# ---------------------------------------------------------------------------


@register_policy(
    "jax_accuracy",
    params=(
        Param.integer("window_frames", None, nullable=True, doc="DP window; default floor(T/gamma)"),
        Param.number("grid", 1e-3, doc="DP time grid (s)"),
    ),
    doc="On-device Max-Accuracy local DP (every window frame on the NPU).",
    batched=True,
    batched_multi=True,
)
def plan_round_accuracy(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    npu_free: float = 0.0,
    window_frames: int | None = None,
    grid: float = 1e-3,
    device: Any = "cuda",
) -> RoundPlan:
    """Local-only round via :func:`local_accuracy_dp_jax` — the on-device
    counterpart of the ``local`` baseline's accuracy mode (all frames
    processed; a best-effort skip of the whole window when infeasible)."""
    gamma, T = stream.gamma, stream.deadline
    n = window_frames if window_frames is not None else max(int(np.floor(T / gamma)), 1)
    total, picks = local_accuracy_dp_jax(
        models, n_frames=n, gamma=gamma, deadline=T,
        npu_free=npu_free, first_arrival=0.0, grid=grid, device=device,
    )
    if total <= NEG / 2:
        return RoundPlan(decisions=[Decision(0, Where.SKIP)], horizon=1, npu_busy_until=npu_free)
    decisions = []
    free = max(npu_free, 0.0)
    acc_sum = 0.0
    for k, j in enumerate(picks):
        start = max(free, k * gamma)
        free = start + models[j].t_npu
        decisions.append(Decision(k, Where.NPU, j, stream.r_max, start=start, finish=free))
        acc_sum += models[j].accuracy(stream.r_max, where="npu")
    return RoundPlan(
        decisions=decisions, horizon=n, expected_accuracy_sum=acc_sum, npu_busy_until=free
    )


@register_policy(
    "jax_utility",
    params=(
        Param.number("alpha", doc="paper Eq. (9) accuracy weight (required)"),
        Param.integer("window_frames", None, nullable=True, doc="DP window; default floor(T/gamma)"),
        Param.integer("width", 64, doc="Pareto-front width of the on-device DP"),
    ),
    doc="On-device Max-Utility local DP (dominance-pruned front, skips allowed).",
    batched=True,
    batched_multi=True,
)
def plan_round_utility(
    models: Sequence[ModelProfile],
    stream: StreamSpec,
    net: NetworkState,
    *,
    alpha: float,
    npu_free: float = 0.0,
    window_frames: int | None = None,
    width: int = 64,
    device: Any = "cuda",
) -> RoundPlan:
    """Local-only round via :func:`local_utility_dp_jax` — the on-device
    counterpart of the ``local`` baseline's utility mode."""
    gamma, T = stream.gamma, stream.deadline
    n = window_frames if window_frames is not None else max(int(np.floor(T / gamma)), 1)
    utility, picks = local_utility_dp_jax(
        models, n_frames=n, gamma=gamma, deadline=T, alpha=alpha,
        npu_free=npu_free, first_arrival=0.0, window=n * gamma, width=width,
        device=device,
    )
    chosen = dict(picks)
    decisions = []
    free = max(npu_free, 0.0)
    for k in range(n):
        j = chosen.get(k)
        if j is None:
            decisions.append(Decision(k, Where.SKIP))
            continue
        start = max(free, k * gamma)
        free = start + models[j].t_npu
        decisions.append(Decision(k, Where.NPU, j, stream.r_max, start=start, finish=free))
    return RoundPlan(
        decisions=decisions, horizon=n, expected_utility=utility, npu_busy_until=free
    )
