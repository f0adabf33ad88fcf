"""On-device implementations of the two scheduling DPs, in float32.

The Python implementations in max_accuracy/max_utility are the reference
semantics; these run the same recurrences as fixed-shape tensor programs on
a torch device, so a serving loop can schedule on the card:

  local_accuracy_dp_jax   H(k, t) over a time grid     (loop over frames)
  local_utility_dp_jax    fixed-width Pareto front DP  (loop over frames)

The module keeps the reference's name, and its two policies keep
theirs (``jax_accuracy``, ``jax_utility``): they are part of the
``ScenarioSpec`` JSON schema, so one spec file runs in either package.

Each round is a Python loop over the window's frames of tensor ops on
``[J, nbins]`` / ``[J * width]`` (``J`` local models) on ``device``, with
no host synchronization inside the loop; the per-frame choice/parent rows
are packed into one tensor and copied to the host once, for the backtrack.

Every quantity is float32, as in the reference, and every operation is
chosen to round exactly as the reference's does:
  * scalars (gamma, deadline, alpha, window, ...) are float32 0-dim tensors
    on ``device`` — a division by a Python number may be lowered to a
    multiply by its reciprocal on the card, one ulp off;
  * per-frame scalars (``arrival``, the deadline bound) are computed in
    float32 on the host, as the reference computes them in f32, and reach
    the kernels as arguments (exact: they are float32 values);
  * where the reference's XLA CPU backend fuses a multiply into the add
    that consumes it (``arrival = first_arrival + k * gamma`` and the
    utility's ``mean_term``), the port rounds once too (:func:`_fma32`):
    rounding the product first moves 19 of 200 seeded utilities by 1-2 ulp
    and changes the picks of 3;
  * ties keep the first maximum (``torch.argmax``, like ``jnp.argmax``);
  * the candidate sort ``lax.sort((t, -u, idx), num_keys=2, is_stable=True)``
    is two stable sorts, by ``-u`` then by ``t``; both keys have ``+ 0.0``
    added so ``-0.0`` and ``+0.0`` compare equal, as in ``lax.sort``.
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


def _f32(x: float, device: torch.device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``, made by a fill kernel (the
    value rounds to nearest as ``np.float32`` rounds it), so no host copy
    and no stream synchronization."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _to_device(rows: Sequence[Sequence[float]], device: torch.device) -> torch.Tensor:
    """Per-model inputs as one float64 ``[len(rows), J]`` tensor: one copy
    to the device per round."""
    return torch.tensor(rows, dtype=torch.float64).to(device)


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


def _accuracy_dp(
    dur: torch.Tensor,  # [J] int64 duration bins (computed host-side in f64)
    acc: torch.Tensor,  # [J] float32
    arr_bins: Sequence[int],  # [n_frames]
    dl_bins: Sequence[int],  # [n_frames]
    start_bin: int,
    *,
    n_frames: int,
    nbins: int,
):
    """H over the time grid, frame by frame; returns (H, choices, parents)
    as device tensors ``[nbins]``, ``[n_frames, nbins]``, ``[n_frames, nbins]``."""
    device = acc.device
    neg = _f32(NEG, device)
    neg_half = _f32(NEG / 2, device)
    bins = torch.arange(nbins, dtype=torch.int64, device=device)
    minus1 = torch.full((), -1, dtype=torch.int64, device=device)
    d = dur[:, None]  # [J, 1]
    a = acc[:, None]
    src = bins[None, :] - d  # [J, nbins]
    src_c = src.clamp(0, nbins - 1)

    # (Built with where: assigning a Python number into a card tensor copies
    # it from the host, which waits for the card.)
    H = torch.where(bins == min(max(start_bin, 0), nbins - 1), _f32(0.0, device), neg)
    choices, parents = [], []
    for k in range(n_frames):
        arr_bin, dl_bin = int(arr_bins[k]), int(dl_bins[k])
        # prefix max (and its first argmax) of H over [0, arr_bin]
        masked = torch.where(bins <= arr_bin, H, neg)
        pre_arg = torch.argmax(masked)
        pre_val = masked.gather(0, pre_arg.reshape(1)).reshape(())
        # Case A: NPU free <= arrival, finish at arr_bin + d.
        fbA = arr_bin + d  # [J, 1]
        okA = (fbA <= dl_bin) & (fbA < nbins) & (pre_val > neg_half)
        hitA = (bins[None, :] == fbA) & okA  # [J, nbins]
        valA = torch.where(hitA, pre_val + a, neg)
        parA = torch.where(hitA, pre_arg, minus1)
        # Case B: free after arrival; target b takes from source b - d.
        okB = (src > arr_bin) & (src >= 0) & (bins[None, :] <= dl_bin)
        gathered = torch.where(okB, H[src_c], neg)
        liveB = gathered > neg_half
        valB = torch.where(liveB, gathered + a, neg)
        parB = torch.where(valB > neg_half, src_c, minus1)
        pickA = valA >= valB
        vals = torch.where(pickA, valA, valB)
        pars = torch.where(pickA, parA, parB)
        best_j = torch.argmax(vals, dim=0)  # [nbins], first maximum
        Hn = vals.gather(0, best_j[None])[0]
        parent = pars.gather(0, best_j[None])[0]
        live = Hn > neg_half
        choices.append(torch.where(live, best_j, minus1))
        parents.append(torch.where(live, parent, minus1))
        H = Hn
    return H, torch.stack(choices), torch.stack(parents)


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
    acc, dur = _to_device([
        [m.acc_npu[max(m.acc_npu)] if m.acc_npu else 0.0 for _, m in local],
        [int(np.ceil(m.t_npu / grid)) for _, m in local],
    ], torch.device(device))
    acc, dur = acc.float(), dur.long()
    arrivals = first_arrival + np.arange(n_frames) * gamma
    arr_bins = np.ceil(arrivals / grid).astype(np.int32).tolist()
    dl_bins = np.floor((arrivals + deadline) / grid).astype(np.int32).tolist()
    start_bin = int(np.ceil(max(npu_free, 0.0) / grid))
    H, choices, parents = _accuracy_dp(
        dur, acc, arr_bins, dl_bins, start_bin, n_frames=n_frames, nbins=nbins
    )
    H, choices, parents = _to_host(H, choices, parents)
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


def _utility_dp(
    t_npu: torch.Tensor,  # [J] float32
    acc: torch.Tensor,  # [J] float32
    *,
    n_frames: int,
    width: int,
    gamma: float,
    deadline: float,
    alpha: float,
    npu_free: float,
    first_arrival: float,
    window: float,
):
    """The fixed-width Pareto front, frame by frame; returns ((t, u, m,
    valid), parents, actions) as device tensors, the last two
    ``[n_frames, width]``.  Scalars are rounded to float32 here, as the
    reference pins them."""
    device = acc.device
    J = t_npu.shape[0]
    M = width * (J + 1)
    neg = _f32(NEG, device)
    big_t = _f32(BIG_T, device)
    eps = _f32(1e-12, device)
    one = _f32(1.0, device)
    zero = _f32(0.0, device)
    alpha_t = _f32(np.float32(alpha), device)
    window_t = _f32(np.float32(window), device)
    # Every frame's arrival and deadline bound, in float32 on the host; they
    # reach the kernels as arguments, exactly (they are float32 values).
    f32 = torch.float32
    arrivals = _fma32(torch.arange(n_frames, dtype=f32), torch.tensor(gamma, dtype=f32),
                      torch.tensor(first_arrival, dtype=f32))
    limits = (arrivals + torch.tensor(deadline, dtype=f32)) + torch.tensor(1e-12, dtype=f32)

    slots = torch.arange(width, dtype=torch.int64, device=device)
    ranks = torch.arange(1, width + 1, dtype=torch.int64, device=device)
    zero_i = torch.zeros((), dtype=torch.int64, device=device)
    minus1 = torch.full((), -1, dtype=torch.int64, device=device)
    cparent = torch.cat([slots, slots.repeat(J)])
    caction = torch.cat([
        torch.full((width,), -1, dtype=torch.int64, device=device),
        torch.arange(J * width, dtype=torch.int64, device=device) // width,
    ])
    neg_head = neg.reshape(1)
    alpha_acc = (alpha_t * acc)[:, None]  # [J, 1]
    t_col = t_npu[:, None]

    valid = slots == 0
    t = torch.where(valid, _f32(max(np.float32(npu_free), np.float32(0.0)), device), big_t)
    u = torch.where(valid, zero, neg)
    m = torch.zeros((width,), dtype=torch.int64, device=device)
    parents, actions = [], []
    for arrival, limit in zip(arrivals.tolist(), limits.tolist()):
        # Candidates: carry-over (slot s, action -1) + process with model j.
        t2 = t.clamp_min(arrival)[None, :] + t_col  # [J, width]
        ok = valid[None, :] & (t2 <= limit)
        mf = m.to(torch.float32)
        mf1 = mf + one
        mean_term = _fma32(mf / mf1, u - mf / window_t, alpha_acc / mf1)
        u2 = mean_term + mf1 / window_t
        ct = torch.cat([t, torch.where(ok, t2, big_t).reshape(-1)])
        cu = torch.cat([u, torch.where(ok, u2, neg).reshape(-1)])
        cm = torch.cat([m, torch.where(ok, m + 1, zero_i).reshape(-1)])
        cok = torch.cat([valid, ok.reshape(-1)])
        cu = torch.where(cok, cu, neg)
        ct = torch.where(cok, ct, big_t)
        # Pareto prune: stable sort by (t asc, u desc), then keep strictly
        # rising u.  Invalid candidates carry (BIG_T, NEG) keys and sort
        # after every valid entry.
        by_u = torch.sort((-cu) + zero, stable=True).indices
        by_t = torch.sort(ct[by_u] + zero, stable=True).indices
        perm = by_u[by_t]
        ct, cu, cm = ct[perm], cu[perm], cm[perm]
        cpar, cact = cparent[perm], caction[perm]
        run = torch.cummax(cu, dim=0).values
        prev_run = torch.cat([neg_head, run[:-1]])
        keep = cu > prev_run + eps
        # Compact keepers to the front, truncate to width: the r-th output
        # slot gathers the r-th keeper, found by searchsorted (left) over
        # the keep-count prefix sum.
        csum = torch.cumsum(keep.to(torch.int64), dim=0)
        pos = torch.searchsorted(csum, ranks).clamp(0, M - 1)
        filled = slots < csum[-1]
        t = torch.where(filled, ct[pos], big_t)
        u = torch.where(filled, cu[pos], neg)
        m = torch.where(filled, cm[pos], zero_i)
        valid = filled
        parents.append(torch.where(filled, cpar[pos], minus1))
        actions.append(torch.where(filled, cact[pos], minus1))
    return (t, u, m, valid), torch.stack(parents), torch.stack(actions)


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
    t_npu, acc = _to_device([
        [m.t_npu for _, m in local],
        [m.acc_npu[max(m.acc_npu)] if m.acc_npu else 0.0 for _, m in local],
    ], torch.device(device)).float()
    (_, u, _, _), parents, actions = _utility_dp(
        t_npu,
        acc,
        n_frames=n_frames,
        width=width,
        gamma=gamma,
        deadline=deadline,
        alpha=alpha,
        npu_free=npu_free,
        first_arrival=first_arrival,
        window=max(window, gamma),
    )
    u, parents, actions = _to_host(u, parents, actions)
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
# The on-device DPs as registered policies: local-only rounds.
# ---------------------------------------------------------------------------


@register_policy(
    "jax_accuracy",
    params=(
        Param.integer("window_frames", None, nullable=True, doc="DP window; default floor(T/gamma)"),
        Param.number("grid", 1e-3, doc="DP time grid (s)"),
    ),
    doc="On-device Max-Accuracy local DP (every window frame on the NPU).",
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
