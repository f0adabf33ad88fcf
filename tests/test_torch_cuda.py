"""The port's CUDA kernels on the card, against their plain versions.

Needs an NVIDIA card and nvcc; skips elsewhere.  Imports only ``torch`` and
``repro_torch`` (no JAX), so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances and why:
  * int8_matmul: exact.  Both sides sum int8 products exactly (int32 in the
    kernel, split-K partials included; float64 below 2^53 in the plain
    version) and apply the same single f32 epilogue multiply, so outputs are
    compared bit for bit, on every load path and split count;
  * flash_attention: tests/test_kernels.py's, against the plain version on
    f32-upcast inputs — f32 rtol 1e-4 / atol 2e-5 (summation order and the
    online softmax), bf16 rtol 0.05 / atol 0.02 (bf16 inputs and output),
    at chip_smoke.py's shapes;
  * the smoke ViT through the kernel against the same forward with the plain
    attention: logits within 2% of the logit scale (the kernel keeps q.k in
    f32 where the plain version rounds it to bf16);
  * the smoke LMs' prefill cells through the kernel against the same cell
    with the plain attention (an MoE's expert picks pinned), and a decode
    cell against a prefill of the same tokens: logits within 2% of the logit
    scale, top-1 equal or a tie (chip_smoke's lm_full rule);
  * the smoke DiT and Flux denoise_step cells (non-zero modulation): the
    prediction through the kernel against the same forward with the plain
    attention on f32-upcast q, k, v, within 2% of max|prediction|, one
    launch an attention layer;
  * the ``jax_*`` planners' float32 DPs (``core/jax_sched``) on the card
    against the same call on the CPU: exact.  Every op rounds as IEEE
    float32/float64 on both (scalars are device tensors, fused roundings
    are emulated), so the DP values, picks and audited stats are equal;
  * the lane-batched sweep engine (``core/sim_batch``) on the card against
    the same call on the CPU, for the six batched policies at 100 points of
    chip_smoke's full-width grids: exact, for the same reason (divisors are
    per-lane device tensors, every product rounds before its add);
  * the lane-batched online engine (``core/sim_online_batch``) likewise, at
    100 points of the adaptivity grid: exact, ``estimated_bps`` included;
  * the lane-batched fleet engine (``core/sim_multi_batch``) likewise, for
    the seven batched_multi policies at 54 points of chip_smoke's fleet
    grid: exact, the scheduler's counters and the server's included;
  * a cached lane program (``core/sweep_shard``) replayed for a new group
    against the same group run with an empty cache: exact;
  * a smoke training step on the card against the same step on the CPU, from
    the same train state and batch: with the model modules in f32, the loss
    within ``TRAIN_LOSS_RTOL`` and the gradients within ``grad_limit``
    (relative L2 over every leaf; chip_smoke's train_full limits: f32 summed
    in another order), the wrong path beyond; one whole step as the model
    runs (bf16), its loss within ``TRAIN_BF16_LOSS_RTOL``; no launch of
    either kernel.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import (  # noqa: E402
    ADAPT_GRID,
    B7,
    FLEET_BASE,
    FLEET_PARAMS,
    FLEET_SMALL_GRID,
    ONLINE_PARAMS,
    FLASH_SHAPES,
    FLASH_TOL,
    GEMM_SHAPES,
    MISALIGNED,
    SWEEP_PARAMS,
    LM_LOGIT_RTOL,
    TRAIN_LOSS_RTOL,
    at_offset,
    attention_layers,
    draw_zero_leaves,
    grad_limit,
    prediction,
    batch_scenarios,
    compare_logits,
    expert_picks,
    fleet_scenarios,
    fleet_spec,
    full_grids,
    online_spec,
    own_fan_in,
    record_gemms,
    stats_rows,
    train_agreement,
    upcast_attention,
    ZOO_GEMMS,
)

from repro_torch import arch as A
from repro_torch import configs, core, quant, scenariogen, session
from repro_torch.core import compile_cache, jax_sched, profiles, sim_batch, sim_multi_batch, sim_online_batch, sweep_shard
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.npu_matmul import ops, ref
from repro_torch.launch import steps
from repro_torch.models import common, convnets, diffusion, lm, vision
from repro_torch.models import layers as L
from repro_torch.models.common import init_tree, matmul_backend

SHAPES = GEMM_SHAPES  # tests/test_kernels.py's, then the split-K, narrow-load and large-M shapes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_kernel_bitwise_equals_plain(cuda_device, m, k, n):
    g = torch.Generator(device=cuda_device).manual_seed(m + 7 * k + 13 * n)
    x = torch.randn(m, k, device=cuda_device, generator=g)
    w = torch.randn(k, n, device=cuda_device, generator=g)
    xq, xs = ref.quantize_rowwise(x)
    wq, ws = ref.quantize_colwise(w)
    before = ops.int8_matmul.launches
    out = ops.int8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert ops.int8_matmul.launches == before + 1
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert torch.equal(out, ref.int8_matmul_ref(xq, wq, xs, ws))


def _quantized(device, m, k, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    xq, xs = ref.quantize_rowwise(torch.randn(m, k, device=device, generator=g))
    wq, ws = ref.quantize_colwise(torch.randn(k, n, device=device, generator=g))
    return xq, wq, xs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,offset", MISALIGNED)
def test_kernel_misaligned_operands_take_narrow_loads(cuda_device, m, k, n, offset):
    xq, wq, xs, ws = _quantized(cuda_device, m, k, n, seed=m + k + n)
    xq, wq = at_offset(torch, xq, offset), at_offset(torch, wq, offset)
    width = 4 if offset % 4 == 0 else 1
    assert ops.load_widths(k, n, xq.data_ptr(), wq.data_ptr()) == (width, width)
    out = ops.int8_matmul(xq, wq, xs, ws)
    assert torch.equal(out, ref.int8_matmul_ref(xq, wq, xs, ws))


@pytest.mark.cuda
def test_split_k_counters_reset_between_calls(cuda_device):
    """Back-to-back split-K calls on one stream reuse the workspace: each
    must find its tiles' counters at 0 again."""
    m, k, n = 49, 4608, 512
    assert ops.plan(m, n, k)[1] > 1
    xq, wq, xs, ws = _quantized(cuda_device, m, k, n, seed=5)
    plain = ref.int8_matmul_ref(xq, wq, xs, ws)
    outs = [ops.int8_matmul(xq, wq, xs, ws) for _ in range(5)]
    assert all(torch.equal(o, plain) for o in outs)
    assert int(ops.workspace(xq.device)[1].abs().sum()) == 0


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    xq = torch.zeros(8, 16, dtype=torch.int8, device=cuda_device)
    wq = torch.zeros(8, 16, dtype=torch.int8, device=cuda_device).t()
    with pytest.raises(ValueError):
        ops.int8_matmul(xq, wq, torch.ones(8, device=cuda_device), torch.ones(8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_b7_full_width_gemm_shapes_bitwise_equal_plain(cuda_device, batch):
    """Every GEMM one full-width EfficientNet-B7 NPU forward issues at 224²
    (219 of them: the stem's [B·112², 27] x [27, 64], the squeeze-excite
    pairs at M = B with K and N down to 8, the head conv and the head),
    bitwise against the plain version."""
    shapes = record_gemms(torch, A, configs, common, B7, batch)
    assert len(shapes) == ZOO_GEMMS[B7] == 219
    assert shapes[0] == (batch * 112 * 112, 27, 64) and shapes[-1] == (batch, 2560, 1000)
    for m, k, n in dict.fromkeys(shapes):
        xq, wq, xs, ws = _quantized(cuda_device, m, k, n, seed=m + 7 * k + 13 * n)
        assert torch.equal(ops.int8_matmul(xq, wq, xs, ws), ref.int8_matmul_ref(xq, wq, xs, ws)), (m, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("name,gemms", [("resnet-50", 10), ("squeezenet", 26), ("efficientnet-b7", 42), ("swin-b", 0)])
def test_npu_forward_through_kernel_equals_plain_backend(cuda_device, name, gemms):
    arch = configs.get(name, smoke=True)
    specs, state_specs = A.abstract_params(arch)
    params = init_tree(torch.Generator().manual_seed(0), specs, device=cuda_device)
    state = init_tree(torch.Generator().manual_seed(1), state_specs, device=cuda_device)
    qparams, _ = quant.npu_variant(params, specs)

    def forward(p, x):
        return A.classifier_forward(arch, p, state, x, train=False)[0]

    x = torch.randn(4, 32, 32, 3, device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(2))
    before = ops.int8_matmul.launches
    out = quant.npu_forward(forward)(qparams, x)
    torch.cuda.synchronize()
    assert ops.int8_matmul.launches - before == gemms
    with matmul_backend(ref.npu_matmul_ref), torch.no_grad():
        plain = forward(qparams, x)
    assert torch.equal(out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kh,hd,causal,dtype", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, b, s, t, h, kh, hd, causal, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(b * 7919 + s * 31 + t + hd)
    q, k, v = (torch.randn(b, n, nh, hd, device=cuda_device, generator=g).to(getattr(torch, dtype))
               for n, nh in ((s, h), (t, kh), (t, kh)))
    before = flash_ops.flash_attention.launches
    out = flash_ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    plain = flash_ref.sdpa_ref(q.float(), k.float(), v.float(), causal=causal)
    rtol, atol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), plain, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_flash_misaligned_bf16_takes_cuda_core_kernel(cuda_device):
    b, s, t, h, kh, hd = 2, 128, 128, 8, 4, 64
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (at_offset(torch, torch.randn(b, n, nh, hd, device=cuda_device, generator=g).bfloat16(), 1)
               for n, nh in ((s, h), (t, kh), (t, kh)))
    assert flash_ops.kernel_path(q.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr()) == "fma"
    out = flash_ops.attention(q, k, v, causal=True)
    plain = flash_ref.sdpa_ref(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(out.float(), plain, rtol=FLASH_TOL["bfloat16"][0], atol=FLASH_TOL["bfloat16"][1])


@pytest.mark.cuda
def test_flash_kernel_rejects_non_contiguous(cuda_device):
    q = torch.zeros(1, 4, 8, 2, 16, device=cuda_device).transpose(1, 2)[..., 0, :]
    k = torch.zeros(1, 8, 2, 16, device=cuda_device)
    with pytest.raises(ValueError):
        flash_ops.attention(q, k, k, causal=False)


@pytest.mark.cuda
def test_vit_forward_through_flash_kernel_equals_plain_attention(cuda_device, monkeypatch):
    arch = configs.get("vit-s16", smoke=True)
    specs, _ = A.abstract_params(arch)
    params = own_fan_in(init_tree(torch.Generator().manual_seed(0), specs, device=cuda_device), arch.cfg)
    x = torch.randn(8, 32, 32, 3, device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(2))
    before = flash_ops.flash_attention.launches
    with torch.no_grad():
        out = A.classifier_forward(arch, params, {}, x, train=False)[0]
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches - before == arch.cfg.n_layers
    monkeypatch.setattr(flash_ops, "attention",
                        lambda q, k, v, *, causal=True, **_: flash_ref.sdpa_ref(q, k, v, causal=causal))
    with torch.no_grad():
        plain = A.classifier_forward(arch, params, {}, x, train=False)[0]
    assert float((out - plain).abs().max()) <= 0.02 * float(plain.abs().max())


def _dp_case(seed: int):
    """1-3 seeded local models (a twin of model 0 on every third seed, so
    models tie) and one window's DP arguments."""
    rng = np.random.default_rng(seed)
    models = []
    for j in range(int(rng.integers(1, 4))):
        acc = float(np.round(rng.uniform(0.3, 0.9), 3))
        models.append(profiles.profile_ms(f"m{j}", t_npu_ms=float(rng.uniform(8.0, 150.0)), t_server_ms=50.0,
                                          acc_server={224: acc + 0.05}, acc_npu={224: acc}))
    if seed % 3 == 0:
        models.append(models[0])
    n = int(rng.integers(1, 12))
    gamma = float(rng.choice([1 / 30, 1 / 15, 0.1]))
    kw = dict(n_frames=n, gamma=gamma, deadline=float(rng.choice([0.1, 0.2, 0.3])),
              npu_free=float(rng.uniform(0.0, 0.2)) if seed % 2 else 0.0,
              first_arrival=float(rng.uniform(0.0, 0.1)) if seed % 3 == 2 else 0.0)
    return models, kw, dict(alpha=float(rng.choice([1.0, 50.0, 200.0])), window=n * gamma)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(16))
def test_jax_sched_dps_on_card_equal_cpu(cuda_device, seed):
    models, kw, ukw = _dp_case(seed)
    for dp, extra in ((jax_sched.local_accuracy_dp_jax, {}), (jax_sched.local_utility_dp_jax, ukw)):
        assert dp(models, **kw, **extra, device=cuda_device) == dp(models, **kw, **extra, device="cpu"), dp.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("name,params", [("jax_accuracy", {}), ("jax_utility", {"alpha": 200.0})])
def test_jax_planners_run_sim_on_card_equal_cpu(cuda_device, name, params):
    spec = session.ScenarioSpec(policy={"name": name, "params": params}, n_frames=180,
                                trace=session.TraceSpec(kind="piecewise", points=((0.0, 3.5), (1.0, 0.8))))
    card, cpu = (session.Session(spec, device=d).run_sim().stats for d in (cuda_device, "cpu"))
    keys = ("frames_processed", "frames_missed_deadline", "frames_offloaded", "schedule_calls", "accuracy_sum")
    assert [getattr(card, k) for k in keys] == [getattr(cpu, k) for k in keys]


@pytest.mark.cuda
def test_jax_sched_frame_loops_never_wait_for_the_card(cuda_device, monkeypatch):
    """Between the one copy of a round's inputs to the card and the one copy
    of its choices back, nothing synchronizes with the host: CUDA's sync
    debug mode raises on any other synchronizing call."""
    def unchecked(fn):
        def call(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call

    monkeypatch.setattr(jax_sched, "_to_device", unchecked(jax_sched._to_device))
    monkeypatch.setattr(jax_sched, "_to_host", unchecked(jax_sched._to_host))
    models, kw, ukw = _dp_case(5)
    torch.cuda.set_sync_debug_mode("error")
    try:
        jax_sched.local_accuracy_dp_jax(models, **kw, device=cuda_device)
        jax_sched.local_utility_dp_jax(models, **kw, **ukw, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _sweep_scenarios(name: str, n_frames: int = 120):
    """100 points of chip_smoke's full-width grid (every 10th), shortened
    to ``n_frames``: both halves, constant and piecewise traces."""
    out = []
    for spec, grid in full_grids(name):
        base, scens = batch_scenarios(session, core, {**spec, "n_frames": n_frames}, grid, every=10)
        out += scens
    return list(base.models), out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SWEEP_PARAMS))
def test_sweep_engine_on_card_equals_cpu(cuda_device, name):
    models, scens = _sweep_scenarios(name)
    assert len(scens) == 100
    card = sim_batch.simulate_batch(name, models, scens, device=cuda_device)
    cpu = sim_batch.simulate_batch(name, models, scens, device="cpu")
    assert stats_rows(card) == stats_rows(cpu)


def _sync_checked(monkeypatch) -> list:
    """Issue every round of a lane program under CUDA's sync debug mode
    ("error"), with an empty program cache so every group captures; returns
    the list the issued rounds are counted in."""
    issued = []
    issue = sweep_shard.LaneProgram._issue

    def checked(prog, state):
        torch.cuda.set_sync_debug_mode("error")
        try:
            issued.append(prog.key)
            return issue(prog, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(sweep_shard.LaneProgram, "_issue", checked)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", sweep_shard.LaneCache())
    return issued


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SWEEP_PARAMS))
def test_sweep_rounds_never_wait_for_the_card(cuda_device, name, monkeypatch):
    """Inside a round nothing synchronizes with the host: CUDA's sync debug
    mode raises on any synchronizing call made while a round is issued (its
    warm-up and its capture as a CUDA graph, which a sync would also
    break).  The read after each round and the group's set-up copies stay
    outside."""
    issued = _sync_checked(monkeypatch)
    models, scens = _sweep_scenarios(name, n_frames=24)
    groups = []
    sim_batch.simulate_batch(name, models, scens[:20], device=cuda_device, groups=groups)
    assert len(issued) == 2 * len(groups)  # each group's warm-up and capture
    assert all(g["host_reads"] == g["rounds"] + 1 for g in groups if not g["reruns"])


def _online_scenarios(name: str, n_frames: int = 120):
    """100 points of chip_smoke's adaptivity grid (every 10th), over
    ``n_frames`` of the mobility square wave."""
    trace = scenariogen.make_trace("mobility_square").to_json()
    base = session.ScenarioSpec.from_json(online_spec(name, n_frames, trace))
    specs = [session._apply_point(base, p) for p in session.SweepGrid.from_json(ADAPT_GRID).points()[::10]]
    return list(base.models), [sim_online_batch.OnlineScenario(
        stream=s.stream, n_frames=s.n_frames, params=s.policy.params, rtt=s.trace.rtt_s,
        bw_segments=s.trace.segments()) for s in specs]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONLINE_PARAMS))
def test_online_engine_on_card_equals_cpu(cuda_device, name):
    models, scens = _online_scenarios(name)
    assert len(scens) == 100
    card = sim_online_batch.simulate_online_batch(name, models, scens, device=cuda_device)
    cpu = sim_online_batch.simulate_online_batch(name, models, scens, device="cpu")
    assert stats_rows(st for st, _ in card) == stats_rows(st for st, _ in cpu)
    assert [m for _, m in card] == [m for _, m in cpu]  # rounds and estimated_bps, bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONLINE_PARAMS))
def test_online_rounds_never_wait_for_the_card(cuda_device, name, monkeypatch):
    issued = _sync_checked(monkeypatch)
    models, scens = _online_scenarios(name, n_frames=30)
    groups = []
    sim_online_batch.simulate_online_batch(name, models, scens[:20], device=cuda_device, groups=groups)
    assert len(issued) == 2 * len(groups)
    assert all(g["host_reads"] == g["rounds"] + 1 for g in groups if not g["reruns"])


def _ab(name: str):
    """Two lists of scenarios with the same shape keys and other values."""
    models, scens = _sweep_scenarios(name, n_frames=24)
    return models, scens[:10], scens[10:20]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jax_utility", "max_accuracy", "track_accuracy"])
def test_cache_hit_replays_with_no_capture(cuda_device, name, monkeypatch):
    """The same group again replays its cached graph: 0 captures, one hit
    per group, the same results."""
    monkeypatch.setattr(sweep_shard, "PROGRAMS", sweep_shard.LaneCache())
    models, scens, _ = _ab(name)
    with compile_cache.CompileCounter() as first:
        once = sim_batch.simulate_batch(name, models, scens, device=cuda_device)
    with compile_cache.CompileCounter() as again:
        twice = sim_batch.simulate_batch(name, models, scens, device=cuda_device)
    assert first.captures == first.misses >= 1 and first.hits == 0
    assert (again.captures, again.misses, again.hits) == (0, 0, first.misses)
    assert stats_rows(once) == stats_rows(twice)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SWEEP_PARAMS))
def test_graph_a_then_b_equals_b_alone(cuda_device, name, monkeypatch):
    """Scenarios B run on the graphs scenarios A captured (where their shape
    keys meet) equal B run with an empty cache."""
    models, scens_a, scens_b = _ab(name)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", sweep_shard.LaneCache())
    sim_batch.simulate_batch(name, models, scens_a, device=cuda_device)
    groups = []
    after_a = sim_batch.simulate_batch(name, models, scens_b, device=cuda_device, groups=groups)
    assert any(g["cached"] for g in groups)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", sweep_shard.LaneCache())
    alone = sim_batch.simulate_batch(name, models, scens_b, device=cuda_device)
    assert stats_rows(after_a) == stats_rows(alone)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ONLINE_PARAMS))
def test_online_graph_a_then_b_equals_b_alone(cuda_device, name, monkeypatch):
    models, scens = _online_scenarios(name, n_frames=60)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", sweep_shard.LaneCache())
    sim_online_batch.simulate_online_batch(name, models, scens[:8], device=cuda_device)
    groups = []
    after_a = sim_online_batch.simulate_online_batch(name, models, scens[8:16], device=cuda_device, groups=groups)
    assert any(g["cached"] for g in groups)
    monkeypatch.setattr(sweep_shard, "PROGRAMS", sweep_shard.LaneCache())
    alone = sim_online_batch.simulate_online_batch(name, models, scens[8:16], device=cuda_device)
    assert stats_rows(st for st, _ in after_a) == stats_rows(st for st, _ in alone)
    assert [m for _, m in after_a] == [m for _, m in alone]


def _fleet_scenarios(name: str, n_frames: int = 30):
    """54 points of chip_smoke's 216-point fleet grid (every 4th), over
    ``n_frames``."""
    base = session.ScenarioSpec.from_json(fleet_spec(name, n_frames, **FLEET_BASE))
    return list(base.models), fleet_scenarios(core, session, base, session.SweepGrid.from_json(FLEET_SMALL_GRID), 4)


def _fleet_rows(results) -> list:
    return [(stats_rows(ms.per_client), ms.server_jobs, ms.server_busy_s, meta) for ms, meta in results]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLEET_PARAMS))
def test_fleet_engine_on_card_equals_cpu(cuda_device, name):
    models, scens = _fleet_scenarios(name)
    assert len(scens) == 54
    card = sim_multi_batch.simulate_multi_batch(name, models, scens, device=cuda_device)
    cpu = sim_multi_batch.simulate_multi_batch(name, models, scens, device="cpu")
    assert _fleet_rows(card) == _fleet_rows(cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["offload", "max_accuracy", "track_accuracy"])
def test_fleet_rounds_never_wait_for_the_card(cuda_device, name, monkeypatch):
    """A fleet round, with its masked drain events, never synchronizes with
    the host; each group reads once a round plus once for its results, and
    its drain replays apart."""
    issued = _sync_checked(monkeypatch)
    models, scens = _fleet_scenarios(name, n_frames=12)
    groups = []
    sim_multi_batch.simulate_multi_batch(name, models, scens[:20], device=cuda_device, groups=groups)
    assert len(issued) == 2 * len(groups)
    assert all(g["host_reads"] == g["rounds"] + 1 and g["drain_replays"] >= 0 for g in groups)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-0.6b", "command-r-35b", "qwen2-moe-a2.7b", "deepseek-moe-16b"])
def test_lm_smoke_cells_on_card(cuda_device, name, monkeypatch):
    base = configs.get(name, smoke=True)
    arch = dataclasses.replace(base, shapes=(A.ShapeSpec("p", "prefill", 2, seq=40), A.ShapeSpec("d", "decode", 2, seq=64)))
    prefill, decode = steps.build_cell(arch, "p"), steps.build_cell(arch, "d")
    params = own_fan_in(prefill.init_arg(0, 0, cuda_device), arch.cfg)
    batch = A.make_inputs(arch, arch.shape("p"), 1, device=cuda_device)
    picks = []
    before = flash_ops.flash_attention.launches
    with expert_picks(L, picks):
        logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches - before == arch.cfg.n_layers
    assert int(cache["len"]) == 40 and cache["k"].device.type == "cuda"
    with monkeypatch.context() as m, expert_picks(L, picks, replay=True):
        m.setattr(flash_ops, "attention", lambda q, k, v, *, causal=True, **_: upcast_attention(
            torch, flash_ref, q, k, v, causal=causal))
        plain, _ = prefill(params, batch)
    c = compare_logits(logits, plain)
    assert c["rel"] <= LM_LOGIT_RTOL and c["top1_ok"], c
    tokens = batch["tokens"][:, :12]
    cache = decode.init_arg(1, 0, cuda_device)
    picks = []
    with expert_picks(L, picks):
        for s in range(12):
            step_logits, cache = decode(params, cache, {"token": tokens[:, s:s + 1]})
    cfg = arch.cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    by_layer = [torch.cat(picks[layer::cfg.n_layers], dim=1) for layer in range(cfg.n_layers)] if cfg.moe else []
    with expert_picks(L, by_layer, replay=True):
        prefilled, _ = lm.prefill(cfg, params, tokens)
    c = compare_logits(step_logits, prefilled)
    assert c["rel"] <= LM_LOGIT_RTOL and c["top1_ok"], c


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dit-xl2", "flux-dev"])
def test_diffusion_smoke_cells_on_card(cuda_device, name, monkeypatch):
    base = configs.get(name, smoke=True)
    arch = dataclasses.replace(base, shapes=(A.ShapeSpec("g", "denoise_step", 3, img=128, steps=4),))
    cell = steps.build_cell(arch, "g")
    params = own_fan_in(cell.init_arg(0, 0, cuda_device), arch.cfg)
    draw_zero_leaves(common, params, cell.arg_specs[0], torch.Generator(device=cuda_device).manual_seed(1))
    batch = A.make_inputs(arch, arch.shape("g"), 1, device=cuda_device)
    before = flash_ops.flash_attention.launches
    pred = prediction(torch, diffusion, arch, params, batch)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches - before == attention_layers(arch.cfg)
    with monkeypatch.context() as m:
        m.setattr(flash_ops, "attention", lambda q, k, v, *, causal=True, **_: upcast_attention(
            torch, flash_ref, q, k, v, causal=causal))
        plain = prediction(torch, diffusion, arch, params, batch)
    scale = float(plain.abs().max())
    assert scale > 0 and float((pred - plain).abs().max()) <= LM_LOGIT_RTOL * scale
    out = cell(params, batch)
    assert out.shape == batch["x"].shape and bool(torch.isfinite(out).all())


TRAIN_BF16_LOSS_RTOL = 0.01  # bf16 on both: ResNet-50 at batch 2 read 3.5e-3 on an H100 (PERF.md §6)
TRAIN_SMOKE = {"qwen3-0.6b": A.ShapeSpec("t", "train", 2, seq=64), "dit-xl2": A.ShapeSpec("t", "denoise_train", 4, img=64),
               "flux-dev": A.ShapeSpec("t", "denoise_train", 2, img=64),
               "resnet-50": A.ShapeSpec("t", "classify_train", 4, img=64)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TRAIN_SMOKE))
def test_train_step_on_card_against_cpu(cuda_device, name):
    arch = dataclasses.replace(configs.get(name, smoke=True), shapes=(TRAIN_SMOKE[name],))
    cell = steps.build_cell(arch, "t")
    ts = cell.init_arg(0, 0, "cpu")
    if arch.family in ("dit", "flux"):
        draw_zero_leaves(common, ts["params"], cell.arg_specs[0]["params"], torch.Generator().manual_seed(1))
    batch = A.make_inputs(arch, arch.shape("t"), 1, device="cpu")
    on_card = lambda tree: common.tree_map(lambda t: t.to(cuda_device), tree)  # noqa: E731
    ts_card, batch_card = on_card(ts), on_card(batch)
    launches = (ops.int8_matmul.launches, flash_ops.flash_attention.launches)
    agree = train_agreement(torch, common, steps, diffusion, L, (lm, diffusion, convnets, vision), arch,
                            ts_card["params"], ts_card["state"], batch_card)
    assert agree["loss_rel"] <= TRAIN_LOSS_RTOL and agree["grad_rel"] <= grad_limit(arch), agree
    assert agree["wrong_grad_rel"] > grad_limit(arch), agree
    _, m_cpu = cell(ts, batch)
    _, m_card = cell(ts_card, batch_card)
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= TRAIN_BF16_LOSS_RTOL * abs(float(m_cpu["loss"]))
    assert int(ts_card["opt"]["step"]) == int(ts["opt"]["step"]) == 1
    assert (ops.int8_matmul.launches, flash_ops.flash_attention.launches) == launches
