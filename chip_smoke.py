#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. environment  card name and power limit, versions, TF32 off, and the
                  build of every CUDA kernel from the sources in this checkout
                  (one nvcc per source, all started together)
  2. kernels      int8_matmul against its plain version on the card at
                  GEMM_SHAPES (tests/test_kernels.py's, then split-K,
                  narrow-load and large-M shapes) and at every GEMM shape one
                  forward of full-width ResNet-50 and SqueezeNet issues at
                  224², batch 1 and 8: bitwise equality, kernel / plain /
                  library (torch._int_mm + epilogue) / bound times, and the
                  launch each call made (row tile, K splits, blocks, load
                  path of each operand); then MISALIGNED operands, which must
                  take the narrow paths, bitwise; then the design over one
                  frame's GEMMs
  3. flash        flash_attention against its plain version on the card at
                  FLASH_SHAPES (tests/test_kernels.py's, ragged 17·n+3 sizes,
                  every bf16 head dim at batch 1 and 8, causal S > T, the
                  smoke ViT's and ViT-S/16's shapes, head dims 8 and 72 that
                  run zero-padded to the kernel's 16 and 128): the reference's
                  tolerances, kernel / plain / library (SDPA) / bound times,
                  blocks and kernel (mma = tensor cores, fma = CUDA cores);
                  then a misaligned bf16 call, which must take the CUDA-core
                  kernel; then the design at ViT-S/16's batch-1 shape
  4. serve_full   full-width ResNet-50 and SqueezeNet (random weights from a
                  seed) behind VideoServer + OnlineController(max_accuracy) +
                  EdgeBatchServer over 60 frames at 224²
  5. vit_full     full-width ViT-S/16 and SqueezeNet the same way: 12 flash
                  launches per ViT forward, logits against the same forward
                  with the plain attention
  6. serving      Session(spec, device="cuda").run_serving() on the default
                  spec of ``python -m repro_torch.launch.serve --frames 64``,
                  then on the same spec with models ({"name": "vit-s16"},
                  "squeezenet")
  7. main shapes  each kernel against its plain version, untimed, at every
                  shape phases 4-6 gave it that phases 2-3 did not check
                  (the serving buckets, the front door's smoke models)
  8. sim          the audited simulators on device="cuda": run_sim for every
                  registered policy at the reference's golden setting, the
                  four DP planners (jax_accuracy/jax_utility plan with tensor
                  ops on the card) over 900 frames, run_multi under each
                  allocation policy and with a track fleet, run_online twice
                  — every result equal to SIM_GOLDENS, the reference's
                  numbers; then every classify policy on the profiles
                  serve_full measured on the card; planning time per round
  9. sweep        Session.run_sweep through the lane-batched engine
                  (core/sim_batch) on device="cuda" for the six batched
                  policies: 20-point golden grids (the max_* policies also
                  under a piecewise trace, the track policies on their own
                  grid) against SWEEP_GOLDENS, the reference's numbers; then
                  1000 points x 900 frames a policy, twice, every 20th point
                  re-run on the host CPU bit for bit; max_utility over
                  10,000 points chunked against unchunked; the per-point
                  loop on the card at 10 and 100 points; ms per point,
                  groups, rounds, host reads per round and peak card memory
 10. online       Session.run_sweep(mode="online") through the lane-batched
                  online engine (core/sim_online_batch) on device="cuda" for
                  max_accuracy and max_utility: tests/test_online_batch.py's
                  square wave, fault injection, dead link and golden lattice
                  against ONLINE_GOLDENS, the reference's numbers; the
                  adaptivity bench's 1000-point grid over 60 frames, twice,
                  every point against the per-point run_online loop on the
                  card; the same grid over 900 frames with every 10th point
                  re-run on the host CPU bit for bit
 11. cache        the sweep phase's 10,000-point max_utility grid in chunks,
                  without the cache of captured lane programs
                  (core/sweep_shard), then with it twice, under
                  CompileCounter: captures, hits, wall seconds, the memory
                  the cached programs hold; results equal in every field
 12. report       {"kernels": [...]} line, then the contract's last line

Every main-path phase (serve_full, vit_full, serving) sets both kernels'
launch counts to 0 just before it runs and reads them just after; while
they run, every shape each kernel's wrapper is called at is recorded.

It needs one NVIDIA card and the CUDA toolkit (nvcc), and exits non-zero
without printing a result where ``torch.cuda.is_available()`` is False or
where the port's sources are missing.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"
RES = 224  # frame and model input size of the full-width phases
N_CLASSES = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12  # H100 SXM f32 peak outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/npu_matmul/csrc/int8_matmul.cu"
KERNEL_REPLACES = "src/repro/kernels/npu_matmul/kernel.py:74"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:118"
VIT = "vit-s16"
VIT_SHAPE = (197, 197, 6, 6, 64, False, "bfloat16")  # S, T, H, KH, hd, causal, dtype at 224², patch 16
SMOKE_VIT_SHAPE = (17, 17, 4, 4, 16, False, "bfloat16")  # the smoke ViT (32², patch 8) the front door calibrates
FLASH_SHAPES = [  # (B, S, T, H, KH, hd, causal, dtype); tests/test_torch_cuda.py checks the same list
    # tests/test_kernels.py:140-144 (f32) and :157-168 (bf16)
    (2, 128, 128, 8, 4, 64, True, "float32"), (1, 100, 200, 4, 4, 32, False, "float32"),
    (2, 257, 257, 8, 2, 64, True, "float32"), (1, 64, 512, 16, 8, 128, True, "float32"),
    (1, 33, 65, 2, 1, 16, False, "float32"), (2, 128, 128, 8, 4, 64, True, "bfloat16"),
    # ragged S = T = 17·n + 3 (tests/test_kernels.py:184-194)
    (1, 20, 20, 4, 2, 32, True, "float32"), (2, 54, 54, 4, 2, 32, False, "float32"),
    (3, 88, 88, 4, 2, 32, True, "float32"), (4, 37, 37, 4, 2, 32, False, "float32"),
    # causal with S > T: the first S - T query rows see no key
    (1, 40, 20, 4, 2, 32, True, "float32"),
    # the smoke ViT at the batches the front door times (1, 2), serves (8) and scores (64)
    (1, *SMOKE_VIT_SHAPE), (2, *SMOKE_VIT_SHAPE), (8, *SMOKE_VIT_SHAPE), (64, *SMOKE_VIT_SHAPE),
    # ViT-S/16 at 224², batch 1 and 8 (the main path's shape)
    (1, *VIT_SHAPE), (8, *VIT_SHAPE),
    # the tensor-core kernel at every other bf16 head dim, batch 1 and 8 (GQA, ragged, causal)
    (1, 100, 200, 4, 4, 32, False, "bfloat16"), (8, 88, 88, 4, 2, 32, True, "bfloat16"),
    (1, 64, 512, 16, 8, 128, True, "bfloat16"), (8, 257, 257, 8, 2, 128, False, "bfloat16"),
    # bf16 causal with S > T: rows with no key, split over the block's warps
    (1, 40, 20, 4, 2, 32, True, "bfloat16"), (2, 70, 33, 8, 2, 64, True, "bfloat16"),
    (1, 50, 17, 2, 1, 16, True, "bfloat16"),
    # head dims outside the kernel's set, run zero-padded to 16 and 128: the
    # command-r smoke config (8 heads over 2 KV heads, hd 8, causal) and
    # DiT-XL/2 at 256² (256 latent tokens, 16 heads of 1152 / 16 = 72)
    (2, 32, 32, 8, 2, 8, True, "bfloat16"), (1, 256, 256, 16, 16, 72, False, "bfloat16"),
]
FLASH_TOL = {"float32": (1e-4, 2e-5), "bfloat16": (0.05, 0.02)}  # (rtol, atol): tests/test_kernels.py's
VIT_LOGIT_RTOL = 0.02  # max|kernel - plain attention| over max|logit| of the full-width ViT forward
GEMMS_PER_FORWARD = {"resnet-50": 54, "squeezenet": 26}  # 53 convs + head; 25 convs + classifier conv
TEST_SHAPES = [  # (M, K, N): tests/test_kernels.py:27, :56-58, :78
    (128, 512, 128), (256, 1024, 384), (64, 300, 100), (8, 128, 128), (1, 64, 1),
    (130, 70, 9), (130, 700, 129), (3, 33, 65), (257, 513, 127), (1, 96, 10),
]
PATH_SHAPES = [  # (M, K, N) that take each of the kernel's launch designs
    # split-K: ResNet-50's stage-4 and stage-3 3x3 convs and its head, batch 1
    (49, 4608, 512), (196, 2304, 256), (1, 2048, 1000),
    # narrow loads: K = 27 (SqueezeNet conv1), K = 147 (ResNet-50 conv1), N = 1000 (the
    # head, above), N = 10 (the smoke models' head); large M (ResNet-50 conv1, batch 1 and 8)
    (12544, 27, 64), (12544, 147, 64), (8, 64, 10), (100352, 147, 64),
]
GEMM_SHAPES = TEST_SHAPES + PATH_SHAPES  # tests/test_torch_cuda.py checks the same list
MISALIGNED = [  # (M, K, N, byte offset of x_q and w_q): vector shapes forced onto the narrow paths
    (128, 512, 128, 1), (49, 4608, 512, 1), (128, 512, 128, 4), (1, 2048, 1000, 2),
]
PATH_LETTER = {16: "v", 4: "w", 1: "b"}  # int8_matmul's load width per operand: cp.async, narrow words, bytes

# The sim phase: the audited simulators, every registered policy, the fleet
# and online engines, each held against the reference's numbers (SIM_GOLDENS;
# tests/test_torch_sim.py holds the table against the reference package).
GOLD_FRAMES = 24  # tests/test_session.py:218, the reference's golden length
POLICY_PARAMS = {  # tests/test_session.py:37-50: every registered policy, with a sweep's params
    "max_accuracy": {},
    "max_utility": {"alpha": 200.0},
    "local": {},
    "offload": {},
    "deepdecision": {},
    "brute_force": {},
    "jax_accuracy": {},
    "jax_utility": {"alpha": 200.0},
    "track_accuracy": {},
    "track_fixed": {"k": 3},
}
TRACK_POLICIES = ("track_accuracy", "track_fixed")  # planned with WorkloadSpec("track")
PIECEWISE = [[0.0, 3.5], [1.0, 0.8]]  # (t_start s, Mbps): tests/test_session.py:277-293's trace
DP_FRAMES = 900  # the paper's stream length: 30 s at 30 fps
DP_POLICIES = ("max_accuracy", "max_utility", "jax_accuracy", "jax_utility")
ALLOCATIONS = ("weighted_fair", "priority", "fifo")
CARD_FRAMES = 300  # the card-profiled runs (brute_force at GOLD_FRAMES)

# The sweep phase: Session.run_sweep through the lane-batched engine
# (core/sim_batch) for every batched policy, held against the reference's
# numbers (SWEEP_GOLDENS; tests/test_torch_sweep_goldens.py holds the table
# against the reference package), then at full width against itself on the
# CPU.  Base params and the parameter axis of each policy's full-width grid:
SWEEP_PARAMS = {
    "jax_accuracy": ({}, {"grid": [1e-3, 2e-3]}),
    "jax_utility": ({"alpha": 200.0}, {"alpha": [50.0, 200.0]}),
    "max_accuracy": ({}, {"grid": [1e-3, 2e-3]}),
    "max_utility": ({"alpha": 200.0}, {"alpha": [50.0, 200.0]}),
    "track_accuracy": ({"k_max": 5}, {"k_max": [4, 8]}),
    "track_fixed": ({"k": 3}, {"k": [2, 4]}),
}
NET_POLICIES = ("max_accuracy", "max_utility")  # integer stats exact, accuracy within AUDIT_TOL
SWEEP_PIECEWISE = [[0.0, 3.0], [0.3, 0.8], [0.9, 6.0]]  # tests/test_sim_batch.py:59-61, rtt 60 ms
# tests/test_tracking.py:205-228: the track policies' run_sweep grid and base spec
TRACK_GRID = {"bandwidth_mbps": [0.5, 3.0, 9.0], "deadline_ms": [100.0, 200.0]}
TRACK_BASE = {"trace": {"kind": "constant", "mbps": 2.5, "rtt_ms": 80.0},
              "workload": {"kind": "track", "decay": 0.2, "density": 1.5}}
# Full width: 1000 points a policy, over 900 frames (30 s at 30 fps, the
# paper's stream) on Table II's profiles: bandwidth 0.5-6 Mbps (constant
# traces) or rtt 20-200 ms (under SWEEP_TRACE) x deadline x fps x the param
# axis, 500 points each.
SWEEP_FRAMES = 900
SWEEP_BW = [0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0]
SWEEP_RTT = [20.0, 40.0, 60.0, 80.0, 100.0, 120.0, 140.0, 160.0, 180.0, 200.0]
SWEEP_DL = [100.0, 150.0, 200.0, 250.0, 350.0]
SWEEP_FPS = [10.0, 15.0, 24.0, 30.0, 60.0]
SWEEP_TRACE = {"kind": "piecewise", "rtt_ms": 60.0,  # steps through the 30 s stream
               "points": [[0.0, 3.0], [5.0, 0.8], [10.0, 6.0], [15.0, 1.5], [20.0, 4.0], [25.0, 0.5]]}
CPU_CHECK_EVERY = 20  # the host CPU re-runs every 20th full-width point: 50 a policy
CHUNK_POINTS, CHUNK_SIZE = 10_000, 2500  # max_utility at 24 frames, chunked against unchunked
PROFILE_FRAMES = 300  # the profiled group's stream (eager rounds take ~20 ms each)
REFERENCE_GRIDS = {  # the per-point loop (backend="reference") on the card: 10 and 100 points
    10: {"bandwidth_mbps": [1.0, 3.0], "deadline_ms": SWEEP_DL, "fps": [30.0]},
    100: {"bandwidth_mbps": SWEEP_BW, "deadline_ms": SWEEP_DL, "fps": [24.0, 30.0]},
}

# The online phase: Session.run_sweep(mode="online") through the lane-batched
# online engine (core/sim_online_batch), held against the reference's numbers
# (ONLINE_GOLDENS; tests/test_torch_online_goldens.py holds the table against
# the reference package), then at full width against the per-point run_online
# loop on the card and against itself on the host CPU.  Base params and the
# param axis of the golden lattice (tests/test_online_batch.py:36-39):
ONLINE_PARAMS = {
    "max_accuracy": ({"grid": 0.01}, {"grid": [0.01, 0.02]}),
    "max_utility": ({"alpha": 200.0}, {"alpha": [50.0, 200.0]}),
}
# tests/test_online_batch.py:53-55: 3.5 Mbps for the first second, 0.8 after
ONLINE_SQUARE = {"kind": "piecewise", "points": [[0.0, 3.5], [1.0, 0.8]], "rtt_ms": 100.0}
# benchmarks/adaptivity_bench.py:61-84: the mobility square wave (3.5 <-> 0.8
# Mbps, 2 s period), 60 frames at 30 fps, deadline (one window shape) x 200
# RTTs over 50-110 ms: 1000 points a policy; then the same grid over 900
# frames (30 s of the wave), every ONLINE_CPU_EVERY-th point re-run on the
# host CPU.
ADAPT_FRAMES, ADAPT_LONG_FRAMES = 60, 900
ADAPT_GRID = {"deadline_ms": [200.0, 208.0, 216.0, 224.0, 232.0],
              "rtt_ms": [50.0 + 60.0 * i / 200 for i in range(200)]}
ONLINE_CPU_EVERY = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def own_fan_in(params, cfg):
    """Give a ViT's stacked attention matrices their own fan-in, in place, and
    return ``params``.  The reference's init rule reads the fan-in of
    ``wq [L, d, H, hd]`` as H (``shape[-2]``), so its random q and k come out
    ~sqrt(d / H) = 8x too large, the logits spread ~64 and the softmax is
    near one-hot: one bf16 ulp in a rounded logit then flips which token a
    head attends to, and a few blocks of that make two correct bf16
    forwards that sum in different orders disagree by more than the logits'
    scale.  Scaling wq/wk/wv by sqrt(H / d) and wo by 1 / sqrt(H) gives each
    its true fan-in (d, and H·hd).  Works on torch and numpy leaves alike."""
    attn = params["blocks"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name] = attn[name] * math.sqrt(cfg.n_heads / cfg.d_model)
    attn["wo"] = attn["wo"] / math.sqrt(cfg.n_heads)
    return params


@contextlib.contextmanager
def recording(module, name: str, key, seen: set):
    """While active, ``module.name`` is a recorder that adds ``key(*args,
    **kwargs)`` of every call to ``seen`` and then calls the wrapper.  The
    wrapper counts its launches on whatever ``module.name`` is, so the count
    moves to the recorder and back with it."""
    real = getattr(module, name)

    def recorder(*args, **kwargs):
        seen.add(key(*args, **kwargs))
        return real(*args, **kwargs)

    recorder.launches = real.launches
    setattr(module, name, recorder)
    try:
        yield
    finally:
        real.launches = recorder.launches
        setattr(module, name, real)


def gemm_key(x_q, w_q, *_args) -> tuple[int, int, int]:
    return x_q.shape[0], x_q.shape[1], w_q.shape[1]


def flash_key(q, k, v, *, causal) -> tuple:
    B, S, H, hd = q.shape
    return B, S, k.shape[1], H, k.shape[2], hd, causal, str(q.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# 1. environment
# ---------------------------------------------------------------------------


def phase_environment(torch, build, sources) -> str:
    """Returns the card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0])  # the card's name and power limit, as nvidia-smi prints them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = build.build_libraries(sources)
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"nvcc[{name}]: {line}")
    log(f"kernel build: {build_s:.2f} s ({len(logs)} source(s) compiled in parallel)")
    return smi[0]


# ---------------------------------------------------------------------------
# 2. kernels vs plain
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of ``fn`` between CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, *, iters: int = 20) -> float:
    """Device time per call of ``fn`` with the host taken out: ``iters``
    calls captured in one CUDA graph, replayed between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound(M: int, K: int, N: int) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms): int8 operands and f32 scales
    read once, the f32 output written once; 2·M·N·K int8 operations."""
    nbytes = M * K + K * N + 4 * (M + N) + 4 * M * N
    return nbytes / HBM_BYTES_PER_S * 1e3, 2.0 * M * N * K / INT8_OPS_PER_S * 1e3


def record_gemms(torch, A, configs, common, name: str, batch: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of every NPU-path GEMM one forward of full-width ``name``
    issues at 224², in call order (a recording backend, plain bf16 matmul)."""
    arch = configs.get(name)
    specs, state_specs = A.abstract_params(arch)
    params = common.init_tree(torch.Generator().manual_seed(SEED), specs, device=DEVICE)
    state = common.init_tree(torch.Generator().manual_seed(SEED + 1), state_specs, device=DEVICE)
    shapes = []

    def rec(x, w):
        shapes.append((x.shape[0], x.shape[1], w.shape[1]))
        return x @ w

    with common.matmul_backend(rec), torch.no_grad():
        A.classifier_forward(arch, params, state, torch.zeros(batch, RES, RES, 3, device=DEVICE), train=False)
    return shapes


def at_offset(torch, t, offset: int):
    """A contiguous copy of ``t`` whose data starts ``offset`` elements into
    its storage, so its pointer is not 16-byte aligned for offset 1 of int8."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def gemm_design(ops, M: int, K: int, N: int, xq, wq) -> dict:
    """The launch the wrapper makes: row tile, K splits, blocks, and each
    operand's loads (v = 16-byte cp.async; narrow: w = 4-byte words, b = bytes)."""
    bm, splits = ops.plan(M, N, K)
    widths = ops.load_widths(K, N, xq.data_ptr(), wq.data_ptr())
    return {"tile": bm, "splits": splits, "blocks": ops.cdiv(M, bm) * ops.cdiv(N, ops.BN) * splits,
            "path": "".join(PATH_LETTER[w] for w in widths)}


def compare_shape(torch, ops, ref, M: int, K: int, N: int, *, timed: bool = True, offset: int = 0) -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(M * 7919 + K * 31 + N)
    x = torch.randn(M, K, device=DEVICE, generator=g)
    w = torch.randn(K, N, device=DEVICE, generator=g)
    xq, xs = ref.quantize_rowwise(x)
    wq, ws = ref.quantize_colwise(w)
    if offset:
        xq, wq = at_offset(torch, xq, offset), at_offset(torch, wq, offset)
    design = gemm_design(ops, M, K, N, xq, wq)
    out = ops.int8_matmul(xq, wq, xs, ws)
    plain = ref.int8_matmul_ref(xq, wq, xs, ws)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    equal = bool(torch.equal(out, plain))
    if not timed:
        return {"equal": equal, "max_abs_err": err, **design}
    kernel = lambda: ops.int8_matmul(xq, wq, xs, ws)  # noqa: E731
    plain_fn = lambda: ref.int8_matmul_ref(xq, wq, xs, ws)  # noqa: E731
    # Library yardstick: cuBLAS int8 GEMM + the same epilogue.  cuBLASLt's
    # int8 GEMM wants the weight K-contiguous ([N, K] storage, the "TN"
    # layout; the row-major [K, N] one is refused at shapes such as K=32 on
    # an H100), M > 16 and K, N multiples of 8, so the weight is stored
    # transposed and every dim zero-padded to a multiple of 16, M to at least
    # 32, outside the timed region; zeros add nothing to the integer sums.
    Mp, Kp, Np = max(-(-M // 16) * 16, 32), -(-K // 16) * 16, -(-N // 16) * 16
    xqp = torch.zeros(Mp, Kp, dtype=torch.int8, device=DEVICE)
    wqt = torch.zeros(Np, Kp, dtype=torch.int8, device=DEVICE)
    xqp[:M, :K], wqt[:N, :K] = xq, wq.t()
    scale = xs[:, None] * ws[None, :]

    def library():
        return torch._int_mm(xqp, wqt.t())[:M, :N].to(torch.float32) * scale

    check(torch.equal(library(), plain), f"torch._int_mm disagrees with the plain version at {(M, K, N)}")
    b_bytes, b_ops = bound(M, K, N)
    return {
        "M": M, "K": K, "N": N, "equal": equal, "max_abs_err": err,
        # device time per call (CUDA graph replay) ...
        "ms": graph_ms(torch, kernel), "plain_ms": graph_ms(torch, plain_fn),
        "library_ms": graph_ms(torch, library),
        # ... and per call as the main path issues them (host launch included)
        "call_ms": cuda_ms(torch, kernel), "plain_call_ms": cuda_ms(torch, plain_fn),
        "library_call_ms": cuda_ms(torch, library),
        "library_padded": (Mp, Kp, Np) != (M, K, N),
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        **design,
    }


def phase_kernels(torch, A, configs, common, ops, ref) -> tuple[dict, dict]:
    """Returns the per-frame sums over the batch-1 GEMMs and the rows by
    shape."""
    calls = {(name, b): record_gemms(torch, A, configs, common, name, b)
             for name in GEMMS_PER_FORWARD for b in (1, 8)}
    for (name, b), shapes in calls.items():
        check(len(shapes) == GEMMS_PER_FORWARD[name],
              f"{name} batch {b} issues {len(shapes)} GEMMs, expected {GEMMS_PER_FORWARD[name]}")
    distinct = list(dict.fromkeys(GEMM_SHAPES + [s for shapes in calls.values() for s in shapes]))
    rows = {}
    log("device ms per call (CUDA graph) / per eager call (host launch included)")
    log(f"{'M':>7} {'K':>5} {'N':>5} {'kernel':>8} {'plain':>8} {'library':>9} {'bound':>8} {'by':>5} "
        f"{'k_call':>7} {'p_call':>7} {'l_call':>7} {'tile':>4} {'split':>5} {'blocks':>6} path equal")
    for M, K, N in distinct:
        r = compare_shape(torch, ops, ref, M, K, N)
        rows[(M, K, N)] = r
        log(f"{M:>7} {K:>5} {N:>5} {r['ms']:>8.4f} {r['plain_ms']:>8.4f} {r['library_ms']:>8.4f}"
            f"{'*' if r['library_padded'] else ' '}{r['bound_ms']:>8.5f} {r['bound_by'][:5]:>5} "
            f"{r['call_ms']:>7.4f} {r['plain_call_ms']:>7.4f} {r['library_call_ms']:>7.4f} "
            f"{r['tile']:>4} {r['splits']:>5} {r['blocks']:>6} {r['path']:>4} {r['equal']}")
    bad = [k for k, r in rows.items() if not r["equal"]]
    check(not bad, f"kernel and plain version differ at {bad}")
    log(f"kernels: {len(rows)} shapes bitwise equal to the plain version (tolerance: exact)  "
        "(* = library operands zero-padded to multiples of 16, M >= 32; weight stored [N, K]; "
        "path = loads of x_q, w_q: v 16-byte cp.async; narrow: w 4-byte words, b bytes)")
    paths = {r["path"] for r in rows.values()}
    for i, operand in enumerate(("x_q", "w_q")):
        check({p[i] for p in paths} == set(PATH_LETTER.values()),
              f"the shapes exercised {operand} load paths {sorted({p[i] for p in paths})} only")
    for M, K, N, offset in MISALIGNED:
        r = compare_shape(torch, ops, ref, M, K, N, timed=False, offset=offset)
        want = "".join(PATH_LETTER[4 if offset % 4 == 0 else 1] for _ in "xw")
        log(f"kernels: {M}x{K}x{N} with x_q and w_q {offset} byte(s) off 16-byte alignment: path {r['path']}, "
            f"tile {r['tile']}, splits {r['splits']}, bitwise equal {r['equal']}")
        check(r["path"] == want and r["equal"], f"misaligned {(M, K, N, offset)}: {r}")
    # The per-frame NPU work of the main path: every GEMM of one batch-1
    # forward of each full-width model, summed call by call.
    timed = ("ms", "plain_ms", "library_ms", "call_ms", "plain_call_ms", "library_call_ms", "bound_ms")
    agg = dict.fromkeys(timed + ("bytes_ms", "ops_ms"), 0.0)
    for name in GEMMS_PER_FORWARD:
        per_model = dict.fromkeys(agg, 0.0)
        for M, K, N in calls[(name, 1)]:
            r = rows[(M, K, N)]
            b_bytes, b_ops = bound(M, K, N)
            for key, v in [(k, r[k]) for k in timed] + [("bytes_ms", b_bytes), ("ops_ms", b_ops)]:
                per_model[key] += v
                agg[key] += v
        log(f"per-frame GEMMs {name} (batch 1, {GEMMS_PER_FORWARD[name]} calls): "
            + "  ".join(f"{k}={v:.4f}" for k, v in per_model.items()))
    frame = [rows[s] for name in GEMMS_PER_FORWARD for s in calls[(name, 1)]]
    blocks = sorted(r["blocks"] for r in frame)
    log(f"int8_matmul design over one frame's {len(frame)} GEMMs: blocks per call min {blocks[0]} median "
        f"{blocks[len(blocks) // 2]} max {blocks[-1]}; split-K on {sum(r['splits'] > 1 for r in frame)} calls; "
        f"row tiles {dict(collections.Counter(r['tile'] for r in frame))}; "
        f"paths {dict(collections.Counter(r['path'] for r in frame))}")
    for M, K, N in PATH_SHAPES:
        r = rows[(M, K, N)]
        log(f"int8_matmul design at {M}x{K}x{N}: tile {r['tile']}x{ops.BN}, {r['splits']} splits of "
            f"{ops.k_per_split(K, r['splits'])} steps of {ops.BK} bytes, {r['blocks']} blocks, path {r['path']}")
    return agg, rows


# ---------------------------------------------------------------------------
# 3. flash attention vs plain
# ---------------------------------------------------------------------------


def flash_bound(B, S, T, H, KH, hd, causal, dtype) -> tuple[float, float]:
    """(bytes-bound ms, operations-bound ms): q, k, v read once and the
    output written once; 4·hd operations (two multiply-adds) per visible
    (query, key) pair of every head — causal counts only the pairs this mask
    leaves, ``t <= s + T - S``."""
    es = 4 if dtype == "float32" else 2
    nbytes = es * (2 * B * S * H * hd + 2 * B * T * KH * hd)
    pairs = sum(min(T, max(0, s + T - S + 1)) for s in range(S)) if causal else S * T
    peak = F32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    return nbytes / HBM_BYTES_PER_S * 1e3, 4.0 * B * H * hd * pairs / peak * 1e3


def compare_flash(torch, flash_ops, flash_ref, shape, *, timed: bool = True, offset: int = 0) -> dict:
    import torch.nn.functional as F

    B, S, T, H, KH, hd, causal, dt = shape
    g = torch.Generator(device=DEVICE).manual_seed(B * 7919 + S * 31 + T + hd)
    q, k, v = (torch.randn(B, n, h, hd, device=DEVICE, generator=g).to(getattr(torch, dt))
               for n, h in ((S, H), (T, KH), (T, KH)))
    if offset:
        q, k, v = (at_offset(torch, t, offset) for t in (q, k, v))
    design = {"path": flash_ops.kernel_path(q.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr()),
              "blocks": flash_ops.blocks(B, S, H, KH), "width": flash_ops.padded_head_dim(hd)}
    out = flash_ops.flash_attention(q, k, v, causal=causal)
    # the plain version on the f32-upcast inputs (the reference's bf16 test)
    plain = flash_ref.sdpa_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[dt]
    diff = (out.float() - plain).abs()
    ok = bool((diff <= atol + rtol * plain.abs()).all())
    if not timed:
        return {"ok": ok, "max_abs_err": float(diff.max()), **design}
    kernel = lambda: flash_ops.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain_fn = lambda: flash_ref.sdpa_ref(q, k, v, causal=causal)  # noqa: E731
    # Library yardstick: SDPA on [B, H, S, hd] views of the same tensors, the
    # KV heads repeated to H outside the timed region, the bottom-right causal
    # mask as a boolean mask where S != T.
    G = H // KH
    kl, vl = (t.repeat_interleave(G, dim=2) if G > 1 else t for t in (k, v))
    mask = torch.ones(S, T, dtype=torch.bool, device=DEVICE).tril(T - S) if causal and S != T else None

    def library():
        return F.scaled_dot_product_attention(q.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
                                              attn_mask=mask, is_causal=causal and S == T).transpose(1, 2)

    b_bytes, b_ops = flash_bound(*shape)
    return {
        "ok": ok, "max_abs_err": float(diff.max()),
        "library_err": float((library().float() - plain).abs().max()),
        "ms": graph_ms(torch, kernel), "plain_ms": graph_ms(torch, plain_fn), "library_ms": graph_ms(torch, library),
        "call_ms": cuda_ms(torch, kernel),
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        **design,
    }


def phase_flash(torch, flash_ops, flash_ref) -> dict:
    """Returns the rows by shape."""
    rows = {}
    log("flash_attention: device ms per call (CUDA graph); k_call = per eager call (host launch included)")
    log(f"{'B':>2} {'S':>4} {'T':>4} {'H':>3} {'KH':>3} {'hd':>4} {'causal':>6} {'dtype':>8} {'kernel':>8} "
        f"{'plain':>8} {'library':>8} {'bound':>9} {'by':>5} {'k_call':>7} {'max_err':>9} {'lib_err':>9} "
        f"{'blocks':>6} path width ok")
    for shape in FLASH_SHAPES:
        r = compare_flash(torch, flash_ops, flash_ref, shape)
        rows[shape] = r
        B, S, T, H, KH, hd, causal, dt = shape
        log(f"{B:>2} {S:>4} {T:>4} {H:>3} {KH:>3} {hd:>4} {str(causal):>6} {dt:>8} {r['ms']:>8.4f} "
            f"{r['plain_ms']:>8.4f} {r['library_ms']:>8.4f} {r['bound_ms']:>9.6f} {r['bound_by'][:5]:>5} "
            f"{r['call_ms']:>7.4f} {r['max_abs_err']:>9.2e} {r['library_err']:>9.2e} {r['blocks']:>6} "
            f"{r['path']:>4} {r['width']:>5} {r['ok']}")
    bad = [k for k, r in rows.items() if not r["ok"]]
    check(not bad, f"flash kernel outside tolerance of its plain version at {bad}")
    log(f"flash: {len(rows)} shapes within tolerance of the plain version on f32-upcast inputs "
        f"(f32 rtol/atol {FLASH_TOL['float32']}, bf16 {FLASH_TOL['bfloat16']}; path mma = tensor cores, "
        "fma = CUDA cores)")
    shape = (2, 128, 128, 8, 4, 64, True, "bfloat16")
    r = compare_flash(torch, flash_ops, flash_ref, shape, timed=False, offset=1)
    log(f"flash: {shape} with q, k, v one element off 16-byte alignment: path {r['path']}, "
        f"max|err| {r['max_abs_err']:.3g}, within tolerance {r['ok']}")
    check(r["path"] == "fma" and r["ok"], f"misaligned bf16 flash: {r}")
    vit1 = rows[(1, *VIT_SHAPE)]
    T, hd = VIT_SHAPE[1], VIT_SHAPE[4]
    kv = flash_ops.kv_tile(hd)
    n_tiles = -(-T // kv)
    log(f"flash_attention design at ViT-S/16 batch 1 {VIT_SHAPE}: {vit1['blocks']} blocks of "
        f"{flash_ops.WARPS} warps ({flash_ops.ROWS} query rows each), path {vit1['path']}; {n_tiles} KV tiles "
        f"of {kv} columns split over the warps, at most {-(-n_tiles // flash_ops.WARPS)} a warp; "
        f"batch 8: {rows[(8, *VIT_SHAPE)]['blocks']} blocks")
    return rows


# ---------------------------------------------------------------------------
# 4. serve_full: full-width models behind the controller
# ---------------------------------------------------------------------------


def choose_bandwidth(core, models, n_frames: int) -> float:
    """The first constant bandwidth, from the paper's 2.5 Mbps up, at which
    max_accuracy over ``models`` plans both NPU and edge frames."""
    for mbps in (2.5, 3.0, 4.0, 5.0):
        c = core.OnlineController(models=models, stream=core.StreamSpec(), policy="max_accuracy",
                                  estimator=core.BandwidthEstimator(init_bps=mbps * 1e6))
        c.estimator.observe_rtt(0.1)
        head, where = 0, {"npu": 0, "server": 0}
        while head < n_frames:
            plan = c.next_plan(head)
            for d in plan.decisions:
                if head + d.frame < n_frames and d.is_processed():
                    where[d.where.value] += 1
            head += max(plan.horizon, 1)
        log(f"planned mix of {[m.name for m in models]} at {mbps} Mbps: {where}")
        if where["npu"] and where["server"]:
            return mbps
    raise RuntimeError("no bandwidth in 2.5-5 Mbps mixes NPU and edge frames")


def serve_frames(torch, core, serving, ops, flash_ops, models, npu_fns, edge_fns, frames, labels, mbps):
    """60 frames through VideoServer + OnlineController(max_accuracy) +
    EdgeBatchServer at a constant ``mbps``, the j-th profile of ``models``
    served by ``npu_fns[j]`` / ``edge_fns[j]``.  Both kernels' launch counts
    are set to 0 just before the run; returns (server, summary, int8
    launches, flash launches)."""
    stream = core.StreamSpec()
    npu_eps = {j: serving.ModelEndpoint(f"{m.name}-npu", npu_fns[j], profile_latency_s=m.t_npu, device=DEVICE)
               for j, m in enumerate(models)}
    batched = {j: serving.BatchedEndpoint(f"{m.name}-edge", edge_fns[j], max_batch=16, device=DEVICE)
               for j, m in enumerate(models)}
    for ep in batched.values():
        ep.warmup(frames[0])
    controller = core.OnlineController(models=models, stream=stream, policy="max_accuracy",
                                       estimator=core.BandwidthEstimator(init_bps=mbps * 1e6), device=DEVICE)
    controller.estimator.observe_rtt(0.1)
    server = serving.VideoServer(controller=controller, npu_endpoints=npu_eps, stream=stream,
                                 trace=core.Trace.constant(mbps), edge_server=serving.EdgeBatchServer(batched),
                                 device=DEVICE)
    ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
    summary = server.run(frames, labels)
    torch.cuda.synchronize()
    return server, summary, ops.int8_matmul.launches, flash_ops.flash_attention.launches


def phase_serve_full(torch, A, configs, common, quant, ops, flash_ops, ref, core, serving) -> tuple[int, dict]:
    """Returns the int8 kernel launches of the 60-frame serving run and the
    batch-1 ms per frame of each (model, variant)."""
    n_frames = 60
    models = {}
    for name in GEMMS_PER_FORWARD:
        arch = configs.get(name)
        specs, state_specs = A.abstract_params(arch)
        params = common.init_tree(torch.Generator().manual_seed(SEED), specs, device=DEVICE)
        state = common.init_tree(torch.Generator().manual_seed(SEED + 1), state_specs, device=DEVICE)
        qparams, qstats = quant.npu_variant(params, specs)

        def forward(p, x, _arch=arch, _state=state):
            return A.classifier_forward(_arch, p, _state, x, train=False)[0]

        models[name] = (forward, params, qparams)
        log(f"serve_full: {name} {A.n_params(arch)} params, quantized leaves {qstats.leaves_quantized}, "
            f"mean rel err {qstats.mean_rel_err:.5f}")

    frames, labels = serving.make_synthetic_video(n_frames, res=RES, seed=SEED)
    probe = torch.as_tensor(frames[:8], device=DEVICE)
    for name, (forward, params, qparams) in models.items():
        ops.int8_matmul.launches = 0
        kern = quant.npu_forward(forward)(qparams, probe)
        torch.cuda.synchronize()
        launches = ops.int8_matmul.launches
        check(launches == GEMMS_PER_FORWARD[name],
              f"{name} NPU forward launched the kernel {launches} times, expected {GEMMS_PER_FORWARD[name]}")
        with common.matmul_backend(ref.npu_matmul_ref), torch.no_grad():
            plain = forward(qparams, probe)
        check(bool(torch.isfinite(kern).all()) and kern.shape == (8, N_CLASSES), f"{name} NPU logits malformed")
        check(torch.equal(kern, plain), f"{name} NPU logits through the kernel differ from the plain backend "
              f"(max abs {float((kern - plain).abs().max())})")
        log(f"serve_full: {name} NPU forward at {RES}x{RES} batch 8: {launches} launches, logits bit-equal to "
            f"the plain backend, |logit| max {float(kern.abs().max()):.4g}")

    # Per-frame latency of both variants at batch 1 and 8 (host clock, synced);
    # the batch-1 medians are the card's profile for the sim phase.
    t_ms = {}
    for name, (forward, params, qparams) in models.items():
        npu_fwd = quant.npu_forward(forward)
        for b in (1, 8):
            x = torch.as_tensor(frames[:b], device=DEVICE)
            for variant, call in (("npu", lambda: npu_fwd(qparams, x).cpu()),
                                  ("edge", lambda: forward(params, x).cpu())):
                with torch.no_grad():
                    for _ in range(2):
                        call()
                    ts = []
                    for _ in range(7):
                        t0 = time.perf_counter()
                        call()
                        ts.append(time.perf_counter() - t0)
                ms = sorted(ts)[len(ts) // 2] * 1e3
                if b == 1:
                    t_ms[(name, variant)] = ms
                log(f"serve_full: {name} {variant} batch {b}: {ms:.3f} ms per forward, {ms / b:.3f} ms per frame")

    mbps = choose_bandwidth(core, core.PAPER_MODELS, n_frames)
    names = [m.name for m in core.PAPER_MODELS]
    server, summary, launches, flash = serve_frames(
        torch, core, serving, ops, flash_ops, core.PAPER_MODELS,
        [lambda x, m=models[n]: quant.npu_forward(m[0])(m[2], x) for n in names],
        [lambda x, m=models[n]: m[0](m[1], x) for n in names], frames, labels, mbps)
    check(flash == 0, f"the convnets launched the flash kernel {flash} times")
    npu_by_model = {n: sum(r.where == "npu" and r.model == n for r in server.results) for n in names}
    expected = sum(GEMMS_PER_FORWARD[n] * k for n, k in npu_by_model.items())
    log(f"serve_full: {mbps} Mbps summary {json.dumps({k: v for k, v in summary.items() if k != 'policy_spec'})}")
    log(f"serve_full: NPU frames by model {npu_by_model}; kernel launches {launches} (expected {expected})")
    check(summary["frames"] == n_frames, f"answered {summary['frames']} of {n_frames} frames")
    check(summary["npu_frames"] > 0 and summary["edge_frames"] > 0, "both NPU and edge paths must be used")
    check(launches == expected, f"kernel launches {launches} != {expected}")
    return launches, t_ms


# ---------------------------------------------------------------------------
# 5. vit_full: full-width ViT-S/16 behind the controller
# ---------------------------------------------------------------------------


def vit_weights(torch, A, common, arch):
    """Random full-width ViT weights from the seed, the attention matrices at
    their own fan-in (``own_fan_in``)."""
    specs, _ = A.abstract_params(arch)
    params = common.init_tree(torch.Generator().manual_seed(SEED), specs, device=DEVICE)
    return specs, own_fan_in(params, arch.cfg)


def phase_vit_full(torch, A, configs, common, quant, ops, flash_ops, flash_ref, core, serving, median_s):
    """Returns (int8 launches, flash launches) of the 60-frame serving run."""
    n_frames = 60
    arch = configs.get(VIT)
    n_layers = arch.cfg.n_layers
    specs, params = vit_weights(torch, A, common, arch)
    qparams, qstats = quant.npu_variant(params, specs)

    def vit_forward(p, x):
        return A.classifier_forward(arch, p, {}, x, train=False)[0]

    log(f"vit_full: {VIT} {A.n_params(arch)} params (seed {SEED}, attention matrices at their own fan-in), "
        f"quantized leaves {qstats.leaves_quantized}, mean rel err {qstats.mean_rel_err:.5f}")

    frames, labels = serving.make_synthetic_video(n_frames, res=RES, seed=SEED)
    vit_npu = quant.npu_forward(vit_forward)

    def plain_attention(q, k, v, *, causal=True, **_):
        return flash_ref.sdpa_ref(q, k, v, causal=causal)

    for b in (1, 8):
        x = torch.as_tensor(frames[:b], device=DEVICE)
        for variant, fwd, p in (("edge", vit_forward, params), ("npu", vit_npu, qparams)):
            flash_ops.flash_attention.launches = 0
            with torch.no_grad():
                kern = fwd(p, x)
            torch.cuda.synchronize()
            launches = flash_ops.flash_attention.launches
            check(launches == n_layers,
                  f"{VIT} {variant} forward at batch {b} launched the flash kernel {launches} times, want {n_layers}")
            with mock.patch.object(flash_ops, "attention", plain_attention), torch.no_grad():
                plain = fwd(p, x)
            check(bool(torch.isfinite(kern).all()) and kern.shape == (b, N_CLASSES), f"{VIT} logits malformed")
            err, scale = float((kern - plain).abs().max()), float(plain.abs().max())
            top = torch.topk(plain, 2, dim=-1).values
            margin = float((top[:, 0] - top[:, 1]).min())
            k_top = kern.argmax(-1)
            same = k_top == plain.argmax(-1)
            # A frame whose plain logits tie (within the measured difference)
            # may break the tie the other way; every other frame keeps its top-1.
            tie = plain.gather(-1, k_top[:, None])[:, 0] >= top[:, 0] - 2 * err
            log(f"vit_full: {variant} batch {b}: {launches} flash launches; logits vs plain attention: max|d| "
                f"{err:.4g} = {err / scale:.4%} of max|logit| {scale:.4g} (tolerance {VIT_LOGIT_RTOL:.0%}), "
                f"top-1 equal on {int(same.sum())}/{b} frames, ties broken otherwise {int((~same & tie).sum())} "
                f"(smallest top-2 margin {margin:.4g})")
            check(err <= VIT_LOGIT_RTOL * scale and bool((same | tie).all()),
                  f"{VIT} {variant} batch {b}: kernel forward differs from the plain-attention forward")

    # Per-frame times of both variants at batch 1 and 8 (host clock, synced),
    # the batch-1 medians being the profile's t_npu / t_server.
    t_ms = {}
    for b in (1, 8):
        x = torch.as_tensor(frames[:b], device=DEVICE)
        for variant, call in (("npu", lambda: vit_npu(qparams, x).cpu()),
                              ("edge", lambda: vit_forward(params, x).cpu())):
            with torch.no_grad():
                ms = median_s(call, warmup=2, repeats=7) * 1e3
            t_ms[(variant, b)] = ms
            log(f"vit_full: {VIT} {variant} batch {b}: {ms:.3f} ms per forward, {ms / b:.3f} ms per frame")
    vit_profile = core.profile_ms(VIT, t_npu_ms=t_ms[("npu", 1)], t_server_ms=t_ms[("edge", 1)],
                                  acc_server=core.RESNET50.acc_server, acc_npu=core.RESNET50.acc_npu)
    log(f"vit_full: {VIT} profile t_npu {t_ms[('npu', 1)]:.3f} ms, t_server {t_ms[('edge', 1)]:.3f} ms (measured "
        "above); accuracy tables are core.profiles.RESNET50's, since random weights have no accuracy of their own")

    sq = configs.get("squeezenet")
    sq_specs, sq_state_specs = A.abstract_params(sq)
    sq_params = common.init_tree(torch.Generator().manual_seed(SEED), sq_specs, device=DEVICE)
    sq_state = common.init_tree(torch.Generator().manual_seed(SEED + 1), sq_state_specs, device=DEVICE)
    sq_qparams, _ = quant.npu_variant(sq_params, sq_specs)

    def sq_forward(p, x):
        return A.classifier_forward(sq, p, sq_state, x, train=False)[0]

    sq_npu = quant.npu_forward(sq_forward)
    models = (vit_profile, core.SQUEEZENET)
    mbps = choose_bandwidth(core, models, n_frames)
    server, summary, int8, flash = serve_frames(
        torch, core, serving, ops, flash_ops, models,
        [lambda x: vit_npu(qparams, x), lambda x: sq_npu(sq_qparams, x)],
        [lambda x: vit_forward(params, x), lambda x: sq_forward(sq_params, x)],
        frames, labels, mbps)
    # forwards the run issued: one per NPU endpoint call, one per edge flush
    calls = {"vit": server.npu[0].stats.calls + server.edge_server.endpoints[0].stats.flushes,
             "squeezenet-npu": server.npu[1].stats.calls}
    log(f"vit_full: {mbps} Mbps summary {json.dumps({k: v for k, v in summary.items() if k != 'policy_spec'})}")
    log(f"vit_full: forwards {calls}; flash launches {flash} (expected {n_layers * calls['vit']}), "
        f"int8 launches {int8} (expected {GEMMS_PER_FORWARD['squeezenet'] * calls['squeezenet-npu']})")
    check(summary["frames"] == n_frames, f"answered {summary['frames']} of {n_frames} frames")
    check(flash == n_layers * calls["vit"] and flash > 0, f"flash launches {flash} != {n_layers} x {calls['vit']}")
    check(int8 == GEMMS_PER_FORWARD["squeezenet"] * calls["squeezenet-npu"], f"int8 launches {int8}")
    return int8, flash


# ---------------------------------------------------------------------------
# 6. serving: the front door, calibration through the kernels
# ---------------------------------------------------------------------------


# The kernel each model's calibration must be timed through.
KERNEL_OF = {"resnet-50": "int8_matmul", "squeezenet": "int8_matmul", VIT: "flash_attention"}


def run_front_door(torch, ops, flash_ops, serve, session, models=None) -> tuple[int, int]:
    """One ``Session.run_serving`` over 64 frames; returns its (int8, flash)
    launches."""
    spec, device = serve.build_spec(["--frames", "64"])
    check(device == DEVICE, f"launch.serve defaults to device {device!r}")
    if models is not None:
        spec = dataclasses.replace(spec, models=models)
    names = [m.name for m in spec.models]
    ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
    report = session.Session(spec, device=device).run_serving()
    torch.cuda.synchronize()
    int8, flash = ops.int8_matmul.launches, flash_ops.flash_attention.launches
    meta = report.meta
    log(f"serving {names}: summary "
        f"{json.dumps({k: v for k, v in meta.items() if k not in ('calibration', 'policy_spec')})}")
    for m in meta["calibration"]["models"]:
        prov = m["provenance"]
        log(f"serving: calibrated {m['name']}: t_npu {m['t_npu_ms']:.3f} ms t_server {m['t_server_ms']:.3f} ms "
            f"by batch npu {prov['t_npu_ms_by_batch']} edge {prov['t_server_ms_by_batch']} "
            f"launches while timing {prov['kernel_launches_timed']}; kernel {prov['kernel']!r}")
        want = KERNEL_OF[m["name"]]
        check(prov["backend"] == "cuda" and prov["kernel"].endswith("(cuda)") and f"{want}.cu" in prov["kernel"]
              and prov["kernel_launches_timed"][want] > 0,
              f"{m['name']}: calibration was not timed through the {want} kernel: {prov}")
    log(f"serving {names}: int8 launches {int8}, flash launches {flash}")
    check(meta["frames"] == 64, f"answered {meta['frames']} of 64 frames")
    check("deadline_met_frac" in meta, "summary lacks deadline_met_frac")
    return int8, flash


def phase_serving(torch, ops, flash_ops, serve, session) -> tuple[int, int]:
    """The default pair, then ViT-S/16 with SqueezeNet; returns the (int8,
    flash) launches of both runs together."""
    int8, flash = run_front_door(torch, ops, flash_ops, serve, session)
    check(int8 > 0 and flash == 0, "the default pair must launch the int8 kernel and not the flash kernel")
    vit_int8, vit_flash = run_front_door(torch, ops, flash_ops, serve, session, models=({"name": VIT}, "squeezenet"))
    check(vit_int8 > 0 and vit_flash > 0, "the ViT run must launch both kernels")
    return int8 + vit_int8, flash + vit_flash


# ---------------------------------------------------------------------------
# 7. main shapes: every shape the main path gave a kernel, checked
# ---------------------------------------------------------------------------


def phase_main_shapes(torch, ops, ref, flash_ops, flash_ref, gemms, attns) -> tuple[dict, dict]:
    """Each kernel against its plain version, untimed, at the shapes in
    ``gemms`` / ``attns``; returns the rows by shape of each."""
    gemm_rows = {s: compare_shape(torch, ops, ref, *s, timed=False) for s in sorted(gemms)}
    flash_rows = {s: compare_flash(torch, flash_ops, flash_ref, s, timed=False) for s in sorted(attns)}
    for name, rows, tol in (("int8_matmul", gemm_rows, "exact"), ("flash_attention", flash_rows, FLASH_TOL)):
        log(f"main shapes: {name} at {len(rows)} more shapes of the main path: {sorted(rows)}; largest |kernel - "
            f"plain| {max((r['max_abs_err'] for r in rows.values()), default=0.0):.3g} (tolerance {tol})")
    bad = [s for s, r in gemm_rows.items() if not r["equal"]] + [s for s, r in flash_rows.items() if not r["ok"]]
    check(not bad, f"kernel and plain version differ at main-path shapes {bad}")
    return gemm_rows, flash_rows


# ---------------------------------------------------------------------------
# 8. sim: the audited simulators and every policy, against the reference
# ---------------------------------------------------------------------------


def sim_cases(scenariogen) -> dict:
    """Case name -> (mode, ScenarioSpec JSON): the reference's golden
    settings (tests/test_session.py:218-293), the four DP planners over the
    paper's stream length, three fleets and a track fleet, and two online
    runs.  ``scenariogen`` is the package's own, so the same table can be
    computed by either package."""
    cases = {}
    for name, params in POLICY_PARAMS.items():
        spec = {"policy": {"name": name, "params": params}, "n_frames": GOLD_FRAMES,
                "trace": {"kind": "constant", "mbps": 2.5}}
        if name in TRACK_POLICIES:
            spec["workload"] = {"kind": "track"}
        cases[f"sim/{name}"] = ("sim", spec)
    for name in DP_POLICIES:
        cases[f"sim{DP_FRAMES}/{name}"] = ("sim", {
            "policy": {"name": name, "params": POLICY_PARAMS[name]}, "n_frames": DP_FRAMES,
            "trace": {"kind": "piecewise", "points": PIECEWISE}})
    # 3 clients, capacity 4 (tests/test_session.py:256-275) at 12 Mbps; the
    # track fleet at 30 Mbps, where its detections are offloaded.
    fleets = [(alloc, "max_accuracy", 12.0) for alloc in ALLOCATIONS] + [("weighted_fair", "track_accuracy", 30.0)]
    for alloc, name, mbps in fleets:
        spec = {"policy": {"name": name, "params": {}}, "n_frames": GOLD_FRAMES,
                "trace": {"kind": "constant", "mbps": mbps},
                "fleet": {"n_clients": 3, "allocation": alloc, "capacity": 4}}
        if name in TRACK_POLICIES:
            spec["workload"] = {"kind": "track"}
        cases[f"multi/{alloc}/{name}"] = ("multi", spec)
    cases["online/piecewise"] = ("online", {"policy": {"name": "max_accuracy", "params": {}}, "n_frames": 90,
                                            "trace": {"kind": "piecewise", "points": PIECEWISE}})
    cases["online/mobility_square"] = (
        "online", scenariogen.make_scenario("mobility_square", policy="max_accuracy").to_json())
    return cases


def sim_result(report) -> dict:
    """What the contract compares exactly: per stream (frames total,
    processed, missed, offloaded, planner calls, accuracy sum), and the
    meta the fleet and online engines report."""
    out = {"streams": [[s.frames_total, s.frames_processed, s.frames_missed_deadline, s.frames_offloaded,
                        s.schedule_calls, s.accuracy_sum] for s in report.streams]}
    for key in ("server_jobs", "server_utilization", "grants", "denials", "rounds", "estimated_bps"):
        if key in report.meta:
            out[key] = report.meta[key]
    return out


def sim_table(session, scenariogen, run) -> tuple[dict, dict]:
    """Every case of :func:`sim_cases` through ``run(spec, mode)``; returns
    ({case: sim_result}, {case: report})."""
    reports = {name: run(session.ScenarioSpec.from_json(spec), mode)
               for name, (mode, spec) in sim_cases(scenariogen).items()}
    return {name: sim_result(r) for name, r in reports.items()}, reports


def planning_ms(reports) -> str:
    return ", ".join(f"{name} {1e3 * sum(s.schedule_time for s in r.streams) / sum(s.schedule_calls for s in r.streams):.3f}"
                     for name, r in reports.items())


def phase_sim(torch, core, session, scenariogen, t_ms, smi: str) -> None:
    """Every case of :func:`sim_cases` on the card, held against
    SIM_GOLDENS; then every classify policy on the profiles serve_full
    measured on the card; planning time per round throughout."""
    t0 = time.perf_counter()
    table, reports = sim_table(session, scenariogen,
                               lambda spec, mode: session.Session(spec, device=DEVICE).run(mode))
    bad = sorted(name for name in SIM_GOLDENS if table.get(name) != SIM_GOLDENS[name])
    for name in bad:
        log(f"sim: {name}: port {table.get(name)} reference {SIM_GOLDENS[name]}")
    check(table.keys() == SIM_GOLDENS.keys(), f"sim cases {sorted(table)} != SIM_GOLDENS {sorted(SIM_GOLDENS)}")
    check(not bad, f"sim results differ from the reference's at {bad}")
    for name, row in table.items():
        log(f"sim: {name}: {json.dumps(row)}")
    log(f"sim: {len(table)} cases equal the reference's (integer stats, accuracy sums, fleet and online meta "
        f"exact) in {time.perf_counter() - t0:.1f} s on device={DEVICE}")
    log(f"sim: planning ms per round ({smi}): {planning_ms(reports)}")
    # The on-device planners' rounds on the host CPU, same cases, for comparison.
    host = {name: session.Session(session.ScenarioSpec.from_json(spec), device="cpu").run(mode)
            for name, (mode, spec) in sim_cases(scenariogen).items() if name.startswith(f"sim{DP_FRAMES}/jax_")}
    check(all(sim_result(r) == table[name] for name, r in host.items()), "jax_* planners on the CPU differ")
    log(f"sim: planning ms per round of the same runs with device='cpu' (the host's cores): {planning_ms(host)}")

    # The planners on the card's own profiles: serve_full's batch-1 medians.
    models = tuple(core.profile_ms(name, t_npu_ms=t_ms[(name, "npu")], t_server_ms=t_ms[(name, "edge")],
                                   acc_server=base.acc_server, acc_npu=base.acc_npu)
                   for name, base in (("resnet-50", core.RESNET50), ("squeezenet", core.SQUEEZENET)))
    log("sim: card profiles (serve_full, batch 1): " + ", ".join(
        f"{m.name} t_npu {1e3 * m.t_npu:.3f} ms t_server {1e3 * m.t_server:.3f} ms" for m in models))
    card = {}
    for name, params in POLICY_PARAMS.items():
        if name in TRACK_POLICIES:
            continue
        n = GOLD_FRAMES if name == "brute_force" else CARD_FRAMES
        spec = session.ScenarioSpec(policy=core.PolicySpec(name, params), n_frames=n, models=models,
                                    trace=session.TraceSpec(kind="piecewise", points=tuple(map(tuple, PIECEWISE))))
        st = session.Session(spec, device=DEVICE).run_sim().stats
        card[name] = session.RunReport("sim", spec, [st])
        log(f"sim: card profiles, {name} over {n} frames: processed {st.frames_processed}, offloaded "
            f"{st.frames_offloaded}, missed {st.frames_missed_deadline}, mean accuracy {st.mean_accuracy:.4f}")
        check(st.frames_total == n and 0 < st.frames_processed <= n and 0 <= st.frames_offloaded <= st.frames_processed
              and st.frames_processed + st.frames_missed_deadline <= n + st.frames_offloaded,
              f"{name} on the card's profiles: stats break the audit's invariants: {st}")
    log(f"sim: card profiles, planning ms per round ({smi}): {planning_ms(card)}")


# ---------------------------------------------------------------------------
# 9. sweep: Session.run_sweep through the lane-batched engine
# ---------------------------------------------------------------------------


def sweep_spec(name: str, n_frames: int, **kw) -> dict:
    spec = {"policy": {"name": name, "params": SWEEP_PARAMS[name][0]}, "n_frames": n_frames, **kw}
    if name in TRACK_POLICIES:
        spec["workload"] = {"kind": "track"}
    return spec


def sweep_cases() -> dict:
    """Case name -> (ScenarioSpec JSON, SweepGrid JSON): a 20-point
    sub-grid of tests/test_sim_batch.py::_golden_grid at 24 frames (2
    bandwidths x 5 deadlines, 10 ms the skip path, x 2 fps), for the max_*
    policies also under the reference's piecewise trace (its rtt axis in
    place of bandwidth), and the track policies' grid of
    tests/test_tracking.py."""
    deadlines = [10.0, 100.0, 150.0, 200.0, 350.0]
    cases = {}
    for name in SWEEP_PARAMS:
        if name in TRACK_POLICIES:
            cases[f"{name}/track"] = ({**sweep_spec(name, GOLD_FRAMES), **TRACK_BASE}, TRACK_GRID)
            continue
        cases[f"{name}/constant"] = (sweep_spec(name, GOLD_FRAMES),
                                     {"bandwidth_mbps": [1.0, 2.5], "deadline_ms": deadlines, "fps": [24.0, 50.0]})
        if name in NET_POLICIES:
            trace = {"kind": "piecewise", "points": SWEEP_PIECEWISE, "rtt_ms": 60.0}
            cases[f"{name}/piecewise"] = (sweep_spec(name, GOLD_FRAMES, trace=trace),
                                          {"rtt_ms": [40.0, 100.0], "deadline_ms": deadlines, "fps": [24.0, 50.0]})
    return cases


def stats_rows(stats) -> list:
    """Per stream: frames total, processed, missed, offloaded, planner
    calls, accuracy sum, NPU busy seconds."""
    return [[s.frames_total, s.frames_processed, s.frames_missed_deadline, s.frames_offloaded, s.schedule_calls,
             s.accuracy_sum, s.npu_busy_s] for s in stats]


def sweep_rows(report) -> list:
    """Per point of a SweepReport, the first six of :func:`stats_rows` (the
    per-point loop leaves ``npu_busy_s`` at 0)."""
    return [row[:6] for row in stats_rows(s for p in report.points for s in p.streams)]


def sweep_table(session, run) -> dict:
    """Every case of :func:`sweep_cases` through ``run(spec, grid)``."""
    return {name: sweep_rows(run(session.ScenarioSpec.from_json(spec), session.SweepGrid.from_json(grid)))
            for name, (spec, grid) in sweep_cases().items()}


def sweep_agree(name: str, got: list, want: list, tol: float) -> bool:
    """The reference's contract: every field exact, but for the max_*
    policies an accuracy sum within ``tol`` (AUDIT_TOL)."""
    if len(got) != len(want):
        return False
    acc_tol = tol if name.split("/")[0] in NET_POLICIES else 0.0
    return all(g[:5] == w[:5] and abs(g[5] - w[5]) <= acc_tol for g, w in zip(got, want))


def full_grids(name: str) -> list[tuple[dict, dict]]:
    """The policy's 1000 full-width points as two (spec, grid) halves:
    constant traces (a bandwidth axis), then SWEEP_TRACE (an rtt axis)."""
    axis = SWEEP_PARAMS[name][1]
    return [(sweep_spec(name, SWEEP_FRAMES),
             {"bandwidth_mbps": SWEEP_BW, "deadline_ms": SWEEP_DL, "fps": SWEEP_FPS, "params": axis}),
            (sweep_spec(name, SWEEP_FRAMES, trace=SWEEP_TRACE),
             {"rtt_ms": SWEEP_RTT, "deadline_ms": SWEEP_DL, "fps": SWEEP_FPS, "params": axis})]


def batch_scenarios(session, core, spec: dict, grid: dict, every: int = 1, limit: int | None = None):
    """The engine's scenarios for the grid's points (every ``every``-th,
    at most ``limit``), as run_sweep builds them."""
    base = session.ScenarioSpec.from_json(spec)
    pts = session.SweepGrid.from_json(grid).points()[::every][:limit]
    specs = [session._apply_point(base, p) for p in pts]
    return base, [core.sim_batch.BatchScenario(stream=s.stream, n_frames=s.n_frames, params=s.policy.params,
                                               rtt=s.trace.rtt_s, bw_segments=s.trace.segments(),
                                               workload=s.workload) for s in specs]


def timed(torch, fn):
    """(result, wall seconds) of ``fn()`` ended by a synchronize."""
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sweep(torch, core, session, smi: str) -> None:
    """The six batched policies through ``Session.run_sweep`` on the card:
    SWEEP_GOLDENS, full width against the host CPU, chunking, the per-point
    loop for comparison, and one group's rounds profiled."""
    t_phase = time.perf_counter()
    tol = core.audit.AUDIT_TOL
    batched = lambda spec, grid: session.Session(spec, device=DEVICE).run_sweep(grid, backend="batched")  # noqa: E731
    table = sweep_table(session, batched)
    bad = sorted(n for n in SWEEP_GOLDENS if not sweep_agree(n, table.get(n, []), SWEEP_GOLDENS[n], tol))
    for name in bad:
        log(f"sweep: {name}: port {table.get(name)} reference {SWEEP_GOLDENS[name]}")
    check(table.keys() == SWEEP_GOLDENS.keys(), f"sweep cases {sorted(table)} != SWEEP_GOLDENS")
    check(not bad, f"sweep results differ from the reference's at {bad}")
    bit_equal = sum(g == w for n in table for g, w in zip(table[n], SWEEP_GOLDENS[n]))
    log(f"sweep: {sum(map(len, table.values()))} golden points of {len(table)} cases hold the reference's "
        f"contract on device={DEVICE} ({bit_equal} bit-equal in every field)")

    for name in SWEEP_PARAMS:
        grids = full_grids(name)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # what earlier phases still hold
        first, s1 = timed(torch, lambda: [batched(session.ScenarioSpec.from_json(sp), session.SweepGrid.from_json(g))
                                          for sp, g in grids])
        second, s2 = timed(torch, lambda: [batched(session.ScenarioSpec.from_json(sp), session.SweepGrid.from_json(g))
                                           for sp, g in grids])
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20 if DEVICE == "cuda" else float("nan")
        n = sum(len(r.points) for r in first)
        (param_values,) = SWEEP_PARAMS[name][1].values()
        check(n == 2 * len(SWEEP_BW) * len(SWEEP_DL) * len(SWEEP_FPS) * len(param_values),
              f"{name}: {n} full-width points")
        check(sweep_rows(first[0]) + sweep_rows(first[1]) == sweep_rows(second[0]) + sweep_rows(second[1]),
              f"{name}: two runs of the same grid differ")
        groups = [g for r in second for g in r.meta["groups"]]
        rounds = [g["rounds"] for g in groups]
        reads = sum(g["host_reads"] for g in groups)
        # The host CPU re-runs every CPU_CHECK_EVERY-th point: bit for bit.
        cpu_s, n_cpu, agree = 0.0, 0, 0
        for (spec, grid), rep in zip(grids, second):
            base, scens = batch_scenarios(session, core, spec, grid, every=CPU_CHECK_EVERY)
            cpu, s = timed(torch, lambda: core.sim_batch.simulate_batch(name, list(base.models), scens, device="cpu"))
            card = [p.stats for p in rep.points][::CPU_CHECK_EVERY]
            cpu_s, n_cpu = cpu_s + s, n_cpu + len(cpu)
            agree += sum(a == b for a, b in zip(stats_rows(card), stats_rows(cpu)))
        check(agree == n_cpu, f"{name}: the card and the host CPU differ at {n_cpu - agree} of {n_cpu} points")
        # The per-point loop (backend="reference") on the card, for comparison.
        ref_ms = {}
        for n_ref, grid in REFERENCE_GRIDS.items():
            if name.startswith("jax_") and n_ref > min(REFERENCE_GRIDS):
                continue  # their per-round planners take seconds a point on the card (phase 8)
            spec = session.ScenarioSpec.from_json(sweep_spec(name, SWEEP_FRAMES))
            grid = session.SweepGrid.from_json(grid)
            loop, s = timed(torch, lambda: session.Session(spec, device=DEVICE).run_sweep(grid, backend="reference"))
            ref_ms[n_ref] = 1e3 * s / len(grid)
            check(sweep_agree(name, sweep_rows(batched(spec, grid)), sweep_rows(loop), tol),
                  f"{name}: the batched engine differs from the per-point loop")
        log(f"sweep: {name}: {n} points x {SWEEP_FRAMES} frames on device={DEVICE}: {1e3 * s1 / n:.3f} ms/point "
            f"(first call), {1e3 * s2 / n:.3f} (second); host CPU {1e3 * cpu_s / n_cpu:.3f} ms/point over {n_cpu} "
            f"points, bit-equal; per-point loop on device={DEVICE} "
            + ", ".join(f"{k} points {v:.3f} ms/point" for k, v in ref_ms.items())
            + f"; {len(groups)} groups, rounds per group mean {sum(rounds) / len(rounds):.1f} max {max(rounds)}, "
            f"host reads per round {(reads - len(groups)) / sum(rounds):.3f} (+1 per group), peak card memory "
            f"{peak:.1f} MiB above what earlier phases hold")

    # Chunking is result-invariant: max_utility over 10,000 points at 24 frames.
    spec, grid = chunk_grid(session)
    whole, s_whole = timed(torch, lambda: session.Session(spec, device=DEVICE).run_sweep(grid, keep_points=False))
    chunked, s_chunk = timed(torch, lambda: session.Session(spec, device=DEVICE).run_sweep(
        grid, chunk_size=CHUNK_SIZE, keep_points=False))
    check(whole.meta["summary"] == chunked.meta["summary"] and chunked.meta["chunks"] == CHUNK_POINTS // CHUNK_SIZE,
          "chunked and unchunked summaries differ")
    log(f"sweep: max_utility over {CHUNK_POINTS} points x {GOLD_FRAMES} frames: summary unchunked == "
        f"{chunked.meta['chunks']} chunks of {CHUNK_SIZE} ({1e3 * s_whole / CHUNK_POINTS:.3f} / "
        f"{1e3 * s_chunk / CHUNK_POINTS:.3f} ms/point); {json.dumps(chunked.meta['summary'])}")
    if DEVICE == "cuda":
        profile_round(torch, core, session, smi)
    log(f"sweep: phase wall {time.perf_counter() - t_phase:.1f} s ({smi})")


def chunk_grid(session):
    """max_utility over CHUNK_POINTS points at 24 frames: bandwidth x
    deadline x fps x alpha, 10 values each.  Returns (spec, grid)."""
    spec = session.ScenarioSpec.from_json(sweep_spec("max_utility", GOLD_FRAMES))
    side = round(CHUNK_POINTS ** 0.25)
    grid = session.SweepGrid(bandwidth_mbps=tuple(0.5 + 0.55 * i for i in range(side)),
                             deadline_ms=tuple(100.0 + 25.0 * i for i in range(side)),
                             fps=tuple(10.0 + 5.0 * i for i in range(side)),
                             params={"alpha": tuple(20.0 + 20.0 * i for i in range(side))})
    check(len(grid) == CHUNK_POINTS, f"chunk grid has {len(grid)} points")
    return spec, grid


def profile_round(torch, core, session, smi: str) -> None:
    """Where a round's time goes: one max_accuracy shape group (fps 30,
    deadline 350 ms: W = 10, 20 lanes) over PROFILE_FRAMES frames, its
    rounds replayed as CUDA graphs and issued eagerly: wall time of a run
    that builds its lane program (and captures its graph) afresh, and the
    device's busy time from torch.profiler in a second run of each."""
    from torch.profiler import ProfilerActivity, profile

    spec, grid = full_grids("max_accuracy")[0]
    base, scens = batch_scenarios(session, core, {**spec, "n_frames": PROFILE_FRAMES}, grid)
    scens = [s for s in scens if s.stream.fps == 30.0 and abs(s.stream.deadline - 0.35) < 1e-9]
    run = lambda groups=None: core.sim_batch.simulate_batch(  # noqa: E731
        "max_accuracy", list(base.models), scens, device=DEVICE, groups=groups)
    shard = core.sweep_shard
    eager = mock.patch.object(shard.LaneProgram, "start", lambda prog: prog.init())  # never captures
    for label, mode in (("graphed", contextlib.nullcontext()), ("eager", eager)):
        with mode, mock.patch.object(shard, "PROGRAMS", shard.LaneCache()):
            groups = []
            stats, wall = timed(torch, lambda: run(groups))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        (g,) = groups
        log(f"sweep: profile, max_accuracy group {g['key']} of {g['lanes']} lanes over {PROFILE_FRAMES} frames, "
            f"rounds {label}: {g['rounds']} rounds in {1e3 * wall:.1f} ms ({1e3 * wall / g['rounds']:.3f} ms a "
            f"round); device busy {busy:.1f} ms, {100 * busy / (1e3 * wall):.1f}% of the wall ({smi})")


# ---------------------------------------------------------------------------
# 10. online: Session.run_sweep(mode="online") through the lane-batched
#     online engine
# ---------------------------------------------------------------------------


def online_spec(name: str, n_frames: int, trace: dict) -> dict:
    return {"policy": {"name": name, "params": ONLINE_PARAMS[name][0]}, "n_frames": n_frames, "trace": trace}


def online_cases(scenariogen) -> dict:
    """Case name -> (ScenarioSpec JSON, SweepGrid JSON):
    tests/test_online_batch.py:84-143 — the square wave at 45 frames over
    two RTTs; fault injection, 180 frames over the outage edge_failure
    detects (the edge fails at 2 s and recovers at 5 s); a link dead from
    the start (max_accuracy); the golden lattice, 90 frames, deadline x rtt
    x the param axis.  ``scenariogen`` is the package's own, so the same
    table can be computed by either package."""
    outage = scenariogen.edge_failure(fail_at_s=2.0, recover_at_s=5.0, duration_s=8.0, base_mbps=3.5)
    rtts = {"rtt_ms": [60.0, 100.0]}
    cases = {}
    for name, (_, axis) in ONLINE_PARAMS.items():
        cases[f"{name}/square"] = (online_spec(name, 45, ONLINE_SQUARE), rtts)
        cases[f"{name}/fault"] = (online_spec(name, 180, outage.trace.to_json()), rtts)
        cases[f"{name}/lattice"] = (online_spec(name, 90, ONLINE_SQUARE),
                                    {"deadline_ms": [150.0, 200.0, 250.0], **rtts, "params": axis})
    cases["max_accuracy/dead"] = (online_spec("max_accuracy", 45, {"kind": "constant", "mbps": 0.0, "rtt_ms": 100.0}),
                                  {})
    return cases


def online_rows(report) -> list:
    """Per point of an online SweepReport: :func:`sweep_rows`' six fields,
    then the rounds and the final believed bandwidth run_online reports."""
    return [[*row, p.meta["rounds"], p.meta["estimated_bps"]] for row, p in zip(sweep_rows(report), report.points)]


def online_table(session, scenariogen, run) -> dict:
    """Every case of :func:`online_cases` through ``run(spec, grid)``."""
    return {name: online_rows(run(session.ScenarioSpec.from_json(spec), session.SweepGrid.from_json(grid)))
            for name, (spec, grid) in online_cases(scenariogen).items()}


def online_agree(got: list, want: list, tol: float) -> bool:
    """The reference's online contract: integer stats and rounds exact, the
    accuracy sum within ``tol`` (AUDIT_TOL), the believed bandwidth bit for
    bit."""
    return len(got) == len(want) and all(
        g[:5] == w[:5] and abs(g[5] - w[5]) <= tol and g[6:] == w[6:] for g, w in zip(got, want))


def adaptivity_case(session, scenariogen, name: str, n_frames: int):
    """(spec, grid) of the adaptivity bench's 1000-point grid over
    ``n_frames``: the mobility square wave lasts the whole stream."""
    trace = scenariogen.make_trace("mobility_square", duration_s=max(16.0, n_frames / 30.0)).to_json()
    return (session.ScenarioSpec.from_json(online_spec(name, n_frames, trace)),
            session.SweepGrid.from_json(ADAPT_GRID))


def online_scenarios(core, session, spec, grid, every: int):
    """The online engine's scenarios for every ``every``-th grid point, as
    run_sweep builds them."""
    specs = [session._apply_point(spec, p) for p in grid.points()[::every]]
    return [core.sim_online_batch.OnlineScenario(stream=s.stream, n_frames=s.n_frames, params=s.policy.params,
                                                 rtt=s.trace.rtt_s, bw_segments=s.trace.segments()) for s in specs]


def phase_online(torch, core, session, scenariogen, smi: str) -> None:
    """The two batched_online policies through ``Session.run_sweep(mode=
    "online")`` on the card: ONLINE_GOLDENS, the adaptivity grid against
    the per-point loop, and at 900 frames against the host CPU."""
    t_phase = time.perf_counter()
    tol = core.audit.AUDIT_TOL

    def batched(spec, grid):
        report = session.Session(spec, device=DEVICE).run_sweep(grid, backend="batched", mode="online")
        check(report.meta.get("engine") == "sim_online_batch", f"online sweep ran on {report.meta.get('engine')}")
        return report

    table = online_table(session, scenariogen, batched)
    bad = sorted(n for n in ONLINE_GOLDENS if not online_agree(table.get(n, []), ONLINE_GOLDENS[n], tol))
    for name in bad:
        log(f"online: {name}: port {table.get(name)} reference {ONLINE_GOLDENS[name]}")
    check(table.keys() == ONLINE_GOLDENS.keys(), f"online cases {sorted(table)} != ONLINE_GOLDENS")
    check(not bad, f"online results differ from the reference's at {bad}")
    bit_equal = sum(g == w for n in table for g, w in zip(table[n], ONLINE_GOLDENS[n]))
    log(f"online: {sum(map(len, table.values()))} golden points of {len(table)} cases hold the reference's "
        f"contract on device={DEVICE} ({bit_equal} bit-equal in every field, estimated_bps in all)")

    for name in ONLINE_PARAMS:
        spec, grid = adaptivity_case(session, scenariogen, name, ADAPT_FRAMES)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        first, s1 = timed(torch, lambda: batched(spec, grid))
        second, s2 = timed(torch, lambda: batched(spec, grid))
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20 if DEVICE == "cuda" else float("nan")
        n = len(second.points)
        check(n == len(ADAPT_GRID["deadline_ms"]) * len(ADAPT_GRID["rtt_ms"]), f"{name}: {n} points")
        check(online_rows(first) == online_rows(second), f"{name}: two runs of the same online grid differ")
        loop, s_loop = timed(torch, lambda: session.Session(spec, device=DEVICE).run_sweep(
            grid, backend="reference", mode="online"))
        check(online_agree(online_rows(second), online_rows(loop), tol),
              f"{name}: the online engine differs from the per-point run_online loop")
        groups = second.meta["groups"]
        rounds = [g["rounds"] for g in groups]
        reads = sum(g["host_reads"] for g in groups)
        cap = core.sim_batch._UTIL_CAP  # max_utility's program statics: (width, exact, strict)
        reruns = sum(g["lanes"] for g in groups if name == "max_utility" and g["statics"][0] == cap)
        log(f"online: {name}: {n} points x {ADAPT_FRAMES} frames on device={DEVICE}: {1e3 * s1 / n:.3f} ms/point "
            f"(first call), {1e3 * s2 / n:.3f} (second); per-point run_online loop on device={DEVICE} "
            f"{1e3 * s_loop / n:.3f} ms/point, every point held to the contract (integer stats and rounds exact, "
            f"accuracy within AUDIT_TOL, estimated_bps bit-equal); {len(groups)} groups (lanes "
            f"{[g['lanes'] for g in groups]}), rounds per group mean {sum(rounds) / len(rounds):.1f} max "
            f"{max(rounds)}, host reads per round {(reads - len(groups)) / sum(rounds):.3f} (+1 per group), "
            f"lanes rerun at the cap {reruns}, peak card memory {peak:.1f} MiB above what earlier phases hold")

        spec, grid = adaptivity_case(session, scenariogen, name, ADAPT_LONG_FRAMES)
        long_run, s_long = timed(torch, lambda: batched(spec, grid))
        scens = online_scenarios(core, session, spec, grid, ONLINE_CPU_EVERY)
        cpu, s_cpu = timed(torch, lambda: core.sim_online_batch.simulate_online_batch(
            name, list(spec.models), scens, device="cpu"))
        card = long_run.points[::ONLINE_CPU_EVERY]
        agree = sum(stats_rows(p.streams) == stats_rows([st]) and p.meta["rounds"] == m["rounds"]
                    and p.meta["estimated_bps"] == m["estimated_bps"] for p, (st, m) in zip(card, cpu))
        check(len(cpu) == len(card) and agree == len(cpu),
              f"{name}: the card and the host CPU differ at {len(cpu) - agree} of {len(cpu)} online points")
        groups = long_run.meta["groups"]
        rounds = [g["rounds"] for g in groups]
        log(f"online: {name}: {n} points x {ADAPT_LONG_FRAMES} frames on device={DEVICE}: "
            f"{1e3 * s_long / n:.3f} ms/point; host CPU {1e3 * s_cpu / len(cpu):.3f} ms/point over {len(cpu)} "
            f"points, bit-equal in every field; {len(groups)} groups, rounds per group max {max(rounds)}")
    log(f"online: phase wall {time.perf_counter() - t_phase:.1f} s ({smi})")


# ---------------------------------------------------------------------------
# 11. cache: the per-shape cache of captured lane programs
# ---------------------------------------------------------------------------


def program_keys(report) -> set:
    """The distinct lane-program keys a sweep's shape groups ran: planner,
    group key, the values its step reads as numbers, lane bucket."""
    return {(g["policy"], json.dumps(g["key"]), json.dumps(g["statics"]), g["bucket"]) for g in report.meta["groups"]}


def phase_cache(torch, core, session, smi: str) -> None:
    """The sweep phase's 10,000-point max_utility grid in chunks of
    CHUNK_SIZE: with the cache off (every chunk's groups capture their own
    graphs, as before the cache), then on, twice."""
    shard, counter = core.sweep_shard, core.compile_cache.CompileCounter
    spec, grid = chunk_grid(session)
    run = lambda: session.Session(spec, device=DEVICE).run_sweep(grid, chunk_size=CHUNK_SIZE)  # noqa: E731
    with mock.patch.object(shard, "PROGRAMS", shard.LaneCache(0)), counter() as off:
        uncached, s_off = timed(torch, run)
    shard.PROGRAMS.clear()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        reserved, allocated = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    with counter() as cold:
        cached, s_cold = timed(torch, run)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
        held_reserved = (torch.cuda.memory_reserved() - reserved) / 2**20
        held_allocated = (torch.cuda.memory_allocated() - allocated) / 2**20
    else:
        held_reserved = held_allocated = float("nan")
    with counter() as warm:
        again, s_warm = timed(torch, run)
    rows = [stats_rows(p.streams) for p in uncached.points]
    check(rows == [stats_rows(p.streams) for p in cached.points] == [stats_rows(p.streams) for p in again.points]
          and uncached.meta["summary"] == cached.meta["summary"] == again.meta["summary"],
          "the cached and uncached chunked sweeps differ")
    graphs = DEVICE == "cuda"  # on the CPU a program holds buffers and no graph
    n_groups, keys = len(uncached.meta["groups"]), program_keys(cached)
    check((off.captures, off.hits) == (n_groups if graphs else 0, 0), f"uncached: {off}")
    check((cold.captures, cold.misses) == (len(keys) if graphs else 0, len(keys)), f"cached, first call: {cold}")
    check((warm.captures, warm.misses, warm.hits) == (0, 0, n_groups), f"cached, second call: {warm}")
    log(f"cache: max_utility over {CHUNK_POINTS} points x {GOLD_FRAMES} frames in {uncached.meta['chunks']} chunks "
        f"of {CHUNK_SIZE} on device={DEVICE}: {n_groups} shape groups, {len(keys)} distinct program keys; "
        f"without the cache {off.captures} captures in {s_off:.3f} s; with it {cold.captures} captures, "
        f"{cold.hits} hits in {s_cold:.3f} s, then {warm.captures} captures, {warm.hits} hits in {s_warm:.3f} s; "
        f"results equal in every field; the cached programs hold {held_reserved:.1f} MiB reserved "
        f"({held_allocated:.1f} MiB allocated: buffers and round state) in {len(shard.PROGRAMS)} programs ({smi})")


# The reference's numbers for every case of sim_cases(), computed by
# ``repro`` (tests/test_torch_sim.py::test_sim_goldens_equal_reference checks
# this table against it): per stream [frames total, processed, missed,
# offloaded, planner calls, accuracy sum], and the fleet and online meta.
SIM_GOLDENS = {'sim/max_accuracy': {'streams': [[24, 24, 0, 2, 5, 11.579999999999998]]},
 'sim/max_utility': {'streams': [[24, 23, 0, 3, 4, 11.269999999999998]]},
 'sim/local': {'streams': [[24, 24, 0, 0, 4, 11.489999999999998]]},
 'sim/offload': {'streams': [[24, 24, 0, 24, 24, 4.800000000000002]]},
 'sim/deepdecision': {'streams': [[24, 24, 0, 0, 1, 9.840000000000002]]},
 'sim/brute_force': {'streams': [[24, 24, 0, 6, 4, 11.759999999999998]]},
 'sim/jax_accuracy': {'streams': [[24, 24, 0, 0, 4, 11.489999999999998]]},
 'sim/jax_utility': {'streams': [[24, 19, 0, 0, 4, 9.769999999999996]]},
 'sim/track_accuracy': {'streams': [[24, 24, 0, 0, 12, 11.543999999999999]]},
 'sim/track_fixed': {'streams': [[24, 24, 0, 0, 8, 10.701600000000001]]},
 'sim900/max_accuracy': {'streams': [[900, 900, 0, 1, 151, 415.630000000002]]},
 'sim900/max_utility': {'streams': [[900, 609, 0, 4, 150, 312.21000000000026]]},
 'sim900/jax_accuracy': {'streams': [[900, 900, 0, 0, 150, 415.6400000000019]]},
 'sim900/jax_utility': {'streams': [[900, 603, 0, 0, 150, 309.8200000000004]]},
 'multi/weighted_fair/max_accuracy': {'streams': [[24, 24, 0, 1, 5, 11.479999999999999],
                                                  [24, 24, 0, 0, 4, 11.489999999999998],
                                                  [24, 24, 0, 0, 4, 11.489999999999998]],
                                      'server_jobs': 1,
                                      'server_utilization': 0.011249999999999998,
                                      'grants': 11,
                                      'denials': 2},
 'multi/priority/max_accuracy': {'streams': [[24, 24, 0, 1, 5, 11.479999999999999],
                                             [24, 24, 0, 0, 4, 11.489999999999998],
                                             [24, 24, 0, 0, 4, 11.489999999999998]],
                                 'server_jobs': 1,
                                 'server_utilization': 0.011249999999999998,
                                 'grants': 11,
                                 'denials': 2},
 'multi/fifo/max_accuracy': {'streams': [[24, 0, 24, 0, 24, 0.0], [24, 0, 24, 0, 24, 0.0], [24, 0, 24, 0, 24, 0.0]],
                             'server_jobs': 72,
                             'server_utilization': 6.209999999999996,
                             'grants': 72,
                             'denials': 0},
 'multi/weighted_fair/track_accuracy': {'streams': [[24, 24, 0, 24, 24, 13.440000000000008],
                                                    [24, 24, 0, 0, 12, 11.543999999999999],
                                                    [24, 24, 0, 0, 12, 11.543999999999999]],
                                        'server_jobs': 24,
                                        'server_utilization': 2.069999999999999,
                                        'grants': 24,
                                        'denials': 24},
 'online/piecewise': {'streams': [[90, 88, 2, 4, 18, 41.42999999999999]],
                      'rounds': 18,
                      'estimated_bps': 1910699.9999999995},
 'online/mobility_square': {'streams': [[120, 120, 0, 0, 20, 55.79999999999998]],
                            'rounds': 20,
                            'estimated_bps': 3150000.0}}


# The reference's numbers for every case of sweep_cases(), computed by
# ``repro``'s per-point loop (run_sweep(backend="reference"); its batched
# engine gives the same table): per point [frames total, processed, missed,
# offloaded, planner calls, accuracy sum].  tests/test_torch_sweep_goldens.py
# checks this table against the reference.
SWEEP_GOLDENS = {'jax_accuracy/constant': [[24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0], [24, 24, 0, 0, 12, 11.819999999999997],
                           [24, 24, 0, 0, 5, 10.280000000000001], [24, 24, 0, 0, 8, 12.039999999999996],
                           [24, 24, 0, 0, 4, 10.390000000000002], [24, 24, 0, 0, 6, 12.149999999999995],
                           [24, 24, 0, 0, 3, 10.610000000000001], [24, 24, 0, 0, 3, 12.479999999999993],
                           [24, 24, 0, 0, 2, 10.939999999999998], [24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0],
                           [24, 24, 0, 0, 12, 11.819999999999997], [24, 24, 0, 0, 5, 10.280000000000001],
                           [24, 24, 0, 0, 8, 12.039999999999996], [24, 24, 0, 0, 4, 10.390000000000002],
                           [24, 24, 0, 0, 6, 12.149999999999995], [24, 24, 0, 0, 3, 10.610000000000001],
                           [24, 24, 0, 0, 3, 12.479999999999993], [24, 24, 0, 0, 2, 10.939999999999998]],
 'jax_utility/constant': [[24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0], [24, 24, 0, 0, 12, 11.819999999999997],
                          [24, 24, 0, 0, 5, 10.280000000000001], [24, 22, 0, 0, 8, 11.219999999999995],
                          [24, 22, 0, 0, 4, 9.680000000000001], [24, 23, 0, 0, 6, 11.739999999999995],
                          [24, 15, 0, 0, 3, 7.359999999999998], [24, 24, 0, 0, 3, 12.479999999999993],
                          [24, 20, 0, 0, 2, 9.629999999999999], [24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0],
                          [24, 24, 0, 0, 12, 11.819999999999997], [24, 24, 0, 0, 5, 10.280000000000001],
                          [24, 22, 0, 0, 8, 11.219999999999995], [24, 22, 0, 0, 4, 9.680000000000001],
                          [24, 23, 0, 0, 6, 11.739999999999995], [24, 15, 0, 0, 3, 7.359999999999998],
                          [24, 24, 0, 0, 3, 12.479999999999993], [24, 20, 0, 0, 2, 9.629999999999999]],
 'max_accuracy/constant': [[24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0], [24, 24, 0, 0, 12, 11.819999999999997],
                           [24, 24, 0, 0, 5, 10.170000000000002], [24, 24, 0, 0, 8, 12.039999999999996],
                           [24, 24, 0, 0, 4, 10.390000000000002], [24, 24, 0, 0, 6, 12.149999999999995],
                           [24, 24, 0, 0, 3, 10.500000000000002], [24, 24, 0, 0, 3, 12.479999999999993],
                           [24, 24, 0, 4, 4, 11.18], [24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0],
                           [24, 24, 0, 0, 12, 11.819999999999997], [24, 24, 0, 0, 5, 10.170000000000002],
                           [24, 24, 0, 0, 8, 12.039999999999996], [24, 24, 0, 0, 4, 10.390000000000002],
                           [24, 24, 0, 0, 6, 12.149999999999995], [24, 24, 0, 5, 5, 10.670000000000002],
                           [24, 24, 0, 6, 6, 13.139999999999997], [24, 24, 0, 6, 6, 11.959999999999999]],
 'max_accuracy/piecewise': [[24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0],
                            [24, 0, 0, 0, 24, 0.0], [24, 24, 0, 0, 12, 11.819999999999997],
                            [24, 24, 0, 0, 12, 11.819999999999997], [24, 24, 0, 0, 5, 10.170000000000002],
                            [24, 24, 0, 0, 5, 10.170000000000002], [24, 24, 0, 0, 8, 12.039999999999996],
                            [24, 24, 0, 0, 8, 12.039999999999996], [24, 24, 0, 6, 8, 10.74],
                            [24, 24, 0, 0, 4, 10.390000000000002], [24, 24, 0, 4, 8, 12.529999999999994],
                            [24, 24, 0, 0, 6, 12.149999999999995], [24, 24, 0, 4, 5, 11.210000000000003],
                            [24, 24, 0, 3, 5, 10.580000000000002], [24, 24, 0, 2, 4, 12.779999999999994],
                            [24, 24, 0, 2, 4, 12.699999999999994], [24, 24, 0, 5, 5, 11.7], [24, 24, 0, 5, 5, 11.7]],
 'max_utility/constant': [[24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0], [24, 24, 0, 0, 12, 11.819999999999997],
                          [24, 24, 0, 0, 5, 10.280000000000001], [24, 22, 0, 0, 8, 11.219999999999995],
                          [24, 22, 0, 0, 4, 9.680000000000001], [24, 23, 0, 0, 6, 11.739999999999995],
                          [24, 19, 0, 1, 3, 8.57], [24, 24, 0, 0, 3, 12.479999999999993],
                          [24, 21, 0, 2, 2, 10.059999999999999], [24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0],
                          [24, 24, 0, 0, 12, 11.819999999999997], [24, 24, 0, 0, 5, 10.280000000000001],
                          [24, 22, 0, 0, 8, 11.219999999999995], [24, 24, 0, 3, 4, 10.14],
                          [24, 24, 0, 1, 6, 12.139999999999995], [24, 22, 0, 2, 3, 9.88],
                          [24, 24, 0, 3, 3, 12.809999999999995], [24, 21, 0, 2, 2, 10.479999999999999]],
 'max_utility/piecewise': [[24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0], [24, 0, 0, 0, 24, 0.0],
                           [24, 0, 0, 0, 24, 0.0], [24, 24, 0, 0, 12, 11.819999999999997],
                           [24, 24, 0, 0, 12, 11.819999999999997], [24, 24, 0, 0, 5, 10.280000000000001],
                           [24, 24, 0, 0, 5, 10.280000000000001], [24, 22, 0, 0, 8, 11.219999999999995],
                           [24, 22, 0, 0, 8, 11.219999999999995], [24, 24, 0, 4, 4, 10.32],
                           [24, 24, 0, 2, 4, 10.260000000000002], [24, 23, 0, 2, 6, 12.039999999999994],
                           [24, 23, 0, 0, 6, 11.739999999999995], [24, 23, 0, 3, 3, 10.290000000000001],
                           [24, 19, 0, 1, 3, 8.77], [24, 24, 0, 1, 3, 12.629999999999994],
                           [24, 24, 0, 1, 3, 12.589999999999993], [24, 21, 0, 2, 2, 10.309999999999999],
                           [24, 21, 0, 2, 2, 10.269999999999998]],
 'track_accuracy/track': [[24, 24, 0, 0, 12, 10.704980537471583], [24, 24, 0, 0, 12, 10.704980537471583],
                          [24, 24, 0, 0, 12, 10.704980537471583], [24, 24, 0, 0, 12, 10.704980537471583],
                          [24, 24, 0, 0, 12, 10.704980537471583], [24, 24, 0, 12, 12, 12.969495651167492]],
 'track_fixed/track': [[24, 24, 0, 0, 8, 9.266573691647721], [24, 24, 0, 0, 8, 9.266573691647721],
                       [24, 24, 0, 0, 8, 9.266573691647721], [24, 24, 0, 0, 8, 9.266573691647721],
                       [24, 24, 0, 0, 8, 9.266573691647721], [24, 24, 0, 8, 8, 11.226810434111659]]}

# The reference's numbers for every case of online_cases(), from its per-point
# run_online loop (tests/test_torch_online_goldens.py checks this table
# against ``repro``): per point [frames total, processed, missed, offloaded,
# planner calls, accuracy sum, rounds, estimated bps].
ONLINE_GOLDENS = {'max_accuracy/dead': [[45, 45, 0, 0, 8, 20.979999999999997, 8, 0.0]],
 'max_accuracy/fault': [[180, 177, 3, 30, 47, 88.17999999999986, 47, 1110015.0],
                        [180, 179, 1, 22, 42, 83.83999999999982, 42, 2218500.0]],
 'max_accuracy/lattice': [[90, 89, 1, 9, 25, 41.789999999999985, 25, 2421000.0],
                          [90, 89, 1, 9, 25, 41.78999999999999, 25, 2421000.0],
                          [90, 90, 0, 0, 23, 41.62999999999998, 23, 3150000.0],
                          [90, 90, 0, 0, 23, 41.62999999999998, 23, 3150000.0],
                          [90, 86, 4, 10, 23, 42.259999999999984, 23, 1303442.9999999995],
                          [90, 86, 4, 10, 23, 42.259999999999984, 23, 1303442.9999999995],
                          [90, 88, 2, 7, 20, 41.28999999999998, 20, 1910699.9999999995],
                          [90, 88, 2, 7, 20, 41.28999999999998, 20, 1910699.9999999995],
                          [90, 80, 10, 11, 24, 40.339999999999996, 24, 768049.0398548999],
                          [90, 78, 12, 10, 25, 39.63999999999999, 25, 753634.3278984299],
                          [90, 85, 5, 10, 21, 42.179999999999986, 21, 1128410.0999999996],
                          [90, 85, 5, 10, 21, 42.179999999999986, 21, 1128410.0999999996]],
 'max_accuracy/square': [[45, 41, 4, 10, 15, 21.499999999999996, 15, 1303442.9999999995],
                         [45, 43, 2, 7, 12, 20.639999999999997, 12, 1910699.9999999995]],
 'max_utility/fault': [[180, 143, 3, 15, 30, 73.31000000000006, 30, 1110015.0],
                       [180, 144, 1, 14, 30, 71.6100000000001, 30, 2218500.0]],
 'max_utility/lattice': [[90, 90, 0, 0, 23, 41.73999999999998, 23, 3150000.0],
                         [90, 78, 1, 2, 23, 37.56999999999998, 23, 2421000.0],
                         [90, 90, 0, 0, 23, 41.73999999999998, 23, 3150000.0],
                         [90, 76, 0, 0, 23, 36.769999999999975, 23, 3150000.0],
                         [90, 87, 3, 4, 15, 41.209999999999994, 15, 1553490.0],
                         [90, 69, 4, 5, 15, 35.419999999999995, 15, 1303443.0],
                         [90, 89, 1, 4, 15, 41.919999999999995, 15, 2421000.0],
                         [90, 70, 2, 4, 15, 35.12, 15, 1910699.9999999995],
                         [90, 87, 3, 4, 13, 41.31999999999998, 13, 1553490.0],
                         [90, 66, 8, 5, 13, 34.41, 13, 860084.6642999998],
                         [90, 87, 3, 4, 13, 41.31999999999998, 13, 1553490.0],
                         [90, 66, 5, 5, 13, 34.41, 13, 1128410.1]],
 'max_utility/square': [[45, 39, 3, 5, 8, 20.039999999999992, 8, 1553490.0],
                        [45, 40, 2, 4, 8, 19.73999999999999, 8, 1910699.9999999995]]}

# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs on an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import arch as A
    from repro_torch import configs, core, quant, scenariogen, serving, session
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.npu_matmul import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import common
    from repro_torch.serving.calibrate import _median_s

    t0 = time.perf_counter()
    smi = phase_environment(torch, build, [ops.SOURCE, flash_ops.SOURCE])
    agg, gemm_rows = phase_kernels(torch, A, configs, common, ops, ref)
    flash_rows = phase_flash(torch, flash_ops, flash_ref)
    torch.cuda.empty_cache()
    gemms, attns = set(), set()
    with recording(ops, "int8_matmul", gemm_key, gemms), recording(flash_ops, "flash_attention", flash_key, attns):
        full_launches, t_ms = phase_serve_full(torch, A, configs, common, quant, ops, flash_ops, ref, core, serving)
        torch.cuda.empty_cache()
        vit_int8, vit_flash = phase_vit_full(torch, A, configs, common, quant, ops, flash_ops, flash_ref, core,
                                             serving, _median_s)
        torch.cuda.empty_cache()
        serving_int8, serving_flash = phase_serving(torch, ops, flash_ops, serve, session)
    more_gemms, more_flash = phase_main_shapes(torch, ops, ref, flash_ops, flash_ref,
                                               gemms - gemm_rows.keys(), attns - flash_rows.keys())
    # The simulators run on profiles, not on models: no kernel launches.
    ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
    phase_sim(torch, core, session, scenariogen, t_ms, smi)
    sim_launches = (ops.int8_matmul.launches, flash_ops.flash_attention.launches)
    log(f"sim: kernel launches (int8_matmul, flash_attention) {sim_launches}")
    check(sim_launches == (0, 0), "the simulators launched a model kernel")
    torch.cuda.empty_cache()
    phase_sweep(torch, core, session, smi)
    sweep_launches = (ops.int8_matmul.launches, flash_ops.flash_attention.launches)
    log(f"sweep: kernel launches (int8_matmul, flash_attention) {sweep_launches}")
    check(sweep_launches == (0, 0), "the sweep engine launched a model kernel")
    for name, phase in (("online", lambda: phase_online(torch, core, session, scenariogen, smi)),
                        ("cache", lambda: phase_cache(torch, core, session, smi))):
        torch.cuda.empty_cache()
        ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
        phase()
        launches = (ops.int8_matmul.launches, flash_ops.flash_attention.launches)
        log(f"{name}: kernel launches (int8_matmul, flash_attention) {launches}")
        check(launches == (0, 0), f"the {name} phase launched a model kernel")
    wall = time.perf_counter() - t0

    int8_launches = full_launches + vit_int8 + serving_int8
    flash_launches = vit_flash + serving_flash
    log(f"kernels: [int8_matmul: {int8_launches} launches on the main path (serve_full {full_launches}, "
        f"vit_full {vit_int8}, serving {serving_int8}); flash_attention: {flash_launches} launches on the main "
        f"path (vit_full {vit_flash}, serving {serving_flash})]")
    # The flash entry is one frame's attention: the 12 calls of a batch-1
    # ViT-S/16 forward at 224², as the int8 entry sums a frame's GEMMs.
    n_layers = configs.get(VIT).cfg.n_layers
    vit1 = flash_rows[(1, *VIT_SHAPE)]
    log(f"flash per frame ({n_layers} calls at batch 1, (S, T, H, KH, hd, causal, dtype) = {VIT_SHAPE}): "
        + "  ".join(f"{k}={n_layers * vit1[k]:.4f}" for k in ("ms", "plain_ms", "library_ms", "call_ms", "bound_ms")))
    log(f"chip_smoke: all phases passed in {wall:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "int8_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": int8_launches,
        "max_abs_err": max(r["max_abs_err"] for r in (*gemm_rows.values(), *more_gemms.values())),
        "ms": agg["ms"],
        "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"],
        "bound_by": "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else "operations",
        "library_ms": agg["library_ms"],
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": flash_launches,
        "max_abs_err": max(r["max_abs_err"] for r in (*flash_rows.values(), *more_flash.values())),
        "ms": n_layers * vit1["ms"],
        "plain_ms": n_layers * vit1["plain_ms"],
        "bound_ms": n_layers * vit1["bound_ms"],
        "bound_by": vit1["bound_by"],
        "library_ms": n_layers * vit1["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
