#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. environment  card name and power limit, versions, TF32 off, and the
                  build of every CUDA kernel from the sources in this checkout
  2. kernels      int8_matmul against its plain version on the card at the
                  shapes of tests/test_kernels.py and at every GEMM shape one
                  forward of full-width ResNet-50 and SqueezeNet issues at
                  224², batch 1 and 8: bitwise equality, and kernel / plain /
                  library (torch._int_mm + epilogue) / bound times
  3. serve_full   full-width ResNet-50 and SqueezeNet (random weights from a
                  seed) behind VideoServer + OnlineController(max_accuracy) +
                  EdgeBatchServer over 60 frames at 224²
  4. serving      Session(spec, device="cuda").run_serving() on the default
                  spec of ``python -m repro_torch.launch.serve --frames 64``
  5. report       {"kernels": [...]} line, then the contract's last line

It needs one NVIDIA card and the CUDA toolkit (nvcc), and exits non-zero
without printing a result where ``torch.cuda.is_available()`` is False or
where the port's sources are missing.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
DEVICE = "cuda"
RES = 224  # frame and model input size of the full-width phases
N_CLASSES = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
KERNEL_SOURCE = "src/repro_torch/kernels/npu_matmul/csrc/int8_matmul.cu"
KERNEL_REPLACES = "src/repro/kernels/npu_matmul/kernel.py:74"
GEMMS_PER_FORWARD = {"resnet-50": 54, "squeezenet": 26}  # 53 convs + head; 25 convs + classifier conv
TEST_SHAPES = [  # tests/test_kernels.py:27, :56-58, :78
    (128, 512, 128), (256, 1024, 384), (64, 300, 100), (8, 128, 128), (1, 64, 1),
    (130, 70, 9), (130, 700, 129), (3, 33, 65), (257, 513, 127), (1, 96, 10),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# ---------------------------------------------------------------------------
# 1. environment
# ---------------------------------------------------------------------------


def phase_environment(torch, build, ops) -> None:
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
    logs = build.build_libraries([ops.SOURCE])
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"nvcc[{name}]: {line}")
    log(f"kernel build: {build_s:.2f} s ({len(logs)} source(s) compiled)")


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


def compare_shape(torch, ops, ref, M: int, K: int, N: int) -> dict:
    g = torch.Generator(device=DEVICE).manual_seed(M * 7919 + K * 31 + N)
    x = torch.randn(M, K, device=DEVICE, generator=g)
    w = torch.randn(K, N, device=DEVICE, generator=g)
    xq, xs = ref.quantize_rowwise(x)
    wq, ws = ref.quantize_colwise(w)
    out = ops.int8_matmul(xq, wq, xs, ws)
    plain = ref.int8_matmul_ref(xq, wq, xs, ws)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    equal = bool(torch.equal(out, plain))
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
    }


def phase_kernels(torch, A, configs, common, ops, ref) -> tuple[dict, float]:
    """Returns the per-frame sums over the batch-1 GEMMs and the largest
    kernel-vs-plain difference seen."""
    calls = {(name, b): record_gemms(torch, A, configs, common, name, b)
             for name in GEMMS_PER_FORWARD for b in (1, 8)}
    for (name, b), shapes in calls.items():
        check(len(shapes) == GEMMS_PER_FORWARD[name],
              f"{name} batch {b} issues {len(shapes)} GEMMs, expected {GEMMS_PER_FORWARD[name]}")
    distinct = list(dict.fromkeys(TEST_SHAPES + [s for shapes in calls.values() for s in shapes]))
    rows = {}
    log("device ms per call (CUDA graph) / per eager call (host launch included)")
    log(f"{'M':>7} {'K':>5} {'N':>5} {'kernel':>8} {'plain':>8} {'library':>9} {'bound':>8} {'by':>5} "
        f"{'k_call':>7} {'p_call':>7} {'l_call':>7} equal")
    for M, K, N in distinct:
        r = compare_shape(torch, ops, ref, M, K, N)
        rows[(M, K, N)] = r
        log(f"{M:>7} {K:>5} {N:>5} {r['ms']:>8.4f} {r['plain_ms']:>8.4f} {r['library_ms']:>8.4f}"
            f"{'*' if r['library_padded'] else ' '}{r['bound_ms']:>8.5f} {r['bound_by'][:5]:>5} "
            f"{r['call_ms']:>7.4f} {r['plain_call_ms']:>7.4f} {r['library_call_ms']:>7.4f} {r['equal']}")
    bad = [k for k, r in rows.items() if not r["equal"]]
    check(not bad, f"kernel and plain version differ at {bad}")
    log(f"kernels: {len(rows)} shapes bitwise equal to the plain version (tolerance: exact)  "
        "(* = library operands zero-padded to multiples of 16, M >= 32; weight stored [N, K])")
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
    return agg, max(r["max_abs_err"] for r in rows.values())


# ---------------------------------------------------------------------------
# 3. serve_full: full-width models behind the controller
# ---------------------------------------------------------------------------


def choose_bandwidth(core, n_frames: int) -> float:
    """The first constant bandwidth, from the paper's 2.5 Mbps up, at which
    max_accuracy over PAPER_MODELS plans both NPU and edge frames."""
    for mbps in (2.5, 3.0, 4.0, 5.0):
        c = core.OnlineController(models=core.PAPER_MODELS, stream=core.StreamSpec(), policy="max_accuracy",
                                  estimator=core.BandwidthEstimator(init_bps=mbps * 1e6))
        c.estimator.observe_rtt(0.1)
        head, where = 0, {"npu": 0, "server": 0}
        while head < n_frames:
            plan = c.next_plan(head)
            for d in plan.decisions:
                if head + d.frame < n_frames and d.is_processed():
                    where[d.where.value] += 1
            head += max(plan.horizon, 1)
        log(f"serve_full: planned mix at {mbps} Mbps: {where}")
        if where["npu"] and where["server"]:
            return mbps
    raise RuntimeError("no bandwidth in 2.5-5 Mbps mixes NPU and edge frames")


def phase_serve_full(torch, A, configs, common, quant, ops, ref, core, serving) -> int:
    """Returns the kernel launches of the 60-frame serving run."""
    n_frames = 60
    models = {}
    for name in GEMMS_PER_FORWARD:
        arch = configs.get(name)
        specs, state_specs = A.abstract_params(arch)
        params = common.init_tree(torch.Generator().manual_seed(SEED), specs, device=DEVICE)
        state = common.init_tree(torch.Generator().manual_seed(SEED + 1), state_specs, device=DEVICE)
        qparams, qstats = quant.npu_variant(params)

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

    # Per-frame latency of both variants at batch 1 and 8 (host clock, synced).
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
                log(f"serve_full: {name} {variant} batch {b}: {ms:.3f} ms per forward, {ms / b:.3f} ms per frame")

    mbps = choose_bandwidth(core, n_frames)
    stream = core.StreamSpec()
    names = list(GEMMS_PER_FORWARD)
    npu_eps = {
        j: serving.ModelEndpoint(f"{n}-npu", lambda x, m=models[n]: quant.npu_forward(m[0])(m[2], x),
                                 profile_latency_s=core.PAPER_MODELS[j].t_npu, device=DEVICE)
        for j, n in enumerate(names)
    }
    batched = {
        j: serving.BatchedEndpoint(f"{n}-edge", lambda x, m=models[n]: m[0](m[1], x),
                                   max_batch=16, device=DEVICE)
        for j, n in enumerate(names)
    }
    for ep in batched.values():
        ep.warmup(frames[0])
    controller = core.OnlineController(models=core.PAPER_MODELS, stream=stream, policy="max_accuracy",
                                       estimator=core.BandwidthEstimator(init_bps=mbps * 1e6))
    controller.estimator.observe_rtt(0.1)
    server = serving.VideoServer(controller=controller, npu_endpoints=npu_eps, stream=stream,
                                 trace=core.Trace.constant(mbps), edge_server=serving.EdgeBatchServer(batched),
                                 device=DEVICE)
    ops.int8_matmul.launches = 0
    summary = server.run(frames, labels)
    torch.cuda.synchronize()
    launches = ops.int8_matmul.launches
    npu_by_model = {n: sum(r.where == "npu" and r.model == n for r in server.results) for n in names}
    expected = sum(GEMMS_PER_FORWARD[n] * k for n, k in npu_by_model.items())
    log(f"serve_full: {mbps} Mbps summary {json.dumps({k: v for k, v in summary.items() if k != 'policy_spec'})}")
    log(f"serve_full: NPU frames by model {npu_by_model}; kernel launches {launches} (expected {expected})")
    check(summary["frames"] == n_frames, f"answered {summary['frames']} of {n_frames} frames")
    check(summary["npu_frames"] > 0 and summary["edge_frames"] > 0, "both NPU and edge paths must be used")
    check(launches == expected, f"kernel launches {launches} != {expected}")
    return launches


# ---------------------------------------------------------------------------
# 4. serving: the front door, calibration through the kernel
# ---------------------------------------------------------------------------


def phase_serving(torch, ops, serve, session) -> int:
    """Returns the kernel launches of ``Session.run_serving``."""
    spec, device = serve.build_spec(["--frames", "64"])
    check(device == DEVICE, f"launch.serve defaults to device {device!r}")
    ops.int8_matmul.launches = 0
    report = session.Session(spec, device=device).run_serving()
    torch.cuda.synchronize()
    launches = ops.int8_matmul.launches
    meta = report.meta
    log(f"serving: summary {json.dumps({k: v for k, v in meta.items() if k not in ('calibration', 'policy_spec')})}")
    for m in meta["calibration"]["models"]:
        prov = m["provenance"]
        log(f"serving: calibrated {m['name']}: t_npu {m['t_npu_ms']:.3f} ms t_server {m['t_server_ms']:.3f} ms "
            f"by batch npu {prov['t_npu_ms_by_batch']} edge {prov['t_server_ms_by_batch']} "
            f"kernel launches while timing {prov['kernel_launches_timed']} kernel {prov['kernel']!r}")
        check(prov["backend"] == "cuda" and prov["kernel"].endswith("int8_matmul.cu (cuda)"),
              f"provenance does not name the CUDA kernel: {prov}")
        check(prov["kernel_launches_timed"] > 0, f"{m['name']}: t_npu was not timed through the kernel")
    log(f"serving: kernel launches {launches}")
    check(meta["frames"] == 64, f"answered {meta['frames']} of 64 frames")
    check("deadline_met_frac" in meta, "summary lacks deadline_met_frac")
    check(launches > 0, "serving never launched the kernel")
    return launches


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
    from repro_torch import configs, core, quant, serving, session
    from repro_torch.kernels import build
    from repro_torch.kernels.npu_matmul import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import common

    t0 = time.perf_counter()
    phase_environment(torch, build, ops)
    agg, max_abs_err = phase_kernels(torch, A, configs, common, ops, ref)
    torch.cuda.empty_cache()
    full_launches = phase_serve_full(torch, A, configs, common, quant, ops, ref, core, serving)
    torch.cuda.empty_cache()
    serving_launches = phase_serving(torch, ops, serve, session)
    wall = time.perf_counter() - t0

    main_path_launches = full_launches + serving_launches
    log(f"kernels: [int8_matmul: {main_path_launches} launches on the main path "
        f"(serve_full {full_launches}, serving {serving_launches})]")
    log(f"chip_smoke: all phases passed in {wall:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "int8_matmul",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_path_launches,
        "max_abs_err": max_abs_err,
        "ms": agg["ms"],
        "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"],
        "bound_by": "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else "operations",
        "library_ms": agg["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
