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
                  forward of full-width ResNet-50, SqueezeNet and
                  EfficientNet-B7 issues at 224², batch 1 and 8 (B7: 219 a
                  forward, squeeze-excite pairs at M = batch with K and N
                  down to 8): bitwise equality, kernel / plain /
                  library (torch._int_mm + epilogue) / bound times, and the
                  launch each call made (row tile, K splits, blocks, load
                  path of each operand); then MISALIGNED operands, which must
                  take the narrow paths, bitwise; then the design over one
                  frame's GEMMs (ResNet-50 + SqueezeNet, and B7's beside)
  3. flash        flash_attention against its plain version on the card at
                  FLASH_SHAPES (tests/test_kernels.py's, ragged 17·n+3 sizes,
                  every bf16 head dim at batch 1 and 8, causal S > T, the
                  smoke ViT's and ViT-S/16's shapes, head dims 8 and 72 that
                  run zero-padded to the kernel's 16 and 128, the LMs'
                  prefill at 4096, the diffusion models' four attention
                  shapes) and LONG_FLASH_SHAPES (qwen3's prefill at
                  32768, its plain version in query-row chunks and untimed):
                  the reference's
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
 5b. zoo_full     full-width EfficientNet-B7 and Swin-B (random weights from
                  the seed; Swin's attention matrices at their own fan-in):
                  an NPU forward of each at batch 8 bitwise equal to the same
                  forward under the plain backend, B7 with 219 int8 launches,
                  Swin-B with none and no flash call; ms per frame of both
                  variants at batch 1 and 8; then 60 frames the same way as
                  serve_full on profiles of those times, launches = 219 x
                  B7's NPU frames
 5c. lm_full      the four decoder LMs through launch/steps.build_cell, every
                  config whole (LM_CASES; seed-0 bf16 weights drawn on the
                  card): causal prefill at batch 1 (qwen3 at prefill_32k's
                  32768 and at 4096, the others at 4096), one flash launch a
                  layer, the last-token logits against the same prefill under
                  the plain attention on f32-upcast q, k, v (an MoE's expert
                  picks pinned), with the bf16-score plain attention logged as
                  a control; 16 decode steps at decode_32k's cache length
                  (batch 4, lower where the weights are large) against the
                  kernel's prefill of the same tokens; qwen3's int8 cache
                  against its bf16 cache; prefill ms and tokens/s, decode ms a
                  step (median of passes after a warm one), flash launches,
                  peak memory
 5d. diffusion_full  DiT-XL/2 and Flux-dev through launch/steps.build_cell,
                  every config whole (seed-0 bf16 weights drawn on the card,
                  adaLN-Zero's zero leaves drawn), at gen_1024 (batch 4,
                  1024² images) and gen_fast (batch 16, 512²): the flash
                  kernel non-causal once an attention layer (28 and 57 a
                  forward), the prediction (DiT's eps, Flux's velocity)
                  against the same forward under the plain attention on
                  f32-upcast q, k, v, the bf16-score plain attention logged
                  as a control, two wrong paths (DiT causal, Flux's streams
                  attending alone) beyond the limit; ms a step, a gen_1024
                  step profiled, a 4-step gen_fast request served, peak
                  memory
 5e. train_full   the training kinds through launch/steps.build_cell with
                  AdamW and gradient accumulation (TRAIN_CASES: resnet-50,
                  dit-xl2 and qwen3-0.6b whole, deepseek-moe-16b at 2
                  layers, flux-dev at 2 + 2 blocks; seed-0 f32 weights on
                  the card): (a) 4 steps on one batch of the port's
                  SyntheticStream, the loss finite and falling, ms a step,
                  tokens or images a second, peak memory, a step of
                  qwen3-0.6b and dit-xl2 profiled; (b) 2 layers on a short
                  input, loss and every gradient on the card against the
                  host CPU in f32 and (but ResNet-50) in bf16, a wrong path
                  beyond each limit, Flux through blockwise_sdpa; (c) dit-xl2's
                  accum_steps 4 against 1 on the same batch; (d) restart
                  through launch.train.main on resnet-50 under
                  cudnn.deterministic; (e) no launch of either kernel
  6. serving      Session(spec, device="cuda").run_serving() on the default
                  spec of ``python -m repro_torch.launch.serve --frames 64``,
                  then on the same spec with models ({"name": "vit-s16"},
                  "squeezenet"), then with ({"name": "efficientnet-b7"},
                  {"name": "swin-b"})
  7. main shapes  each kernel against its plain version, untimed, at every
                  shape phases 4-6 gave it that phases 2-3 did not check
                  (the serving buckets, the front door's smoke models)
 7b. dryrun       launch/dryrun.run_cell at full size on the host CPU (the
                  step traced on meta) for DRYRUN_CELLS, each held against
                  the step diffusion_full or train_full measured on the card:
                  ms a step at or above the roofline's step_s_lower_bound,
                  and the estimated peak (flash_peak_per_device_gb for the
                  denoise steps, which launch the flash kernel, the plain
                  peak for training) within DRYRUN_PEAK_RTOL of the step's
                  own peak: torch.cuda.max_memory_allocated over one step
                  less what was resident beside its arguments; no kernel
                  launches
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
                  1000 points x 900 frames a policy, twice, every 40th point
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
 11. fleet        Session.run_sweep on fleet grids through the lane-batched
                  fleet engine (core/sim_multi_batch) on device="cuda" for
                  the seven batched_multi policies: sub-grids of
                  tests/test_sim_multi_batch.py's golden grids (all three
                  allocations, a piecewise shared link, capacity 0, a
                  backlog gate, weights and priorities) against
                  FLEET_GOLDENS, the reference's numbers; then the
                  multistream bench's widths, 60 frames: 1008 points
                  (bandwidth x deadline x n_clients 2/4/8 x allocation)
                  for offload and max_*, 216 for the others, each twice,
                  every 50th point against the per-point run_multi loop on
                  the card and against the engine on the host CPU; ms per
                  point, groups, rounds, host reads per round, drain
                  replays, peak card memory
 12. cache        the sweep phase's 10,000-point max_utility grid in chunks,
                  without the cache of captured lane programs
                  (core/sweep_shard), then with it twice, under
                  CompileCounter: captures, hits, wall seconds, the memory
                  the cached programs hold; results equal in every field
 13. mesh         MESH_RANKS ranks of the port (spawned processes, a gloo
                  group through a FileStore) sharing the card: (a) the sweep
                  goldens, an online and a fleet golden grid through
                  Session.run_sweep, each group's lanes spread over the
                  ranks (core/sweep_shard.run_sharded) and gathered: every
                  rank's results equal to the goldens and to phases 9-11's
                  one-rank results field for field; (b) the SWEEP_TRACE
                  half of MESH_LARGE's full-width grid (500 points x 900
                  frames) on the ranks, stats equal to the sweep phase's,
                  ms per point of each; (c) restore_resharded of
                  qwen3-0.6b's SMOKE train state, saved here, onto a (2, 2)
                  mesh under train_rules: every local shard the saved
                  array's slice; (d) MeshRules.constrain of a DTensor on the
                  card, Shard(0) -> Replicate, exact; no kernel launch
 14. report       wall seconds of every phase, the {"kernels": [...]} line
                  (both kernels: launches on the main path, 0 in train_full
                  and in phases 7b-13), then the contract's last line

Every main-path phase (serve_full, vit_full, zoo_full, lm_full, diffusion_full,
train_full, serving) sets both kernels' launch counts to 0 just before it runs and reads them just after;
while they run, every shape each kernel's wrapper is called at is recorded.

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
import os
import shutil
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
DIFF_FLASH_SHAPES = {  # diffusion_full's attention, non-causal at the published batches -> the model:
    # DiT-XL/2 (16 heads of 72, run zero-padded to 128) at gen_1024 (64² latent tokens) and
    # gen_fast (32²); Flux-dev (24 heads of 128) joint over 256 text and 4096 or 1024 image tokens
    (4, 4096, 4096, 16, 16, 72, False, "bfloat16"): "dit-xl2",
    (16, 1024, 1024, 16, 16, 72, False, "bfloat16"): "dit-xl2",
    (4, 4352, 4352, 24, 24, 128, False, "bfloat16"): "flux-dev",
    (16, 1280, 1280, 24, 24, 128, False, "bfloat16"): "flux-dev",
}
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
    # the LMs' causal prefill at S = 4096, batch 1 (lm_full): qwen3-0.6b (16 heads
    # over 8, G = 2), command-r-35b (64 over 8, G = 8), the MoEs (16 over 16, G = 1)
    (1, 4096, 4096, 16, 8, 128, True, "bfloat16"), (1, 4096, 4096, 64, 8, 128, True, "bfloat16"),
    (1, 4096, 4096, 16, 16, 128, True, "bfloat16"),
    *DIFF_FLASH_SHAPES,
]
FLASH_TOL = {"float32": (1e-4, 2e-5), "bfloat16": (0.05, 0.02)}  # (rtol, atol): tests/test_kernels.py's
VIT_LOGIT_RTOL = 0.02  # max|kernel - plain attention| over max|logit| of the full-width ViT forward
PLAIN_SCORES = 1 << 28  # score elements of one plain-attention call; longer queries run in row chunks
PLAIN_TIMED_SCORES = 1 << 30  # the plain version is timed (one call, all its scores held) up to this many
# lm_full: the four decoder LMs at full config through launch/steps.build_cell,
# seed-0 weights drawn on the card in bf16.  (name, prefill lengths at batch 1,
# decode batch, int8-cache check).  Cuts: prefill_32k's batch 32 -> 1 (its cache
# for 32 would be 120 GB); decode_32k's batch 128 -> 4 (its 32768-slot cache is
# 3.8 GB a sequence for qwen3-0.6b, 7.5 for deepseek-moe-16b, 6.4 for
# qwen2-moe-a2.7b), and command-r-35b's to 2: its 64.8 GB of weights and 5.4 GB
# of cache a sequence put batch 4 at 86.3 GB, above the card's 85.0.
LM_LONG = 32768  # prefill_32k's length
LM_PREFILL = 4096
LM_DECODE_LEN = 32768  # decode_32k's cache length
LM_DECODE_STEPS = 16
LM_DECODE_REPEATS = 3  # timed decode passes, after the checked one
LM_CASES = (
    ("qwen3-0.6b", (LM_LONG, LM_PREFILL), 4, True),
    ("deepseek-moe-16b", (LM_PREFILL,), 4, False),
    ("command-r-35b", (LM_PREFILL,), 2, False),
    ("qwen2-moe-a2.7b", (LM_PREFILL,), 4, False),
)
LONG_FLASH_SHAPES = [(1, LM_LONG, LM_LONG, 16, 8, 128, True, "bfloat16")]  # qwen3-0.6b's prefill_32k
# Last-token logits, max|difference| over max|logit|, at full width with random
# bf16 weights: the kernel's prefill against the plain attention on f32-upcast
# q, k, v (which computes scores as the kernel does, in f32 from bf16 inputs),
# and decode (the reference's masked _sdpa, bf16 scores) against the kernel's
# prefill of the same tokens.  A fixed limit: on the card (NVIDIA H100 80GB
# HBM3, 700 W) the sound prefills read 1.43-2.62% (the bf16-score plain
# attention, as a control, 1.50-3.05%) and the sound decodes 1.55-2.37%, where
# LM_CONTROL's wrong paths read 131% (a non-causal prefill) and 105% (a decode
# whose token does not see itself); PERF.md §6.
LM_LOGIT_RTOL = 0.02  # the smoke configs on the card (tests/test_torch_cuda.py)
LM_FULL_RTOL = 0.04
LM_CONTROL = "qwen3-0.6b"  # lm_full also runs those two wrong paths of this model and holds them beyond the limit
TOP1_TIE_ULPS = 2  # compare_logits: another top-1 only where it scores this close to the reference's top (or,
# in decode, within twice the noise between two sound computations of the same logits)
LM_INT8_REL = 0.05  # ||int8-cache logits - bf16-cache logits|| / ||bf16-cache logits|| (tests/test_models.py:183)
# diffusion_full: DiT-XL/2 and Flux-dev at their published configs through
# launch/steps.build_cell, every layer, seed-0 bf16 weights drawn on the card
# (attention matrices at their own fan-in, adaLN-Zero's zero leaves drawn:
# draw_zero_leaves), at both denoise_step shapes and their published batches.
# The prediction (DiT's eps channels, Flux's velocity), max|difference| over
# max|prediction|, is held against the same forward under the plain attention
# on f32-upcast q, k, v; a fixed limit, DIFF_RTOL.  The wrong paths (DiT
# causal; Flux's image tokens blind to the text tokens, each stream attending
# alone) must lie beyond it.  On the card (NVIDIA H100 80GB HBM3, 700 W) the
# sound predictions read 1.05-1.15% (the bf16-score plain attention, as a
# control, 1.09-1.26%), the wrong paths 27.9% (DiT) and 29.6% (Flux); PERF.md §6.
DIFF_MODELS = ("dit-xl2", "flux-dev")
DIFF_SHAPES = ("gen_1024", "gen_fast")
DIFF_REQUEST = "gen_fast"  # served whole: its `steps` (4) denoising steps from standard normal latents
DIFF_T0 = 0.98  # the request's first t, going down in equal steps to 0 (DiT divides by cos(pi t / 2))
DIFF_RTOL = 0.03
# train_full: the three training kinds through launch/steps.build_cell, seed-0
# f32 weights drawn on the card (attention matrices at their own fan-in, the
# diffusion models' zero-init leaves drawn), train state 16 bytes a parameter
# with its gradients.  (name, shape, depth cut, global batch, accum_steps):
# the cuts fixed before the first run (PERF.md §4): the three that fit run
# whole, deepseek-moe-16b at 2 of its 28 layers, flux-dev at 2 + 2 of its
# 19 + 38 blocks; train_4k's batch 256 -> 8 (qwen3) and 4 (deepseek) and
# train_1024's 32 -> 4, each at microbatch 1 (accum_steps = batch).  The
# last entry is the lr: 1e-3, fixed before the first run, except for the
# diffusion models, where it made DiT-XL/2's loss climb by its 4th step
# (1.0016 -> 1.1632 from the published init; PERF.md §6): 1e-4 there, DiT's
# published lr (arXiv:2212.09748 §4).
TRAIN_CASES = (
    ("resnet-50", "cls_224", None, 256, 1, 1e-3),
    ("dit-xl2", "train_256", None, 256, 1, 1e-4),
    ("qwen3-0.6b", "train_4k", None, 8, 8, 1e-3),
    ("deepseek-moe-16b", "train_4k", 2, 4, 4, 1e-3),
    ("flux-dev", "train_1024", (2, 2), 4, 4, 1e-4),
)
TRAIN_ADAMW = {"warmup_steps": 1, "total_steps": 100}
TRAIN_STEPS = 4  # (a): on one repeated batch; the 4th loss below the 1st (tests/test_models.py:77-87)
TRAIN_PROFILED = ("qwen3-0.6b", "dit-xl2")
# (b): each case's first microbatch at 2 layers (Flux: 1 double + 1 single
# block) on the card and on the host CPU: an LM at seq TRAIN_CHECK_SEQ, Flux
# at TRAIN_CHECK_IMG² (512 tokens with its 256 text tokens), the others at
# batch 2 at the case's resolution, with the model modules in f32 (in_f32).
# Flux trains above layers.BLOCKWISE_THRESHOLD (4352 tokens), so its check
# takes the same differentiated blockwise_sdpa: the threshold is lowered to
# 0 and the blocks to TRAIN_CHECK_BLOCKS (4 query blocks by 2 key blocks at
# 512 tokens).
# Loss: |card - CPU| / |CPU|; gradients: ||card - CPU|| / ||CPU|| over every
# leaf at once (a leaf whose exact gradient is zero, such as a key bias's,
# reads noise on both sides).  Fixed limits, from readings on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md §6): sound losses read 0-2.2e-6 and gradients
# 6.5e-7-1.2e-5, where the wrong paths read 1.2e-3-1.56 and 0.065-0.79.
# ResNet-50 is apart: its f32 gradient at batch 2 is chaotic (BatchNorm's
# backward cancels most of its input gradient, layer after layer), so two
# correct runs lie 1.3-2.1% apart even in f64 (CPU f32 against CPU f64
# 1.90%, card f64 against CPU f64 1.35%) and its limit is
# TRAIN_GRAD_RTOL_BN, against 181% for its wrong path.  In bf16, as the
# models run, the LMs, DiT and Flux are held too, at TRAIN_BF16_LOSS_RTOL and
# TRAIN_BF16_GRAD_RTOL: sound readings 7.4e-6-1.1e-3 and 0.15-1.9% (MoE
# routing flips the most), the wrong paths' gradients 9-79% in f32.  The
# loss limit does not separate qwen3's shifted labels (1.4e-3: on random
# weights the CE barely depends on the label), so the wrong path must pass
# the gradient limit.  ResNet-50's bf16 distance is logged only: 111%,
# against 159% for its wrong path.
TRAIN_CHECK_SEQ = 512
TRAIN_CHECK_IMG = 256
TRAIN_CHECK_BATCH = 2
TRAIN_CHECK_BLOCKS = {"q_block": 128, "kv_block": 256}
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-4
TRAIN_GRAD_RTOL_BN = 0.1
TRAIN_BF16_LOSS_RTOL = 5e-3
TRAIN_BF16_GRAD_RTOL = 5e-2
# (c): accum_steps TRAIN_ACCUM against 1 on the same batch, dit-xl2 at
# train_256, with tests/test_substrate.py:257-280's bounds (loss rel 1e-5,
# grad_norm rel 5e-2, params within 2.5 lr); the wrong path averages only the
# first TRAIN_ACCUM - 1 microbatches.
TRAIN_ACCUM = 4
TRAIN_ACCUM_LOSS_RTOL = 1e-5
# (d): restart through launch.train.main on resnet-50 at cls_224 under
# cudnn.deterministic: TRAIN_RESTART_STEPS straight against half, an async
# checkpoint, --resume and the rest; the last loss within rel 1e-4
# (tests/test_substrate.py:100-114).
TRAIN_RESTART = ("resnet-50", "cls_224")
TRAIN_RESTART_STEPS = 4
TRAIN_CKPT = ROOT / "build" / "train_full_ckpt"  # (d)'s checkpoints, removed after
# 7b. dryrun: the cells chip_smoke already runs at their published shapes with
# nothing cut (train_full's two whole cases, diffusion_full's four), each
# traced at full size on meta and held against a step measured on the card.
# The peak limit was written into PERF.md before the first card run: the
# trace counts every storage, but the card adds what it cannot see (the
# caching allocator's 512-byte rounding, cuBLAS and cuDNN workspaces, the
# flash wrapper's zero-padded head dim, DiT's 72 -> 128).  What the process
# holds beside the step's arguments when the step begins (earlier phases'
# cached tensors: 1.1-1.4 GB in a whole run) is not the step's and is taken
# off the card's peak (PERF.md §6).
DRYRUN_CELLS = (("resnet-50", "cls_224"), ("dit-xl2", "train_256"), ("dit-xl2", "gen_1024"),
                ("dit-xl2", "gen_fast"), ("flux-dev", "gen_1024"), ("flux-dev", "gen_fast"))
DRYRUN_PEAK_RTOL = 0.2
GEMMS_PER_FORWARD = {"resnet-50": 54, "squeezenet": 26}  # 53 convs + head; 25 convs + classifier conv
B7, SWIN = "efficientnet-b7", "swin-b"  # zoo_full's classifiers
# stem + 3 for each of stage 0's four expand-1 blocks + 4 (expand, SE pair,
# project) for each of the other 51 blocks + head conv + head; Swin's matmuls
# never reach models.common.matmul
ZOO_GEMMS = {B7: 219, SWIN: 0}
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
CPU_CHECK_EVERY = 40  # the host CPU re-runs every 40th full-width point: 25 a policy
CHUNK_POINTS, CHUNK_SIZE = 10_000, 2500  # max_utility at 24 frames, chunked against unchunked
PROFILE_FRAMES = 300  # the profiled group's stream (eager rounds take ~20 ms each)
REFERENCE_GRIDS = {  # the per-point loop (backend="reference") on the card: 10 and 100 points
    10: {"bandwidth_mbps": [1.0, 3.0], "deadline_ms": SWEEP_DL, "fps": [30.0]},
    100: {"bandwidth_mbps": SWEEP_BW, "deadline_ms": SWEEP_DL, "fps": [24.0, 30.0]},
}
# Policies whose per-point loop runs at 10 points only: the jax_* planners take
# 0.6-1.9 s a point on the card (phase 8).
LOOP_AT_10_ONLY = ("jax_accuracy", "jax_utility")

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

# The fleet phase: Session.run_sweep on fleet grids through the lane-batched
# fleet engine (core/sim_multi_batch), held against the reference's numbers
# (FLEET_GOLDENS; tests/test_torch_fleet_goldens.py holds the table against
# the reference package), then at the multistream bench's widths against the
# per-point run_multi loop on the card and against itself on the host CPU.
# Base params of each batched_multi policy (tests/test_sim_multi_batch.py:
# 192-198; max_* at the bench's 10 ms grid at full width, FLEET_WIDE_PARAMS):
FLEET_PARAMS = {
    "offload": {}, "max_accuracy": {}, "max_utility": {"alpha": 150.0}, "jax_accuracy": {},
    "jax_utility": {"alpha": 150.0}, "track_accuracy": {"k_max": 5}, "track_fixed": {"k": 3},
}
FLEET_GOLD_FRAMES = 16  # tests/test_sim_multi_batch.py:36
FLEET_PIECEWISE = [[0.0, 6.0], [0.2, 1.5], [0.35, 9.0]]  # tests/test_sim_multi_batch.py:371, :400
ALLOCATIONS3 = ["weighted_fair", "priority", "fifo"]
# benchmarks/multistream_bench.py:44-58, 140-163: 60 frames, bandwidth x
# deadline x n_clients x allocation.  1000 is no multiple of the 3 x 3 fleet
# sizes and allocations, so 14 bandwidths x 8 deadlines x 9 = 1008 points;
# the deadlines span three window buckets (W = 5, 6, 7 at 30 fps).
FLEET_FRAMES = 60
FLEET_GRID = {"bandwidth_mbps": [1.0 + 0.5 * i for i in range(14)],
              "deadline_ms": [180.0, 190.0, 200.0, 210.0, 220.0, 230.0, 240.0, 250.0],
              "n_clients": [2, 4, 8], "allocation": ALLOCATIONS3}
FLEET_SMALL_GRID = {**FLEET_GRID, "bandwidth_mbps": [1.0, 2.5, 4.0, 6.0, 9.0, 12.0],  # 216 points
                    "deadline_ms": [180.0, 200.0, 220.0, 240.0]}
FLEET_WIDE = ("offload", "max_accuracy", "max_utility")  # 1008 points; the others at 216; each twice
FLEET_WIDE_PARAMS = {"max_accuracy": {"grid": 10e-3}, "max_utility": {"alpha": 150.0}}  # the bench's grid
FLEET_BASE = {"trace": {"kind": "constant", "mbps": 6.0}, "fleet": {"n_clients": 2, "capacity": 4}}
FLEET_SAMPLE_EVERY = 50  # every 50th full-width point against the loop and the host CPU

# The mesh phase: MESH_RANKS ranks of the port, each its own spawned process
# on cuda:{rank % device_count} (all of them on the one card here), joined
# in a gloo group through a FileStore.  Each runs (a) the sweep phase's
# golden grids, MESH_ONLINE's online golden grid and MESH_FLEET's fleet
# golden grid, (b) the SWEEP_TRACE half of MESH_LARGE's full-width grid
# (full_grids' second: 500 points over the whole stream, every segment of the
# trace), (c) restore_resharded of MESH_CKPT's SMOKE train state onto a
# (2, 2) mesh under train_rules and (d) a constrain round trip of a DTensor
# on the card; the results must equal the earlier phases' one-rank results
# (ONE_RANK) and the goldens.  The ranks must end within MESH_TIMEOUT.
MESH_RANKS = 4
MESH_TIMEOUT = 120  # seconds for the ranks, start to end: the phase's budget
MESH_ONLINE = "max_utility/lattice"
MESH_FLEET = "max_accuracy/planner"
MESH_LARGE = "max_utility"
MESH_CKPT = ("qwen3-0.6b", "train_4k")
ONE_RANK: dict = {}  # filled by the sweep, online and fleet phases


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def own_fan_in(params, cfg):
    """Give a ViT's or a Swin's stacked attention matrices their own fan-in,
    in place, and return ``params``.  The reference's init rule reads the
    fan-in of ``wq [L, d, H, hd]`` as H (``shape[-2]``), so its random q and
    k come out ~sqrt(d / H) too large (8x for ViT-S/16, 5.7x for Swin-B),
    the logits spread widely and the softmax is near one-hot: one bf16 ulp
    in a rounded logit then flips which token a head attends to, and a few
    blocks of that make two correct bf16 forwards that sum in different
    orders disagree by more than the logits' scale.  Scaling wq/wk/wv by
    sqrt(H / d) and wo by 1 / sqrt(H) gives each its true fan-in (d, and
    H·hd).  A Swin has one stack of blocks per stage, each at its own width;
    Flux has three (the double blocks' image and text streams, the single
    blocks); the LMs and DiT one.  Works on torch and numpy leaves alike."""
    if hasattr(cfg, "dims"):  # Swin
        stacks = [(params[f"stage{i}"]["blocks"]["attn"], d, h)
                  for i, (d, h) in enumerate(zip(cfg.dims, cfg.n_heads))]
    elif hasattr(cfg, "n_double"):  # Flux
        stacks = [(attn, cfg.d_model, cfg.n_heads) for attn in (
            params["double"]["img"]["attn"], params["double"]["txt"]["attn"], params["single"]["attn"])]
    else:
        stacks = [(params["blocks"]["attn"], cfg.d_model, cfg.n_heads)]
    for attn, d, heads in stacks:
        for name in ("wq", "wk", "wv"):
            attn[name] = attn[name] * math.sqrt(heads / d)
        attn["wo"] = attn["wo"] / math.sqrt(heads)
    return params


def draw_zero_leaves(common, params, specs, gen):
    """Draw, in place, every leaf whose spec initializes it to zeros as a
    fan-in normal (``common.init_param`` under ``init="normal"``, the
    spec's dtype), and return ``params``.  The diffusion models are
    adaLN-Zero: their modulation (``adaln``, ``mod``) and output projection
    (``final.proj``) start at zero, so on seed weights ``dit_forward`` and
    ``flux_forward`` return exactly 0 whatever the attention computes, and
    a sample step returns a rescaled ``x_t``: a comparison of two attentions
    on those weights could not fail.  The zero biases are drawn too, so no
    leaf is left at its constant."""
    for key, s in specs.items():
        if isinstance(s, dict):
            draw_zero_leaves(common, params[key], s, gen)
        elif s.init == "zeros":
            params[key] = common.init_param(gen, dataclasses.replace(s, init="normal"), params[key].device)
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


def flash_key(q, k, v, *, causal, sm_scale=None) -> tuple:
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


def phase_kernels(torch, A, configs, common, ops, ref) -> tuple[dict, dict, dict]:
    """Returns the per-frame sums over the batch-1 GEMMs of ResNet-50 and
    SqueezeNet, the rows by shape, and the per-frame sums over
    EfficientNet-B7's."""
    n_gemms = {**GEMMS_PER_FORWARD, B7: ZOO_GEMMS[B7]}
    calls = {(name, b): record_gemms(torch, A, configs, common, name, b) for name in n_gemms for b in (1, 8)}
    for (name, b), shapes in calls.items():
        check(len(shapes) == n_gemms[name], f"{name} batch {b} issues {len(shapes)} GEMMs, expected {n_gemms[name]}")
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
    # forward of each full-width model, summed call by call; the kernels line
    # keeps the frame of ResNet-50 + SqueezeNet, B7's frame is logged beside.
    timed = ("ms", "plain_ms", "library_ms", "call_ms", "plain_call_ms", "library_call_ms", "bound_ms")
    agg = dict.fromkeys(timed + ("bytes_ms", "ops_ms"), 0.0)
    per_model = {}
    for name in n_gemms:
        per_model[name] = dict.fromkeys(agg, 0.0)
        for M, K, N in calls[(name, 1)]:
            r = rows[(M, K, N)]
            b_bytes, b_ops = bound(M, K, N)
            for key, v in [(k, r[k]) for k in timed] + [("bytes_ms", b_bytes), ("ops_ms", b_ops)]:
                per_model[name][key] += v
                if name in GEMMS_PER_FORWARD:
                    agg[key] += v
        log(f"per-frame GEMMs {name} (batch 1, {n_gemms[name]} calls): "
            + "  ".join(f"{k}={v:.4f}" for k, v in per_model[name].items()))
    for names in (tuple(GEMMS_PER_FORWARD), (B7,)):
        frame = [rows[s] for name in names for s in calls[(name, 1)]]
        blocks = sorted(r["blocks"] for r in frame)
        log(f"int8_matmul design over one frame's {len(frame)} GEMMs ({' + '.join(names)}): blocks per call min "
            f"{blocks[0]} median {blocks[len(blocks) // 2]} max {blocks[-1]}; split-K on "
            f"{sum(r['splits'] > 1 for r in frame)} calls; row tiles {dict(collections.Counter(r['tile'] for r in frame))}; "
            f"paths {dict(collections.Counter(r['path'] for r in frame))}")
    for M, K, N in PATH_SHAPES:
        r = rows[(M, K, N)]
        log(f"int8_matmul design at {M}x{K}x{N}: tile {r['tile']}x{ops.BN}, {r['splits']} splits of "
            f"{ops.k_per_split(K, r['splits'])} steps of {ops.BK} bytes, {r['blocks']} blocks, path {r['path']}")
    return agg, rows, per_model[B7]


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


def plain_sdpa(torch, flash_ref, q, k, v, *, causal: bool):
    """``flash_ref.sdpa_ref``, a run of query rows at a time so that no call
    holds more than ``PLAIN_SCORES`` scores (one call at S = T = 32768 would
    hold 16 x 32768² f32 scores, 68 GB).  A causal chunk of rows [i, j) takes
    the keys up to ``j + T - S``, so the bottom-right aligned mask of each
    call is the whole problem's.  Causal S > T (rows with no key) stays one
    call."""
    B, S, H, _ = q.shape
    T = k.shape[1]
    rows = max(1, PLAIN_SCORES // (B * H * T))
    if rows >= S or (causal and S > T):
        return flash_ref.sdpa_ref(q, k, v, causal=causal)
    out = []
    for i in range(0, S, rows):
        j = min(S, i + rows)
        t = j + T - S if causal else T
        out.append(flash_ref.sdpa_ref(q[:, i:j], k[:, :t], v[:, :t], causal=causal))
    return torch.cat(out, dim=1)


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
    plain = plain_sdpa(torch, flash_ref, q.float(), k.float(), v.float(), causal=causal)
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
    plain_timed = B * H * S * T <= PLAIN_TIMED_SCORES
    return {
        "ok": ok, "max_abs_err": float(diff.max()),
        "library_err": float((library().float() - plain).abs().max()),
        "ms": graph_ms(torch, kernel), "plain_ms": graph_ms(torch, plain_fn) if plain_timed else None,
        "library_ms": graph_ms(torch, library),
        "call_ms": cuda_ms(torch, kernel),
        "bound_ms": max(b_bytes, b_ops), "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        **design,
    }


def phase_flash(torch, flash_ops, flash_ref) -> dict:
    """Returns the rows by shape.  The plain version is timed only up to
    PLAIN_TIMED_SCORES scores (LONG_FLASH_SHAPES' would be 68 GB)."""
    rows = {}
    log("flash_attention: device ms per call (CUDA graph); k_call = per eager call (host launch included)")
    log(f"{'B':>2} {'S':>4} {'T':>4} {'H':>3} {'KH':>3} {'hd':>4} {'causal':>6} {'dtype':>8} {'kernel':>8} "
        f"{'plain':>8} {'library':>8} {'bound':>9} {'by':>5} {'k_call':>7} {'max_err':>9} {'lib_err':>9} "
        f"{'blocks':>6} path width ok")
    for shape in FLASH_SHAPES + LONG_FLASH_SHAPES:
        r = compare_flash(torch, flash_ops, flash_ref, shape)
        rows[shape] = r
        B, S, T, H, KH, hd, causal, dt = shape
        plain = "-" if r["plain_ms"] is None else f"{r['plain_ms']:.4f}"
        log(f"{B:>2} {S:>4} {T:>4} {H:>3} {KH:>3} {hd:>4} {str(causal):>6} {dt:>8} {r['ms']:>8.4f} "
            f"{plain:>8} {r['library_ms']:>8.4f} {r['bound_ms']:>9.6f} {r['bound_by'][:5]:>5} "
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


def choose_bandwidth(core, models, n_frames: int, npu_model: int | None = None) -> float:
    """The first constant bandwidth, from the paper's 2.5 Mbps up, at which
    max_accuracy over ``models`` plans both NPU and edge frames (and, where
    ``npu_model`` is given, NPU frames on that model)."""
    rates = (2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0)
    for mbps in rates:
        c = core.OnlineController(models=models, stream=core.StreamSpec(), policy="max_accuracy",
                                  estimator=core.BandwidthEstimator(init_bps=mbps * 1e6))
        c.estimator.observe_rtt(0.1)
        head, where, on_model = 0, {"npu": 0, "server": 0}, collections.Counter()
        while head < n_frames:
            plan = c.next_plan(head)
            for d in plan.decisions:
                if head + d.frame < n_frames and d.is_processed():
                    where[d.where.value] += 1
                    on_model[(d.where.value, models[d.model].name)] += 1
            head += max(plan.horizon, 1)
        log(f"planned mix of {[m.name for m in models]} at {mbps} Mbps: {where}, by model {dict(on_model)}")
        if where["npu"] and where["server"] and (npu_model is None or on_model[("npu", models[npu_model].name)]):
            return mbps
    raise RuntimeError(f"no bandwidth in {rates} Mbps mixes NPU and edge frames"
                       + (f" with NPU frames on {models[npu_model].name}" if npu_model is not None else ""))


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
# 5b. zoo_full: full-width EfficientNet-B7 and Swin-B behind the controller
# ---------------------------------------------------------------------------


def phase_zoo_full(torch, A, configs, common, quant, ops, flash_ops, ref, core, serving, median_s):
    """EfficientNet-B7 (219 int8 GEMMs a forward) and Swin-B (none, and no
    flash call: its window attention is inline) at full width and 224²:
    an NPU forward of each at batch 8 against the same forward under the
    plain backend, bitwise; ms per frame of both variants at batch 1 and 8;
    then 60 frames through VideoServer + OnlineController(max_accuracy) +
    EdgeBatchServer on profiles of the card-measured batch-1 times.  Returns
    (int8 launches, flash launches) of the serving run.  Weights are random
    from the seed; Swin-B's attention matrices at their own fan-in
    (``own_fan_in``), since its forwards are compared."""
    n_frames = 60
    frames, labels = serving.make_synthetic_video(n_frames, res=RES, seed=SEED)
    probe = torch.as_tensor(frames[:8], device=DEVICE)
    fns = {}
    for name in (B7, SWIN):
        arch = configs.get(name)
        specs, state_specs = A.abstract_params(arch)
        params = common.init_tree(torch.Generator().manual_seed(SEED), specs, device=DEVICE)
        state = common.init_tree(torch.Generator().manual_seed(SEED + 1), state_specs, device=DEVICE)
        if name == SWIN:
            own_fan_in(params, arch.cfg)
        qparams, qstats = quant.npu_variant(params, specs)

        def forward(p, x, _arch=arch, _state=state):
            return A.classifier_forward(_arch, p, _state, x, train=False)[0]

        npu = quant.npu_forward(forward)
        fns[name] = (lambda x, f=npu, p=qparams: f(p, x), lambda x, f=forward, p=params: f(p, x))
        log(f"zoo_full: {name} {A.n_params(arch)} params (seed {SEED}), quantized leaves {qstats.leaves_quantized}, "
            f"kept {qstats.leaves_kept}, mean rel err {qstats.mean_rel_err:.5f}")

        ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
        kern = npu(qparams, probe)
        torch.cuda.synchronize()
        launches = (ops.int8_matmul.launches, flash_ops.flash_attention.launches)
        check(launches == (ZOO_GEMMS[name], 0), f"{name} NPU forward launched (int8, flash) {launches}, "
              f"expected ({ZOO_GEMMS[name]}, 0)")
        with common.matmul_backend(ref.npu_matmul_ref), torch.no_grad():
            plain = forward(qparams, probe)
        with torch.no_grad():
            edge = forward(params, probe)
        check(bool(torch.isfinite(kern).all()) and kern.shape == (8, N_CLASSES), f"{name} NPU logits malformed")
        check(bool(torch.isfinite(edge).all()) and edge.shape == (8, N_CLASSES), f"{name} edge logits malformed")
        check(torch.equal(kern, plain), f"{name} NPU logits through the kernel differ from the plain backend "
              f"(max abs {float((kern - plain).abs().max())})")
        agree = int((kern.argmax(-1) == edge.argmax(-1)).sum())
        log(f"zoo_full: {name} NPU forward at {RES}x{RES} batch 8: (int8, flash) launches {launches}, logits "
            f"bit-equal to the plain backend, |logit| max {float(kern.abs().max()):.4g}; NPU and edge top-1 equal "
            f"on {agree}/8 frames, max|NPU - edge| {float((kern - edge).abs().max()):.4g}")

    # Per-frame times of both variants at batch 1 and 8 (host clock, synced),
    # the batch-1 medians being the profiles' t_npu / t_server.
    t_ms = {}
    for name, (npu, edge) in fns.items():
        for b in (1, 8):
            x = torch.as_tensor(frames[:b], device=DEVICE)
            for variant, fn in (("npu", npu), ("edge", edge)):
                with torch.no_grad():
                    ms = median_s(lambda: fn(x).cpu(), warmup=2, repeats=7) * 1e3
                t_ms[(name, variant, b)] = ms
                log(f"zoo_full: {name} {variant} batch {b}: {ms:.3f} ms per forward, {ms / b:.3f} ms per frame")
    # Random weights have no accuracy of their own: B7 takes core.profiles'
    # RESNET50 tables (the accurate model) and Swin-B SQUEEZENET's (the fast
    # one), so that max_accuracy mixes them as the paper's pair.
    models = tuple(core.profile_ms(name, t_npu_ms=t_ms[(name, "npu", 1)], t_server_ms=t_ms[(name, "edge", 1)],
                                   acc_server=tables.acc_server, acc_npu=tables.acc_npu)
                   for name, tables in ((B7, core.RESNET50), (SWIN, core.SQUEEZENET)))
    log("zoo_full: profiles " + ", ".join(f"{m.name} t_npu {m.t_npu * 1e3:.3f} ms t_server {m.t_server * 1e3:.3f} ms"
                                          for m in models) + " (measured above); accuracy tables RESNET50's for "
        f"{B7}, SQUEEZENET's for {SWIN}")
    mbps = choose_bandwidth(core, models, n_frames, npu_model=0)
    server, summary, int8, flash = serve_frames(
        torch, core, serving, ops, flash_ops, models, [fns[B7][0], fns[SWIN][0]], [fns[B7][1], fns[SWIN][1]],
        frames, labels, mbps)
    npu_by_model = {m.name: sum(r.where == "npu" and r.model == m.name for r in server.results) for m in models}
    b7_calls = server.npu[0].stats.calls
    log(f"zoo_full: {mbps} Mbps summary {json.dumps({k: v for k, v in summary.items() if k != 'policy_spec'})}")
    log(f"zoo_full: NPU frames by model {npu_by_model}, {B7} NPU forwards {b7_calls}; int8 launches {int8} "
        f"(expected {ZOO_GEMMS[B7]} x {b7_calls}), flash launches {flash}")
    check(summary["frames"] == n_frames, f"answered {summary['frames']} of {n_frames} frames")
    check(summary["npu_frames"] > 0 and summary["edge_frames"] > 0, "both NPU and edge paths must be used")
    check(npu_by_model[B7] > 0 and b7_calls == npu_by_model[B7], f"{B7} NPU frames {npu_by_model}, calls {b7_calls}")
    check(int8 == ZOO_GEMMS[B7] * b7_calls and flash == 0, f"int8 launches {int8}, flash launches {flash}")
    return int8, flash


# ---------------------------------------------------------------------------
# 5c. lm_full: the decoder LMs' prefill and decode at full width
# ---------------------------------------------------------------------------


def distance(got, want) -> dict:
    """max|got - want| (``err``), max|want| (``scale``) and their ratio
    (``rel``)."""
    err, scale = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    return {"rel": err / scale, "err": err, "scale": scale}


def compare_logits(got, want, noise: float = 0.0) -> dict:
    """``distance(got, want)``, and top-1 over the rows of [..., V] logits:
    ``same`` rows pick the same token; ``top1_ok`` holds where every other
    row's pick is a tie, the token ``got`` picks scoring in ``want`` at most
    a band below ``want``'s top: TOP1_TIE_ULPS bf16 ulps (ulps at the top
    logit), or 2 x ``noise`` where that is wider.  ``noise`` is
    max|difference| between two sound computations of the same logits,
    measured apart from ``got`` (two logits that each move by ``noise`` can
    swap only if they lie within 2 x ``noise``); 0 leaves the band at the
    ulps.  The band holds the token picked, not the reference's top two, and
    does not grow with ``got``'s own error: a pick further down ``want``'s
    ranking fails however close its top two are."""
    got, want = got.float().reshape(-1, got.shape[-1]), want.float().reshape(-1, want.shape[-1])
    top = want.topk(2, dim=-1).values
    ulp = (top[:, 0].abs().log2().floor() - 7).exp2()  # bf16 keeps 8 significant bits
    band = (TOP1_TIE_ULPS * ulp).clamp(min=2.0 * noise)
    pick = got.argmax(-1)
    short = top[:, 0] - want.gather(-1, pick[:, None])[:, 0]  # how far the pick scores below want's top
    same = pick == want.argmax(-1)
    return {**distance(got, want), "same": int(same.sum()), "rows": len(same),
            "top1_ok": bool((short <= band).all()), "margin": float((top[:, 0] - top[:, 1]).min()),
            "short": float(short.max()), "noise": noise}


def agreement(c: dict) -> str:
    return (f"max|d| {c['err']:.4g} = {c['rel']:.4%} of max|logit| {c['scale']:.4g}, top-1 equal on "
            f"{c['same']}/{c['rows']} rows (smallest top-2 margin {c['margin']:.4g}; the pick at most "
            f"{c['short']:.4g} below the top, a tie within {TOP1_TIE_ULPS} bf16 ulps"
            + (f" or 2 x the sound noise {c['noise']:.4g})" if c["noise"] else ")"))


@contextlib.contextmanager
def expert_picks(L, picks: list, *, replay: bool = False):
    """While active, every MoE call's top-k (``layers._top_k``) is recorded
    into ``picks`` in call order, or, with ``replay``, each call takes the
    next recorded pick weighted by its own router probabilities.  Yields a
    list that gets, per replayed call, the number of tokens whose own pick
    differed.  Two bf16 forwards that round differently flip the experts of
    tokens whose k-th and (k+1)-th router probabilities nearly tie; pinning
    the picks compares what else differs (attention, the cache)."""
    real = L._top_k
    recorded = iter(list(picks))
    flips = []

    def top_k(probs, k):
        w, idx = real(probs, k)
        if not replay:
            picks.append(idx)
            return w, idx
        pinned = next(recorded)
        flips.append((idx.sort(-1).values != pinned.sort(-1).values).any(-1).sum())
        return probs.gather(-1, pinned), pinned

    with mock.patch.object(L, "_top_k", top_k):
        yield flips


@contextlib.contextmanager
def kept_tally(L, tally: list):
    """While active, every MoE dispatch adds (tokens kept, tokens routed) to
    ``tally`` (device tensors)."""
    real = L._dispatch_indices

    def counted(eid, n_experts, capacity):
        out = real(eid, n_experts, capacity)
        tally.append((out[3].sum(), out[3].numel()))
        return out

    with mock.patch.object(L, "_dispatch_indices", counted):
        yield


def lm_arch(A, configs, name: str, lengths, dec_batch: int):
    """The config of ``name`` with lm_full's shapes: a prefill at each
    length, batch 1, and decode_32k at ``dec_batch``."""
    shapes = tuple(A.ShapeSpec(f"prefill_{S}", "prefill", batch=1, seq=S) for S in lengths)
    shapes += (A.ShapeSpec("decode_32k", "decode", batch=dec_batch, seq=LM_DECODE_LEN),)
    return dataclasses.replace(configs.get(name), shapes=shapes)


def lm_flash_shapes(A, configs) -> list:
    """(B, S, T, H, KH, hd, causal, dtype) of every lm_full prefill's attention."""
    out = []
    for name, lengths, dec_batch, _ in LM_CASES:
        cfg = lm_arch(A, configs, name, lengths, dec_batch).cfg
        out += [(1, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True, "bfloat16") for S in lengths]
    return list(dict.fromkeys(out))


def blind_sdpa(real):
    """``layers._sdpa`` with the last valid slot of a one-token query masked
    out: a decode whose new token does not see its own key (a wrong path)."""

    def sdpa(c, q, k, v, mask=None):
        if mask is not None and q.shape[1] == 1:
            mask = mask & mask.roll(-1, -1)
        return real(c, q, k, v, mask)

    return sdpa


def upcast_attention(torch, flash_ref, q, k, v, *, causal: bool):
    """The plain attention on f32-upcast q, k, v (scores, softmax and the
    weighted sum in f32, as the reference's kernel test holds the kernel),
    cast back to the inputs' dtype."""
    return plain_sdpa(torch, flash_ref, q.float(), k.float(), v.float(), causal=causal).to(q.dtype)


def device_busy(torch, fn, *, warm: bool = True) -> tuple[float, str]:
    """(device busy ms of one ``fn()`` under torch.profiler, the three device
    ops with the most self time), run once unprofiled first if ``warm``."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        timed(torch, fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timed(torch, fn)
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in events[:3])
    return busy, top


def device_profile(torch, fn) -> str:
    """``device_busy`` of one ``fn()`` call, as a line."""
    if DEVICE != "cuda":
        return "not measured (no card)"
    busy, top = device_busy(torch, fn)
    return f"device busy {busy:.2f} ms; most: {top}"


def phase_lm_full(torch, A, configs, common, steps, lm, L, flash_ops, flash_ref, median_s) -> dict:
    """The four decoder LMs at full config through ``launch/steps.build_cell``
    (LM_CASES; weights from the seed, drawn on the card in bf16, attention
    matrices at their own fan-in).  Each prefill launches the flash kernel
    once a layer; its last-token logits are held within LM_FULL_RTOL of
    the same prefill under the plain attention on f32-upcast q, k, v (an
    MoE's expert picks pinned to the kernel run's), with the plain attention
    on bf16 q, k, v (bf16 scores) logged beside as a control.
    LM_DECODE_STEPS decode steps from an empty decode_32k cache are held
    within LM_FULL_RTOL of the kernel's prefill of the same tokens (an MoE:
    one that drops no token, with the decode's picks); qwen3-0.6b's int8
    cache within LM_INT8_REL of its bf16 cache, with equal top-1.  For
    LM_CONTROL, a non-causal prefill and a decode whose token does not see
    itself must lie beyond LM_FULL_RTOL.  Top-1 must be equal unless the
    token picked ties the reference's top (``compare_logits``): within 2
    bf16 ulps in prefill; in decode, or within twice the distance between
    the kernel's and the plain attention's prefill, two sound computations
    measured apart from the decode.  Returns the report: per model,
    prefill ms and tokens/s, decode ms a step, flash launches a prefill,
    distances, peak memory."""

    def plain_attention(q, k, v, *, causal=True, **_):
        return upcast_attention(torch, flash_ref, q, k, v, causal=causal)

    def bf16_attention(q, k, v, *, causal=True, **_):
        return plain_sdpa(torch, flash_ref, q, k, v, causal=causal)

    def under(attention, fn, picks):
        """``fn()`` with ``attention`` in place of the flash op and the MoE
        picks pinned to ``picks``; returns (result, picks that flipped)."""
        with mock.patch.object(flash_ops, "attention", attention), expert_picks(L, picks, replay=True) as flips:
            out = fn()
        return out, int(sum(flips))

    report = {}
    for name, lengths, dec_batch, int8 in LM_CASES:
        arch = lm_arch(A, configs, name, lengths, dec_batch)
        cfg = arch.cfg
        n_layers, moe = cfg.n_layers, cfg.moe is not None
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cells = {s.name: steps.build_cell(arch, s.name) for s in arch.shapes}
        params, draw_s = timed(torch, lambda: own_fan_in(cells[arch.shapes[0].name].init_arg(0, SEED, DEVICE), cfg))
        log(f"lm_full: {name}: {n_layers} layers, {A.n_params(arch)} params, "
            f"{common.param_bytes(cells['decode_32k'].arg_specs[0]) / 1e9:.2f} GB in bf16, drawn on the card in "
            f"{draw_s:.2f} s (seed {SEED}; attention matrices at their own fan-in)")
        rows = report[name] = {"layers": n_layers, "prefill": {}}
        kernel_logits = {}
        for shape in arch.shapes[:-1]:
            cell = cells[shape.name]
            batch = A.make_inputs(arch, shape, SEED, device=DEVICE)
            picks, tally = [], []
            before = flash_ops.flash_attention.launches
            with expert_picks(L, picks), kept_tally(L, tally):
                logits, _ = timed(torch, lambda: cell(params, batch)[0])
            launches = flash_ops.flash_attention.launches - before
            kernel_logits[shape.seq] = logits
            check(launches == n_layers, f"{name} {shape.name} launched the flash kernel {launches} times, want {n_layers}")
            check(tuple(logits.shape) == (1, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
                  f"{name} {shape.name} logits malformed: {tuple(logits.shape)}")
            plain, flips = under(plain_attention, lambda: cell(params, batch)[0], picks)
            bf16, _ = under(bf16_attention, lambda: cell(params, batch)[0], picks)
            c, control = compare_logits(logits, plain), distance(bf16, plain)["rel"]
            kept = (f"; MoE tokens kept {float(sum(k for k, _ in tally)) / sum(n for _, n in tally):.4%} of "
                    f"{sum(n for _, n in tally)} routed; without pinning the plain run's picks differ on {flips} of "
                    f"{n_layers * shape.seq} token-layers" if moe else "")
            ms = median_s(lambda: cell(params, batch)[0].cpu(), warmup=1, repeats=3) * 1e3
            rows["prefill"][shape.seq] = {"ms": ms, "tokens_per_s": shape.seq / ms * 1e3, "launches": launches,
                                          "rel": c["rel"], "control": control}
            log(f"lm_full: {name} {shape.name} (batch 1, S {shape.seq}): {ms:.2f} ms a prefill, "
                f"{shape.seq / ms * 1e3:.0f} tokens/s; {launches} flash launches; logits vs the f32-upcast plain "
                f"attention: {agreement(c)} (limit {LM_FULL_RTOL:.2%}); the bf16-score plain attention's "
                f"(control) {control:.4%}{kept}")
            check(c["rel"] <= LM_FULL_RTOL and c["top1_ok"], f"{name} {shape.name}: kernel prefill differs from plain")
            if shape.seq == LM_PREFILL:
                log(f"lm_full: {name} {shape.name} profile ({ms:.2f} ms a prefill on the host clock): "
                    + device_profile(torch, lambda: cell(params, batch)))

        # decode_32k from an empty cache, against a prefill of the same tokens
        dec = cells["decode_32k"]
        steps_n = LM_DECODE_STEPS
        tokens = A.make_inputs(arch, A.ShapeSpec("tokens", "prefill", batch=dec_batch, seq=steps_n), SEED + 1,
                               device=DEVICE)["tokens"]

        def decode(cell, picks, measure=True):
            """LM_DECODE_STEPS steps from the cell's empty cache, the MoE picks
            recorded into ``picks``; then, with ``measure``, the same pass
            timed: (its last logits, ms a step as the median of
            LM_DECODE_REPEATS passes after that first one, the device profile
            of one more step)."""
            empty = cell.init_arg(1, SEED, DEVICE)

            def run():  # every pass starts at length 0 and rewrites the same slots
                cache = empty
                for s in range(steps_n):
                    logits, cache = cell(params, cache, {"token": tokens[:, s:s + 1]})
                return logits, cache

            with expert_picks(L, picks):
                (logits, cache), _ = timed(torch, run)
            check(int(cache["len"]) == steps_n, f"{name}: cache length {int(cache['len'])} after {steps_n} steps")
            if not measure:
                return logits, None, None
            passes = sorted(timed(torch, run)[1] for _ in range(LM_DECODE_REPEATS))
            ms = passes[len(passes) // 2] / steps_n * 1e3
            prof = device_profile(torch, lambda: cell(params, cache, {"token": tokens[:, :1]}))
            return logits, ms, prof

        before = flash_ops.flash_attention.launches
        picks = []
        logits, step_ms, prof = decode(dec, picks)
        check(flash_ops.flash_attention.launches == before, f"{name}: decode launched the flash kernel")
        check(tuple(logits.shape) == (dec_batch, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
              f"{name} decode logits malformed")
        no_drop = cfg
        if moe:
            no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        by_layer = [torch.cat(picks[layer::n_layers], dim=1) for layer in range(n_layers)] if moe else []
        (prefilled, _), flips = under(flash_ops.attention, lambda: lm.prefill(no_drop, params, tokens), by_layer)
        (plain, _), _ = under(plain_attention, lambda: lm.prefill(no_drop, params, tokens), by_layer)
        # the kernel's prefill against the plain attention's: the noise apart from the decode
        sound = distance(prefilled, plain)
        c, vs_plain = compare_logits(logits, prefilled, noise=sound["err"]), distance(logits, plain)["rel"]
        rows["decode"] = {"batch": dec_batch, "cache": LM_DECODE_LEN, "ms_per_step": step_ms, "rel": c["rel"],
                          "vs_plain": vs_plain}
        pinned = f" that drops none (the decode's picks pinned; its own differ on {flips} token-layers)" if moe else ""
        log(f"lm_full: {name} decode_32k (batch {dec_batch}, {LM_DECODE_LEN}-slot cache, {steps_n} steps from empty): "
            f"{step_ms:.2f} ms a step, {dec_batch / step_ms * 1e3:.0f} tokens/s; last logits vs the kernel's prefill "
            f"of the same {steps_n} tokens{pinned}: {agreement(c)} (limit {LM_FULL_RTOL:.2%}); vs the same prefill "
            f"under the f32-upcast plain attention {vs_plain:.4%}")
        check(c["rel"] <= LM_FULL_RTOL and c["top1_ok"], f"{name}: decode differs from prefill")
        log(f"lm_full: {name} decode step profile ({step_ms:.2f} ms a step on the host clock): {prof}")
        if int8:
            quant = steps.build_cell(dataclasses.replace(arch, cfg=dataclasses.replace(cfg, kv_quant=True)), "decode_32k")
            q_logits, q_ms, prof = decode(quant, [])
            rel = float(torch.linalg.norm((q_logits - logits).float()) / torch.linalg.norm(logits.float()))
            c = compare_logits(q_logits, logits)
            rows["decode_int8"] = {"ms_per_step": q_ms, "rel": rel}
            log(f"lm_full: {name} decode_32k with the int8 cache: {q_ms:.2f} ms a step; ||int8 - bf16|| / ||bf16|| "
                f"{rel:.4%} (tolerance {LM_INT8_REL:.0%}); {agreement(c)}")
            check(0 < rel < LM_INT8_REL and c["same"] == c["rows"],
                  f"{name}: int8-cache decode too far from the bf16 cache, or another top-1")
            log(f"lm_full: {name} int8-cache decode step profile: {prof}")
        if name == LM_CONTROL:  # two wrong paths, which the limit must catch
            shape = arch.shape(f"prefill_{LM_PREFILL}")
            batch = A.make_inputs(arch, shape, SEED, device=DEVICE)
            unmasked = lambda q, k, v, **_: upcast_attention(torch, flash_ref, q, k, v, causal=False)  # noqa: E731
            wrong_prefill, _ = under(unmasked, lambda: cells[shape.name](params, batch)[0], [])
            with mock.patch.object(L, "_sdpa", blind_sdpa(L._sdpa)):
                wrong_decode, _, _ = decode(dec, [], measure=False)
            wrong = rows["wrong"] = {"prefill": distance(wrong_prefill, kernel_logits[LM_PREFILL])["rel"],
                                     "decode": distance(wrong_decode, prefilled)["rel"]}
            log(f"lm_full: {name} wrong paths, which must lie beyond the limit ({LM_FULL_RTOL:.2%}): a non-causal "
                f"prefill (the plain attention without its mask) {wrong['prefill']:.4%} from the kernel's; a decode "
                f"whose token does not see its own key {wrong['decode']:.4%} from the kernel's prefill")
            check(min(wrong.values()) > LM_FULL_RTOL, f"{name}: the limit passes a wrong path: {wrong}")
        del params
        if DEVICE == "cuda":
            rows["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            log(f"lm_full: {name}: peak card memory {rows['peak_gb']:.2f} GB")
    return report


def attention_layers(cfg) -> int:
    """Attention layers of a diffusion config: DiT's blocks, or Flux's
    double and single blocks."""
    return cfg.n_double + cfg.n_single if hasattr(cfg, "n_double") else cfg.n_layers


def prediction(torch, diffusion, arch, params, batch):
    """The network's output for one denoise step's inputs, as its sample
    step uses it: DiT's eps channels, Flux's velocity (no autograd)."""
    cfg = arch.cfg
    with torch.no_grad():
        if arch.family == "dit":
            return diffusion.dit_forward(cfg, params, batch["x"], batch["t"] * 1000.0, batch["y"])[..., :cfg.in_ch]
        return diffusion.flux_forward(cfg, params, batch["x"], batch["txt"], batch["vec"], batch["t"],
                                      batch["guidance"])


def streams_alone(torch, flash_ref, txt_len: int):
    """A wrong joint attention: the first ``txt_len`` tokens (text) and the
    rest (image) each attend only among themselves, f32-upcast."""

    def attention(q, k, v, **_):
        return torch.cat([upcast_attention(torch, flash_ref, q[:, s], k[:, s], v[:, s], causal=False)
                          for s in (slice(None, txt_len), slice(txt_len, None))], dim=1)

    return attention


def phase_diffusion_full(torch, A, configs, common, steps, diffusion, flash_ops, flash_ref, median_s) -> dict:
    """DiT-XL/2 and Flux-dev at their published configs through
    ``launch/steps.build_cell`` (DIFF_MODELS at DIFF_SHAPES, published
    batches; seed-0 bf16 weights drawn on the card, attention matrices at
    their own fan-in, zero-init leaves drawn).  Each forward launches the
    flash kernel once an attention layer (28, 57); its prediction, not zero,
    is held within DIFF_RTOL of the same forward under the plain attention
    on f32-upcast q, k, v, with the bf16-score plain attention logged beside
    as a control; each model's wrong path must lie beyond DIFF_RTOL.  A
    step of each cell is timed (median of 3 after 1, host clock to a copy to
    the host) and one gen_1024 step profiled; a DIFF_REQUEST request is
    served whole.  Returns the report: per model and shape, ms a step,
    launches, distances; the request; peak memory."""

    def plain_attention(q, k, v, *, causal=True, **_):
        return upcast_attention(torch, flash_ref, q, k, v, causal=causal)

    def bf16_attention(q, k, v, *, causal=True, **_):
        return plain_sdpa(torch, flash_ref, q, k, v, causal=causal)

    def under(attention, fn):
        with mock.patch.object(flash_ops, "attention", attention):
            return fn()

    report = {}
    for name in DIFF_MODELS:
        arch = configs.get(name)
        cfg = arch.cfg
        layers = attention_layers(cfg)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cells = {s: steps.build_cell(arch, s) for s in DIFF_SHAPES}
        specs = cells[DIFF_SHAPES[0]].arg_specs[0]
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
        params, draw_s = timed(torch, lambda: draw_zero_leaves(
            common, own_fan_in(cells[DIFF_SHAPES[0]].init_arg(0, SEED, DEVICE), cfg), specs, gen))
        log(f"diffusion_full: {name}: {layers} attention layers, {A.n_params(arch)} params, "
            f"{common.param_bytes(specs) / 1e9:.2f} GB in bf16, drawn on the card in {draw_s:.2f} s (seed {SEED}; "
            "attention matrices at their own fan-in; zero-init leaves drawn as fan-in normals)")
        rows = report[name] = {"layers": layers, "shapes": {}}
        plains = {}
        earlier_peak = 0  # the phase's own peak reading, kept across step_memory's resets
        for shape_name in DIFF_SHAPES:
            shape, cell = arch.shape(shape_name), cells[shape_name]
            batch = A.make_inputs(arch, shape, SEED, device=DEVICE)
            predict = lambda: prediction(torch, diffusion, arch, params, batch)  # noqa: E731
            before = flash_ops.flash_attention.launches
            pred, _ = timed(torch, predict)
            launches = flash_ops.flash_attention.launches - before
            check(launches == layers, f"{name} {shape_name}: a forward launched the flash kernel {launches} times, "
                  f"want {layers}")
            check(pred.shape == batch["x"].shape and bool(torch.isfinite(pred).all()),
                  f"{name} {shape_name}: prediction malformed: {tuple(pred.shape)}")
            scale = float(pred.abs().max())
            check(scale > 0, f"{name} {shape_name}: the prediction is 0 (zero-init modulation left at zero?)")
            plain = plains[shape_name] = under(plain_attention, predict)
            control = distance(under(bf16_attention, predict), plain)["rel"]
            rel = distance(pred, plain)["rel"]
            out = cell(params, batch)
            moved = float((out - batch["x"]).abs().max())
            check(out.shape == batch["x"].shape and bool(torch.isfinite(out).all()) and moved > 0,
                  f"{name} {shape_name}: the step's output is malformed or equals its input")
            ms = median_s(lambda: cell(params, batch).cpu(), warmup=1, repeats=3) * 1e3
            tokens = (shape.img // 8 // cfg.patch) ** 2
            rows["shapes"][shape_name] = {"batch": shape.batch, "tokens": tokens, "launches": launches, "ms": ms,
                                          "steps": shape.steps, "rel": rel, "control": control, "scale": scale}
            if DEVICE == "cuda" and (name, shape_name) in DRYRUN_CELLS:
                mem = rows["shapes"][shape_name]["memory"] = step_memory(torch, lambda: cell(params, batch),
                                                                         {"params": params, "batch": batch})
                earlier_peak = max(earlier_peak, mem["earlier_peak_bytes"])
            log(f"diffusion_full: {name} {shape_name} (batch {shape.batch}, {shape.img // 8}² latents, {tokens} image "
                f"tokens): {launches} flash launches a forward; prediction vs the f32-upcast plain attention "
                f"{rel:.4%} of max|prediction| {scale:.4g} (limit {DIFF_RTOL:.2%}); the bf16-score plain attention's "
                f"(control) {control:.4%}; {ms:.2f} ms a step (median of 3 after 1, host clock to a copy to the host), "
                f"{shape.steps} steps an image (computed: steps x ms a step) {shape.steps * ms / 1e3:.3f} s, "
                f"{shape.batch / (shape.steps * ms) * 1e3:.3f} images/s")
            check(rel <= DIFF_RTOL, f"{name} {shape_name}: kernel prediction differs from plain")
            if shape_name == "gen_1024":
                log(f"diffusion_full: {name} {shape_name} step profile ({ms:.2f} ms a step on the host clock): "
                    + device_profile(torch, lambda: cell(params, batch)))

        # the wrong path, at the request's shape
        shape = arch.shape(DIFF_REQUEST)
        batch = A.make_inputs(arch, shape, SEED, device=DEVICE)
        if arch.family == "dit":
            what = "causal attention"
            wrong_attention = lambda q, k, v, **_: upcast_attention(torch, flash_ref, q, k, v, causal=True)  # noqa: E731
        else:
            what = "image tokens blind to the text tokens (each stream attends alone)"
            wrong_attention = streams_alone(torch, flash_ref, cfg.txt_len)
        wrong = rows["wrong"] = distance(under(wrong_attention, lambda: prediction(torch, diffusion, arch, params, batch)),
                                         plains[DIFF_REQUEST])["rel"]
        log(f"diffusion_full: {name} wrong path at {DIFF_REQUEST}, which must lie beyond the limit "
            f"({DIFF_RTOL:.2%}): {what} {wrong:.4%} from the f32-upcast plain attention's prediction")
        check(wrong > DIFF_RTOL, f"{name}: the limit passes a wrong path ({what}): {wrong:.4%}")

        # a request served whole: `steps` denoising steps from standard normal latents
        cell = cells[DIFF_REQUEST]
        batch = A.make_inputs(arch, shape, SEED + 2, device=DEVICE)
        n = shape.steps
        dt = DIFF_T0 / n
        x = batch["x"]
        before = flash_ops.flash_attention.launches
        t0 = time.perf_counter()
        for i in range(n):
            step_in = {**batch, "x": x, "t": torch.full_like(batch["t"], DIFF_T0 - i * dt),
                       "dt": torch.full_like(batch["dt"], dt)}
            new = cell(params, step_in)
            check(bool(torch.isfinite(new).all()) and float((new - x).abs().max()) > 0,
                  f"{name} {DIFF_REQUEST} request: step {i} is not finite or left x unchanged")
            x = new
        wall = time.perf_counter() - t0
        launches = flash_ops.flash_attention.launches - before
        rows["request"] = {"steps": n, "batch": shape.batch, "s": wall, "launches": launches}
        log(f"diffusion_full: {name} {DIFF_REQUEST} request: {n} steps at batch {shape.batch}, t {DIFF_T0} -> 0 in "
            f"steps of {dt:.4g}, each finite and moving x; {wall:.3f} s on the host clock (checks included), "
            f"{launches} flash launches; final |x| max {float(x.abs().max()):.4g}")
        check(launches == n * layers, f"{name} request launched the flash kernel {launches} times, want {n * layers}")
        del params
        if DEVICE == "cuda":
            rows["peak_gb"] = max(earlier_peak, torch.cuda.max_memory_allocated()) / 1e9
            log(f"diffusion_full: {name}: peak card memory {rows['peak_gb']:.2f} GB")
    return report


# ---------------------------------------------------------------------------
# 5e. train_full: the training kinds
# ---------------------------------------------------------------------------


def train_arch(configs, name: str, shape_name: str, depth, batch: int):
    """``name``'s config with its depth cut (an LM's or DiT's layers; Flux's
    (double, single) blocks; None: whole) and one shape, ``shape_name`` at
    global batch ``batch``."""
    arch = configs.get(name)
    cfg = arch.cfg
    if isinstance(depth, tuple):
        cfg = dataclasses.replace(cfg, n_double=depth[0], n_single=depth[1])
    elif depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    shape = dataclasses.replace(arch.shape(shape_name), batch=batch)
    return dataclasses.replace(arch, cfg=cfg, shapes=(shape,))


def train_weights(torch, common, steps, cell, arch, *, draw_zero: bool = False):
    """The cell's train state drawn on the card from the seed (f32 params,
    zero moments, step 0), attention matrices at their own fan-in.  With
    ``draw_zero`` the diffusion models' zero-init leaves are drawn too (as
    diffusion_full's), so every gradient is live: for the agreement checks,
    (b) and (c).  Training (a) starts from the published adaLN-Zero init."""
    ts = cell.init_arg(0, SEED, DEVICE)
    if arch.family in ("lm", "dit", "flux"):
        own_fan_in(ts["params"], arch.cfg)
    if draw_zero and arch.family in ("dit", "flux"):
        draw_cut_zero_leaves(torch, common, steps, arch, ts["params"])
    return ts


def draw_cut_zero_leaves(torch, common, steps, arch, params):
    """``draw_zero_leaves`` on ``params`` of ``arch`` (whose specs come from
    its training cell), from seed + 1; returns ``params``."""
    specs = steps.build_cell(arch, arch.shapes[0].name).arg_specs[0]["params"]
    return draw_zero_leaves(common, params, specs, torch.Generator(device=DEVICE).manual_seed(SEED + 1))


def train_batch(torch, data, arch, step: int = 0):
    """Batch ``step`` of the port's SyntheticStream at the arch's shape, on the card."""
    stream = data.SyntheticStream(data.DataSpec(arch, arch.shapes[0], seed=SEED))
    return {k: torch.as_tensor(v, device=DEVICE) for k, v in stream.batch_at(step).items()}


def check_cut(common, arch, params, batch):
    """(arch, params, batch) of check (b): 2 layers (Flux: 1 double + 1
    single block) of the case's weights and the first microbatch, short: an
    LM's first TRAIN_CHECK_SEQ tokens, Flux's top-left TRAIN_CHECK_IMG² of
    latents, the others' first TRAIN_CHECK_BATCH samples."""
    cfg, f = arch.cfg, arch.family
    first = lambda tree, n: common.tree_map(lambda t: t[:n], tree)  # noqa: E731
    if f == "lm":
        cfg, params = dataclasses.replace(cfg, n_layers=2), {**params, "blocks": first(params["blocks"], 2)}
        batch = {k: v[:1, :TRAIN_CHECK_SEQ] for k, v in batch.items()}
    elif f == "dit":
        cfg, params = dataclasses.replace(cfg, n_layers=2), {**params, "blocks": first(params["blocks"], 2)}
        batch = {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()}
    elif f == "flux":
        cfg = dataclasses.replace(cfg, n_double=1, n_single=1)
        params = {**params, "double": first(params["double"], 1), "single": first(params["single"], 1)}
        lat = TRAIN_CHECK_IMG // 8
        batch = {k: v[:1, :lat, :lat] if k in ("x", "noise") else v[:1] for k, v in batch.items()}
    else:
        batch = {k: v[:TRAIN_CHECK_BATCH] for k, v in batch.items()}
    shape = dataclasses.replace(arch.shapes[0], batch=len(next(iter(batch.values()))))
    return dataclasses.replace(arch, cfg=cfg, shapes=(shape,)), params, batch


@contextlib.contextmanager
def train_wrong_path(torch, diffusion, arch, batch):
    """A wrong training objective, for check (b): an LM's labels shifted by
    one position, a classifier's by one sample, and the diffusion models'
    timestep embedding fed t where the model feeds t · 1000.  Yields
    (description, batch)."""
    if arch.family == "lm":
        yield "labels shifted by one position", {**batch, "labels": torch.roll(batch["labels"], 1, dims=1)}
    elif arch.family in ("dit", "flux"):
        real = diffusion.timestep_embedding
        with mock.patch.object(diffusion, "timestep_embedding", lambda t, dim: real(t / 1000.0, dim)):
            yield "timestep embedding fed t, not t * 1000", batch
    else:
        yield "labels shifted by one sample", {**batch, "labels": torch.roll(batch["labels"], 1, dims=0)}


def grad_distance(got, want) -> tuple[float, float]:
    """(||got - want|| / ||want|| over every leaf at once, the largest
    max|got - want| / max|want| of a leaf), on ``got``'s device (``want``
    is copied there a leaf at a time)."""
    num = den = worst = 0.0
    for g, w in zip(got, want, strict=True):
        w = w.to(g.device)
        d = g - w
        num, den = num + float((d * d).sum()), den + float((w * w).sum())
        scale = float(w.abs().max())
        worst = max(worst, float(d.abs().max()) / scale if scale else 0.0)
    return math.sqrt(num / den), worst


class F32Torch:
    """A stand-in for a model module's ``torch`` whose ``bfloat16`` is
    float32, so the module's bf16 casts compute in f32 (the ``_F32`` of the
    port's tests)."""

    def __init__(self, torch):
        self._torch, self.bfloat16 = torch, torch.float32

    def __getattr__(self, name):
        return getattr(self._torch, name)


@contextlib.contextmanager
def in_f32(torch, modules):
    """While active, each model module in ``modules`` computes in f32, and
    the card's f32 matmuls and convolutions do not round to TF32."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with contextlib.ExitStack() as stack:
            for module in modules:
                stack.enter_context(mock.patch.object(module, "torch", F32Torch(torch)))
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def bf16_held(arch) -> bool:
    """Whether check (b) holds ``arch``'s bf16 distance (not the BatchNorm
    ResNets': chaotic, see TRAIN_GRAD_RTOL_BN)."""
    return arch.family in ("lm", "dit", "flux")


def grad_limit(arch) -> float:
    """Check (b)'s gradient limit for ``arch`` (TRAIN_GRAD_RTOL_BN for the
    BatchNorm ResNets)."""
    return TRAIN_GRAD_RTOL_BN if arch.family == "resnet" else TRAIN_GRAD_RTOL


@contextlib.contextmanager
def blockwise_at_check_size(layers, arch):
    """For Flux, which trains above ``layers.BLOCKWISE_THRESHOLD``: while
    active, every differentiated attention takes ``blockwise_sdpa`` at
    TRAIN_CHECK_BLOCKS, as (a)'s steps take it at its own blocks.  Yields a
    list that counts its calls (the other families: nothing patched)."""
    calls = []
    if arch.family != "flux":
        yield calls
        return
    real = layers.blockwise_sdpa

    def counted(q, k, v, *, causal):
        calls.append(q.device.type)
        return real(q, k, v, causal=causal, **TRAIN_CHECK_BLOCKS)

    with mock.patch.object(layers, "BLOCKWISE_THRESHOLD", 0), mock.patch.object(layers, "blockwise_sdpa", counted):
        yield calls


def train_agreement(torch, common, steps, diffusion, layers, f32_modules, arch, params, state, batch) -> dict:
    """Check (b): the loss and every gradient of ``arch`` (already cut) on
    the card and on the host CPU from the same weights and batch, with the
    model modules in f32 (``in_f32``), and the wrong path's on the card
    against the CPU's; then the same in bf16 as the model runs.  Flux's
    attention takes ``blockwise_sdpa`` (``blockwise_at_check_size``)."""
    loss_fn = steps.build_cell(arch, arch.shapes[0].name).meta["loss_fn"]
    host = lambda tree: common.tree_map(lambda t: t.cpu(), tree)  # noqa: E731

    cpu_params, cpu_state, cpu_batch = host(params), host(state), host(batch)

    def on_both():
        (cpu_loss, _), cpu_grads = steps.value_and_grad(loss_fn, cpu_params, cpu_state, cpu_batch)
        (loss, _), grads = steps.value_and_grad(loss_fn, params, state, batch)
        with train_wrong_path(torch, diffusion, arch, batch) as (what, wrong_batch):
            (w_loss, _), w_grads = steps.value_and_grad(loss_fn, params, state, wrong_batch)
        cpu_loss = float(cpu_loss)
        return {"loss_rel": abs(float(loss) - cpu_loss) / abs(cpu_loss), "grads": grad_distance(grads, cpu_grads),
                "wrong": what, "wrong_loss_rel": abs(float(w_loss) - cpu_loss) / abs(cpu_loss),
                "wrong_grad_rel": grad_distance(w_grads, cpu_grads)[0]}

    with blockwise_at_check_size(layers, arch) as blockwise_calls:
        with in_f32(torch, f32_modules):
            f32 = on_both()
        bf16 = on_both()
    out = {"loss_rel": f32["loss_rel"], "grad_rel": f32["grads"][0], "worst_leaf": f32["grads"][1],
           "wrong": f32["wrong"], "wrong_loss_rel": f32["wrong_loss_rel"], "wrong_grad_rel": f32["wrong_grad_rel"],
           "bf16_loss_rel": bf16["loss_rel"], "bf16_grad_rel": bf16["grads"][0],
           "bf16_wrong_loss_rel": bf16["wrong_loss_rel"], "bf16_wrong_grad_rel": bf16["wrong_grad_rel"],
           "blockwise_calls": {d: blockwise_calls.count(d) for d in sorted(set(blockwise_calls))}}
    if arch.family == "flux":  # with the threshold at 0, every differentiated attention is blockwise
        check(blockwise_calls.count("cpu") > 0 and blockwise_calls.count(DEVICE) > 0,
              f"{arch.name}: check (b) did not train through blockwise_sdpa: {out['blockwise_calls']}")
    return out


def train_restart(torch, train) -> dict:
    """Check (d): TRAIN_RESTART through the CLI, ``launch.train.main``, under
    cudnn.deterministic: TRAIN_RESTART_STEPS straight, then half of them with
    an async checkpoint at the end, ``--resume`` and the rest."""
    name, shape = TRAIN_RESTART
    n = TRAIN_RESTART_STEPS
    ckpt = TRAIN_CKPT
    args = ["--arch", name, "--shape", shape, "--total-steps", str(n), "--seed", str(SEED), "--device", DEVICE,
            "--log-every", "1"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        straight = train.main(args + ["--steps", str(n)])
        part = train.main(args + ["--steps", str(n // 2), "--ckpt-dir", str(ckpt), "--ckpt-every", str(n // 2)])
        resumed = train.main(args + ["--steps", str(n), "--ckpt-dir", str(ckpt), "--ckpt-every", "100", "--resume"])
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(ckpt, ignore_errors=True)
    check(part["steps"] == n // 2 and resumed["steps"] == n - n // 2,
          f"restart: {part['steps']} + {resumed['steps']} steps, want {n // 2} + {n - n // 2}")
    rel = abs(resumed["last_loss"] - straight["last_loss"]) / abs(straight["last_loss"])
    return {"straight": straight["last_loss"], "resumed": resumed["last_loss"], "rel": rel,
            "bitwise": resumed["last_loss"] == straight["last_loss"]}


def phase_train_full(torch, configs, common, steps, diffusion, layers, data, optim, train, f32_modules) -> dict:
    """The training kinds through ``launch/steps.build_cell`` at TRAIN_CASES
    (seed-0 f32 weights on the card, attention matrices at their own fan-in;
    the diffusion models' zero-init leaves drawn for (b) and (c) only).  Per
    case: (a) TRAIN_STEPS steps on one repeated
    batch of the port's SyntheticStream, the loss finite and falling; ms a
    step (host clock to the loss's read, median of steps 2-4), tokens or
    images a second, peak memory; (b) the loss and gradients of 2 layers on a
    short input, card against host CPU in f32 (``f32_modules``: the model
    modules), within TRAIN_LOSS_RTOL / ``grad_limit``, the wrong path
    beyond, and in bf16 within TRAIN_BF16_*_RTOL (the LMs, DiT and Flux;
    Flux through blockwise_sdpa); a fifth step of each of
    TRAIN_PROFILED profiled.
    Then (c) gradient accumulation on dit-xl2 and (d) the CLI's restart.
    Returns the report."""
    report = {}
    for name, shape_name, depth, batch_size, accum, lr in TRAIN_CASES:
        adamw = optim.AdamWConfig(lr=lr, **TRAIN_ADAMW)
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        arch = train_arch(configs, name, shape_name, depth, batch_size)
        shape = arch.shapes[0]
        cell = steps.build_cell(arch, shape_name, adamw=adamw, accum_steps=accum)
        (ts, draw_s) = timed(torch, lambda: train_weights(torch, common, steps, cell, arch))
        n = common.param_count(cell.arg_specs[0]["params"])
        batch = train_batch(torch, data, arch)
        log(f"train_full: {name} at {shape_name} ({'whole' if depth is None else f'depth cut to {depth}'}, "
            f"{n} params, train state {16 * n / 1e9:.2f} GB with its gradients; global batch {batch_size}, "
            f"accum_steps {accum}; drawn on the card in {draw_s:.2f} s)")
        losses, times = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            ts, metrics = cell(ts, batch)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"{name}: losses {losses} not finite or not falling")
        ms = sorted(times[1:])[len(times[1:]) // 2] * 1e3
        per_s = batch_size * (shape.seq or 1) / ms * 1e3
        unit = "tokens/s" if arch.family == "lm" else "images/s"
        row = report[name] = {"shape": shape_name, "depth": depth, "batch": batch_size, "accum": accum, "params": n,
                              "losses": losses, "ms": ms, "per_s": per_s, "unit": unit}
        log(f"train_full: {name} (a) losses {', '.join(f'{x:.5g}' for x in losses)} over {TRAIN_STEPS} steps on one "
            f"batch (lr {adamw.lr}); {ms:.1f} ms a step (median of steps 2-{TRAIN_STEPS}, host clock to the loss's "
            f"read), {per_s:.1f} {unit}")
        earlier_peak = 0
        if DEVICE == "cuda" and (name, shape_name) in DRYRUN_CELLS:
            check(depth is None and accum == 1 and batch_size == configs.get(name).shape(shape_name).batch,
                  f"{name}: dryrun compares the published {shape_name}, but train_full cuts it")
            row["memory"] = step_memory(torch, lambda: float(cell(ts, batch)[1]["loss"]), {"ts": ts, "batch": batch})
            earlier_peak = row["memory"]["earlier_peak_bytes"]
        if name in TRAIN_PROFILED and DEVICE == "cuda":
            busy, top = device_busy(torch, lambda: cell(ts, batch), warm=False)
            row["busy_ms"], row["busy_share"] = busy, busy / ms
            log(f"train_full: {name} step profile: device busy {busy:.1f} ms of a {ms:.1f} ms step "
                f"({busy / ms:.1%}); most: {top}")

        cut, params, mb = check_cut(common, arch, ts["params"], {k: v[:shape.batch // accum] for k, v in batch.items()})
        if arch.family in ("dit", "flux"):  # every gradient live: the zero-init leaves drawn, in a copy
            params = draw_cut_zero_leaves(torch, common, steps, cut, common.tree_map(lambda t: t, params))
        (agree, agree_s) = timed(torch, lambda: train_agreement(torch, common, steps, diffusion, layers, f32_modules,
                                                                cut, params, ts["state"], mb))
        row["agree"] = agree
        x = next(mb[k] for k in ("tokens", "images", "x") if k in mb)
        log(f"train_full: {name} (b) {'whole' if cut.cfg == arch.cfg else '2 layers'}, input {tuple(x.shape)}, card "
            f"against host CPU in f32: loss {agree['loss_rel']:.3e} (limit {TRAIN_LOSS_RTOL}), gradients "
            f"{agree['grad_rel']:.3e} (limit {grad_limit(arch)}; worst leaf max|d|/max|g| {agree['worst_leaf']:.3e}); "
            f"wrong path ({agree['wrong']}): loss {agree['wrong_loss_rel']:.3e}, gradients "
            f"{agree['wrong_grad_rel']:.3e}; in bf16 as the model runs{'' if bf16_held(arch) else ' (logged only)'}: "
            f"loss {agree['bf16_loss_rel']:.3e} (limit {TRAIN_BF16_LOSS_RTOL}), gradients {agree['bf16_grad_rel']:.3e} "
            f"(limit {TRAIN_BF16_GRAD_RTOL}), wrong path loss {agree['bf16_wrong_loss_rel']:.3e}, gradients "
            f"{agree['bf16_wrong_grad_rel']:.3e}; blockwise_sdpa calls {agree['blockwise_calls']}; {agree_s:.1f} s")
        check(agree["loss_rel"] <= TRAIN_LOSS_RTOL and agree["grad_rel"] <= grad_limit(arch),
              f"{name}: card and CPU disagree in training: {agree}")
        check(agree["wrong_grad_rel"] > grad_limit(arch) and agree["wrong_loss_rel"] > TRAIN_LOSS_RTOL,
              f"{name}: a limit passes the wrong path: {agree}")
        if bf16_held(arch):
            check(agree["bf16_loss_rel"] <= TRAIN_BF16_LOSS_RTOL and agree["bf16_grad_rel"] <= TRAIN_BF16_GRAD_RTOL,
                  f"{name}: card and CPU disagree in training in bf16: {agree}")
            check(agree["bf16_wrong_grad_rel"] > TRAIN_BF16_GRAD_RTOL,
                  f"{name}: the bf16 limit passes the wrong path: {agree}")

        if name == "dit-xl2":
            ts = None  # (a)'s state goes before (c) draws its three
            row["accum_check"] = train_accumulation(torch, common, steps, cell, arch, adamw, batch)
        if DEVICE == "cuda":
            row["peak_gb"] = max(earlier_peak, torch.cuda.max_memory_allocated()) / 1e9
            log(f"train_full: {name}: peak card memory {row['peak_gb']:.2f} GB")
        ts = batch = params = mb = None
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    (restart, restart_s) = timed(torch, lambda: train_restart(torch, train))
    report["restart"] = restart
    log(f"train_full: (d) restart through launch.train on {'/'.join(TRAIN_RESTART)}: {TRAIN_RESTART_STEPS} steps "
        f"straight, last loss {restart['straight']!r}; {TRAIN_RESTART_STEPS // 2} + checkpoint + --resume + "
        f"{TRAIN_RESTART_STEPS - TRAIN_RESTART_STEPS // 2}: {restart['resumed']!r}; rel {restart['rel']:.3e} (limit "
        f"1e-4), bitwise {restart['bitwise']}; {restart_s:.1f} s")
    check(restart["rel"] <= 1e-4, f"restart: resumed loss {restart['resumed']} vs straight {restart['straight']}")
    return report


def train_accumulation(torch, common, steps, cell, arch, adamw, batch) -> dict:
    """Check (c): from one state (the zero-init leaves drawn, so every
    gradient is live), a step of ``cell`` (accum_steps 1) against a step at
    accum_steps TRAIN_ACCUM on the same batch, and the wrong path: the first
    TRAIN_ACCUM - 1 microbatches only."""
    shape = arch.shapes[0]
    states = [train_weights(torch, common, steps, cell, arch, draw_zero=True)]
    states += [common.tree_map(torch.clone, states[0]) for _ in range(2)]
    _, full = cell(states[0], batch)
    _, m = steps.build_cell(arch, shape.name, adamw=adamw, accum_steps=TRAIN_ACCUM)(states[1], batch)
    keep = shape.batch // TRAIN_ACCUM * (TRAIN_ACCUM - 1)
    short = dataclasses.replace(arch, shapes=(dataclasses.replace(shape, batch=keep),))
    _, wrong = steps.build_cell(short, shape.name, adamw=adamw, accum_steps=TRAIN_ACCUM - 1)(
        states[2], {k: v[:keep] for k, v in batch.items()})
    lr, loss = adamw.lr, float(full["loss"])
    got = {"loss": loss, "loss_rel": abs(float(m["loss"]) - loss) / abs(loss),
           "grad_norm_rel": abs(float(m["grad_norm"]) - float(full["grad_norm"])) / abs(float(full["grad_norm"])),
           "params_max": max(float((a - b).abs().max()) for a, b in zip(
               common.tree_leaves(states[1]["params"]), common.tree_leaves(states[0]["params"]))),
           "wrong_loss_rel": abs(float(wrong["loss"]) - loss) / abs(loss)}
    log(f"train_full: {arch.name} (c) accum_steps {TRAIN_ACCUM} against 1 on the same batch (zero-init leaves "
        f"drawn; loss {loss:.6g}): loss rel {got['loss_rel']:.3e} (limit {TRAIN_ACCUM_LOSS_RTOL}), grad_norm rel "
        f"{got['grad_norm_rel']:.3e} (limit 5e-2), params max|d| {got['params_max']:.3e} (limit {2.5 * lr:.1e} = "
        f"2.5 lr); wrong path (the last microbatch dropped) loss rel {got['wrong_loss_rel']:.3e}")
    check(got["loss_rel"] <= TRAIN_ACCUM_LOSS_RTOL and got["grad_norm_rel"] <= 5e-2 and got["params_max"] <= 2.5 * lr,
          f"accumulation disagrees with the full batch: {got}")
    check(got["wrong_loss_rel"] > TRAIN_ACCUM_LOSS_RTOL, f"the accumulation limit passes a dropped microbatch: {got}")
    return got


# ---------------------------------------------------------------------------
# 6. serving: the front door, calibration through the kernels
# ---------------------------------------------------------------------------


# The kernel each model's calibration must be timed through (Swin-B: none).
# ---------------------------------------------------------------------------
# 7b. dryrun: the dry run's estimates against measured steps
# ---------------------------------------------------------------------------


def dryrun_readings(diff_report: dict, train_report: dict) -> dict:
    """(arch, shape) -> {"ms", "memory"} of every DRYRUN_CELLS step that
    diffusion_full and train_full measured on the card."""
    out = {}
    for name, r in diff_report.items():
        for shape_name, p in r["shapes"].items():
            if "memory" in p:
                out[(name, shape_name)] = {"ms": p["ms"], "memory": p["memory"]}
    for name, r in train_report.items():
        if "memory" in r:
            out[(name, r["shape"])] = {"ms": r["ms"], "memory": r["memory"]}
    return out


def phase_dryrun(dryrun, readings: dict, smi: str) -> dict:
    """``dryrun.run_cell`` at full size (on the host CPU: the step traced on
    meta, nothing allocated on the card) for each of DRYRUN_CELLS, held
    against ``readings``: the measured ms a step at or above the roofline's
    ``step_s_lower_bound``, and the estimated peak within DRYRUN_PEAK_RTOL of
    the measured one (the flash trace's for a denoise step, which launches
    the flash kernel; the plain trace's for training, which launches none).
    The measured peak is the step's own: ``max_memory_allocated`` over the
    step less what the process held beside the step's arguments when it
    began (earlier phases' cached tensors, kernel workspaces), as the
    estimate is the arguments and the step's temporaries.
    Returns, per cell, the estimate and the reading."""
    check(set(readings) == set(DRYRUN_CELLS), f"dryrun: steps not measured on the card: "
          f"{sorted(set(DRYRUN_CELLS) - set(readings))}")
    report = {}
    for name, shape_name in DRYRUN_CELLS:
        rec = dryrun.run_cell(name, shape_name, out_dir=None)
        got = readings[(name, shape_name)]
        mem = rec["memory"]
        key = "flash_peak_bytes" if rec["kind"] == "denoise_step" else "peak_bytes"
        card = got["memory"]
        beside = card["resident_bytes"] - card["argument_bytes"]
        est, peak = mem[key], card["peak_bytes"] - beside
        bound_ms = rec["roofline"]["step_s_lower_bound"] * 1e3
        rel = (est - peak) / peak
        row = report[(name, shape_name)] = {"ms": got["ms"], "bound_ms": bound_ms, "ratio": got["ms"] / bound_ms,
                                            "estimate_gb": est / 1e9, "peak_gb": peak / 1e9, "rel": rel}
        log(f"dryrun: {name}/{shape_name} ({rec['kind']}; traced on meta in {rec['lower_s']:.2f} + "
            f"{rec['compile_s']:.2f} s): FLOPs {rec['flops_jaxpr']:.4e} (products {rec['dot_flops']:.4e}, model "
            f"{rec['model_flops']:.4e}), bytes {rec['bytes_jaxpr']:.4e} plain / {rec['bytes_jaxpr_flash']:.4e} flash; "
            f"roofline {rec['roofline']['bottleneck']} compute {rec['roofline']['compute_s'] * 1e3:.3f} ms, memory "
            f"{rec['roofline']['memory_s'] * 1e3:.3f} ms; measured {got['ms']:.2f} ms a step = "
            f"{row['ratio']:.2f} x the bound {bound_ms:.3f} ms; peak {key} {est / 1e9:.3f} GB against the step's "
            f"{peak / 1e9:.3f} GB ({rel:+.2%}, limit {DRYRUN_PEAK_RTOL:.0%}): max_memory_allocated "
            f"{card['peak_bytes'] / 1e9:.3f} GB over one step less {beside / 1e9:.3f} GB resident beside its "
            f"arguments (arguments {card['argument_bytes'] / 1e9:.3f} GB on the card, {mem['argument_bytes'] / 1e9:.3f} "
            f"GB traced) ({smi})")
        check(rec["fits"], f"dryrun: {name}/{shape_name} does not fit, though it ran on the card")
        check(got["ms"] >= bound_ms, f"dryrun: {name}/{shape_name} measured {got['ms']:.3f} ms under its roofline "
              f"bound {bound_ms:.3f} ms")
        check(abs(rel) <= DRYRUN_PEAK_RTOL, f"dryrun: {name}/{shape_name} estimated peak {est / 1e9:.3f} GB is "
              f"{rel:+.2%} from the measured {peak / 1e9:.3f} GB")
    return report


KERNEL_OF = {"resnet-50": "int8_matmul", "squeezenet": "int8_matmul", VIT: "flash_attention",
             B7: "int8_matmul", SWIN: None}


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
        if want is None:
            check(prov["backend"] == "cuda" and not any(prov["kernel_launches_timed"].values()),
                  f"{m['name']}: calibration launched a kernel: {prov}")
        else:
            check(prov["backend"] == "cuda" and prov["kernel"].endswith("(cuda)") and f"{want}.cu" in prov["kernel"]
                  and prov["kernel_launches_timed"][want] > 0,
                  f"{m['name']}: calibration was not timed through the {want} kernel: {prov}")
    log(f"serving {names}: int8 launches {int8}, flash launches {flash}")
    check(meta["frames"] == 64, f"answered {meta['frames']} of 64 frames")
    check("deadline_met_frac" in meta, "summary lacks deadline_met_frac")
    return int8, flash


def phase_serving(torch, ops, flash_ops, serve, session) -> tuple[int, int]:
    """The default pair, then ViT-S/16 with SqueezeNet, then EfficientNet-B7
    with Swin-B; returns the (int8, flash) launches of the runs together."""
    int8, flash = run_front_door(torch, ops, flash_ops, serve, session)
    check(int8 > 0 and flash == 0, "the default pair must launch the int8 kernel and not the flash kernel")
    vit_int8, vit_flash = run_front_door(torch, ops, flash_ops, serve, session, models=({"name": VIT}, "squeezenet"))
    check(vit_int8 > 0 and vit_flash > 0, "the ViT run must launch both kernels")
    zoo_int8, zoo_flash = run_front_door(torch, ops, flash_ops, serve, session, models=({"name": B7}, {"name": SWIN}))
    check(zoo_int8 > 0 and zoo_flash == 0, "the B7 + Swin-B run must launch the int8 kernel and not the flash kernel")
    return int8 + vit_int8 + zoo_int8, flash + vit_flash + zoo_flash


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


def step_memory(torch, step, args) -> dict:
    """One call of ``step`` with its arguments ``args`` (trees of dicts)
    resident, ended by a synchronize, and the card's memory around it: the
    bytes allocated before it, those of its arguments' distinct storages,
    the peak during it (the peak statistics reset just before), and the
    peak before that reset, which the calling phase keeps as its own."""
    storages = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, torch.Tensor):
            storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()

    walk(args)
    torch.cuda.synchronize()
    earlier = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    return {"resident_bytes": resident, "argument_bytes": sum(storages.values()),
            "peak_bytes": torch.cuda.max_memory_allocated(), "earlier_peak_bytes": earlier}


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
    ONE_RANK["sweep"] = table
    bit_equal = sum(g == w for n in table for g, w in zip(table[n], SWEEP_GOLDENS[n]))
    log(f"sweep: {sum(map(len, table.values()))} golden points of {len(table)} cases hold the reference's "
        f"contract on device={DEVICE} ({bit_equal} bit-equal in every field)")

    for name in SWEEP_PARAMS:
        grids = full_grids(name)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # what earlier phases still hold
        halves = [timed(torch, lambda sp=sp, g=g: batched(session.ScenarioSpec.from_json(sp),
                                                          session.SweepGrid.from_json(g))) for sp, g in grids]
        first, s1 = [r for r, _ in halves], sum(s for _, s in halves)
        second, s2 = timed(torch, lambda: [batched(session.ScenarioSpec.from_json(sp), session.SweepGrid.from_json(g))
                                           for sp, g in grids])
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20 if DEVICE == "cuda" else float("nan")
        n = sum(len(r.points) for r in first)
        (param_values,) = SWEEP_PARAMS[name][1].values()
        check(n == 2 * len(SWEEP_BW) * len(SWEEP_DL) * len(SWEEP_FPS) * len(param_values),
              f"{name}: {n} full-width points")
        check(sweep_rows(first[0]) + sweep_rows(first[1]) == sweep_rows(second[0]) + sweep_rows(second[1]),
              f"{name}: two runs of the same grid differ")
        if name == MESH_LARGE:
            ONE_RANK["large"] = ([stats_rows(p.streams) for p in first[-1].points], halves[-1][1])
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
            if name in LOOP_AT_10_ONLY and n_ref > min(REFERENCE_GRIDS):
                continue
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
    ONE_RANK["online"] = table[MESH_ONLINE]
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
# 11. fleet: Session.run_sweep on fleet grids through the lane-batched fleet
#     engine
# ---------------------------------------------------------------------------


def fleet_spec(name: str, n_frames: int, params: dict | None = None, **kw) -> dict:
    spec = {"policy": {"name": name, "params": FLEET_PARAMS[name] if params is None else params},
            "n_frames": n_frames, **kw}
    if name in TRACK_POLICIES:
        spec["workload"] = {"kind": "track"}
    return spec


def fleet_cases() -> dict:
    """Case name -> (ScenarioSpec JSON, SweepGrid JSON) for every
    batched_multi policy: sub-grids of tests/test_sim_multi_batch.py's
    golden grids at 16 frames — the small grid (:93-107), the planner grid
    (:218-228), the piecewise shared link (:363-418), capacity 0 and a
    backlog-gated starved link (:272-296), weights and priority tiers
    (:299-326)."""
    small = {"trace": {"kind": "constant", "mbps": 6.0}, "fleet": {"n_clients": 2, "capacity": 2}}
    cases = {}
    for name in FLEET_PARAMS:
        spec = lambda **kw: fleet_spec(name, FLEET_GOLD_FRAMES, **kw)  # noqa: E731
        cases[f"{name}/small"] = (spec(**small), {"bandwidth_mbps": [2.5, 12.0],
                                                  "allocation": ["weighted_fair", "fifo"]})
        cases[f"{name}/planner"] = (spec(**small), {"bandwidth_mbps": [1.0, 9.0], "n_clients": [4],
                                                    "allocation": ALLOCATIONS3})
        cases[f"{name}/piecewise"] = (spec(trace={"kind": "piecewise", "points": FLEET_PIECEWISE},
                                           fleet={"n_clients": 2, "capacity": 2}),
                                      {"n_clients": [3], "allocation": ALLOCATIONS3})
        cases[f"{name}/capacity"] = (spec(**{**small, "fleet": {"n_clients": 2, "capacity": 0}}),
                                     {"allocation": ["weighted_fair", "fifo"]})
        cases[f"{name}/backlog"] = (spec(trace={"kind": "constant", "mbps": 1.0},
                                         fleet={"n_clients": 3, "capacity": 2, "backlog_limit": 0.05}),
                                    {"allocation": ["weighted_fair"]})
        cases[f"{name}/weights"] = (spec(trace={"kind": "constant", "mbps": 9.0},
                                         fleet={"n_clients": 4, "allocation": "priority", "capacity": 1,
                                                "weights": [3.0, 1.0, 1.0, 0.5], "priorities": [0, 0, 2, 2]}),
                                    {"bandwidth_mbps": [4.0, 9.0]})
    return cases


def fleet_row(streams, meta) -> list:
    """One fleet point: each client's frames total, processed, missed,
    offloaded, planner calls and accuracy sum, then the server's jobs and
    utilization and the scheduler's grants and denials."""
    return [[s.frames_total, s.frames_processed, s.frames_missed_deadline, s.frames_offloaded, s.schedule_calls,
             s.accuracy_sum] for s in streams] + [meta["server_jobs"], meta["server_utilization"], meta["grants"],
                                                   meta["denials"]]


def fleet_rows(report) -> list:
    """:func:`fleet_row` of every point of a fleet SweepReport."""
    return [fleet_row(p.streams, p.meta) for p in report.points]


def fleet_table(session, run) -> dict:
    """Every case of :func:`fleet_cases` through ``run(spec, grid)``."""
    return {name: fleet_rows(run(session.ScenarioSpec.from_json(spec), session.SweepGrid.from_json(grid)))
            for name, (spec, grid) in fleet_cases().items()}


def fleet_agree(name: str, got: list, want: list, tol: float) -> bool:
    """The reference's fleet contract: integer stats, server jobs, grants
    and denials exact, accuracy sums and server utilization within ``tol``
    (MULTI_TOL); with equal weights (every case but ``*/weights``), every
    field bit-equal."""
    if not name.endswith("/weights"):
        return got == want
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w) or g[-4] != w[-4] or g[-2:] != w[-2:] or abs(g[-3] - w[-3]) > tol:
            return False
        for gc, wc in zip(g[:-4], w[:-4]):
            if gc[:5] != wc[:5] or abs(gc[5] - wc[5]) > tol:
                return False
    return True


def fleet_scenarios(core, session, spec, grid, every: int):
    """The fleet engine's scenarios for every ``every``-th grid point, as
    run_sweep builds them."""
    specs = [session._apply_point(spec, p) for p in grid.points()[::every]]
    return [core.sim_multi_batch.FleetScenario(
        stream=s.stream, n_frames=s.n_frames, bw_segments=s.trace.segments(), rtt=s.trace.rtt_s,
        n_clients=s.fleet.n_clients, allocation=s.fleet.allocation, capacity=s.fleet.capacity,
        backlog_limit=s.fleet.backlog_limit, weights=s.fleet.weights, priorities=s.fleet.priorities,
        params=s.policy.params, workload=s.workload) for s in specs]


def phase_fleet(torch, core, session, smi: str) -> None:
    """The seven batched_multi policies through ``Session.run_sweep`` on fleet
    grids on the card: FLEET_GOLDENS, then the multistream bench's widths
    against the per-point run_multi loop on the card and the host CPU."""
    t_phase = time.perf_counter()
    tol = core.sim_multi_batch.MULTI_TOL

    def batched(spec, grid):
        report = session.Session(spec, device=DEVICE).run_sweep(grid, backend="batched")
        check(report.meta.get("engine") == "sim_multi_batch", f"fleet sweep ran on {report.meta.get('engine')}")
        return report

    table = fleet_table(session, batched)
    bad = sorted(n for n in FLEET_GOLDENS if not fleet_agree(n, table.get(n, []), FLEET_GOLDENS[n], tol))
    for name in bad:
        log(f"fleet: {name}: port {table.get(name)} reference {FLEET_GOLDENS[name]}")
    check(table.keys() == FLEET_GOLDENS.keys(), f"fleet cases {sorted(table)} != FLEET_GOLDENS")
    check(not bad, f"fleet results differ from the reference's at {bad}")
    ONE_RANK["fleet"] = table[MESH_FLEET]
    bit_equal = sum(g == w for n in table for g, w in zip(table[n], FLEET_GOLDENS[n]))
    log(f"fleet: {sum(map(len, table.values()))} golden points of {len(table)} cases hold the reference's "
        f"contract on device={DEVICE} ({bit_equal} bit-equal in every field) in {time.perf_counter() - t_phase:.1f} s")

    for name in FLEET_PARAMS:
        spec = session.ScenarioSpec.from_json(fleet_spec(name, FLEET_FRAMES, FLEET_WIDE_PARAMS.get(name), **FLEET_BASE))
        grid = session.SweepGrid.from_json(FLEET_GRID if name in FLEET_WIDE else FLEET_SMALL_GRID)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        first, s1 = timed(torch, lambda: batched(spec, grid))
        second, s2 = timed(torch, lambda: batched(spec, grid))
        check(fleet_rows(first) == fleet_rows(second), f"{name}: two runs of the same fleet grid differ")
        peak = (torch.cuda.max_memory_allocated() - held) / 2**20 if DEVICE == "cuda" else float("nan")
        n = len(second.points)
        check(n == len(grid), f"{name}: {n} fleet points")
        groups = second.meta["groups"]
        rounds = sum(g["rounds"] for g in groups)
        reads = sum(g["host_reads"] for g in groups)
        replays = sum(g.get("drain_replays", 0) for g in groups)
        check(reads == rounds + len(groups), f"{name}: host reads {reads} != rounds {rounds} + groups {len(groups)}")
        # Every FLEET_SAMPLE_EVERY-th point: the per-point loop on the card,
        # and the same engine on the host CPU.
        pts = grid.points()[::FLEET_SAMPLE_EVERY]
        loop_rows, s_loop = [], 0.0
        for pt in pts:
            one = session._apply_point(spec, pt)
            rep, s = timed(torch, lambda: session.Session(one, device=DEVICE).run_multi())
            loop_rows.append(fleet_row(rep.streams, rep.meta))
            s_loop += s
        card_rows = fleet_rows(second)[::FLEET_SAMPLE_EVERY]
        loop_bad = sum(not fleet_agree(f"{name}/weights", [g], [w], tol) for g, w in zip(card_rows, loop_rows))
        bit_loop = sum(g == w for g, w in zip(card_rows, loop_rows))
        check(loop_bad == 0, f"{name}: the fleet engine differs from the per-point loop at {loop_bad} points")
        scens = fleet_scenarios(core, session, spec, grid, FLEET_SAMPLE_EVERY)
        cpu, s_cpu = timed(torch, lambda: core.sim_multi_batch.simulate_multi_batch(
            name, list(spec.models), scens, device="cpu"))
        cpu_rows = [fleet_row(ms.per_client, {"server_jobs": ms.server_jobs,
                                              "server_utilization": ms.server_utilization, **m}) for ms, m in cpu]
        check(cpu_rows == card_rows, f"{name}: the card and the host CPU differ on the fleet grid")
        log(f"fleet: {name}: {n} points x {FLEET_FRAMES} frames on device={DEVICE}: {1e3 * s1 / n:.3f} ms/point "
            f"(first call), {1e3 * s2 / n:.3f} (second); per-point run_multi loop on device={DEVICE} {1e3 * s_loop / len(pts):.3f} ms/point over "
            f"{len(pts)} points ({bit_loop} bit-equal, all within the contract); host CPU "
            f"{1e3 * s_cpu / len(cpu):.3f} ms/point, bit-equal; {len(groups)} groups, rounds per group mean "
            f"{rounds / len(groups):.1f} max {max(g['rounds'] for g in groups)}, host reads per round "
            f"{(reads - len(groups)) / rounds:.3f} (+1 per group), drain replays {replays} "
            f"({100 * replays / rounds:.1f}% of rounds at E = {core.sim_multi_batch.DRAIN_EVENTS}), peak card "
            f"memory {peak:.1f} MiB above what earlier phases hold ({smi})")
    if DEVICE == "cuda":
        profile_fleet_round(torch, core, session, smi)
    log(f"fleet: phase wall {time.perf_counter() - t_phase:.1f} s ({smi})")


def profile_fleet_round(torch, core, session, smi: str) -> None:
    """Where a fleet round's time goes: the full-width max_accuracy group
    of 8-client weighted_fair fleets at deadline 200 ms (W = 6, 14 lanes),
    its rounds replayed as CUDA graphs and issued eagerly: wall time of a
    run that builds its lane program afresh (and captures its graphs), of
    a second run, and the device's busy time from torch.profiler in a
    third."""
    from torch.profiler import ProfilerActivity, profile

    spec = session.ScenarioSpec.from_json(fleet_spec("max_accuracy", FLEET_FRAMES, FLEET_WIDE_PARAMS["max_accuracy"],
                                                     **FLEET_BASE))
    grid = session.SweepGrid.from_json({**FLEET_GRID, "deadline_ms": [200.0], "n_clients": [8],
                                        "allocation": ["weighted_fair"]})
    scens = fleet_scenarios(core, session, spec, grid, 1)
    run = lambda groups=None: core.sim_multi_batch.simulate_multi_batch(  # noqa: E731
        "max_accuracy", list(spec.models), scens, device=DEVICE, groups=groups)
    shard = core.sweep_shard
    eager = mock.patch.object(shard.LaneProgram, "start", lambda prog: prog.init())  # never captures
    for label, mode in (("graphed", contextlib.nullcontext()), ("eager", eager)):
        with mode, mock.patch.object(shard, "PROGRAMS", shard.LaneCache()):
            groups = []
            _, wall = timed(torch, lambda: run(groups))
            _, again = timed(torch, run)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        (g,) = groups
        log(f"fleet: profile, max_accuracy group {g['key']} of {g['lanes']} lanes over {FLEET_FRAMES} frames, "
            f"rounds {label}: {g['rounds']} rounds and {g['drain_replays']} drain replays in {1e3 * wall:.1f} ms "
            f"built afresh, {1e3 * again:.1f} ms again ({1e3 * again / g['rounds']:.3f} ms a round); device busy "
            f"{busy:.1f} ms, {100 * busy / (1e3 * again):.1f}% of the second run's wall ({smi})")


# ---------------------------------------------------------------------------
# 12. cache: the per-shape cache of captured lane programs
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


def mesh_rank(rank: int, world: int, workdir: str, settings: dict) -> None:
    """One rank of the mesh phase, in a spawned process: takes the parent's
    ``settings`` (this module's constants, which a rehearsal on the CPU
    cuts), joins the gloo group, runs :func:`mesh_checks` and writes its
    result as ``rank{rank}.json`` in ``workdir``.  It catches nothing: a
    failure is the process's non-zero exit.  After a barrier and the
    group's teardown it leaves with ``os._exit``: gloo's teardown during
    interpreter exit aborts a rank now and then (``terminate called without
    an active exception``)."""
    import torch
    import torch.distributed as dist

    globals().update(settings)
    sys.path.insert(0, str(ROOT / "src"))
    if DEVICE == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", store=dist.FileStore(str(Path(workdir) / "store"), world), rank=rank,
                            world_size=world)
    out = mesh_checks(torch, rank, world, Path(workdir))
    dist.barrier()
    dist.destroy_process_group()
    (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(out))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def mesh_checks(torch, rank: int, world: int, workdir: Path) -> dict:
    """(a)-(d) of the mesh phase on this rank; what the parent compares."""
    import numpy as np
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch import checkpoint as ck
    from repro_torch import configs, scenariogen, session
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.npu_matmul import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.sharding import MeshRules, train_rules

    ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
    groups, seconds = [], {}

    def run(spec, grid, mode="auto"):
        report = session.Session(session.ScenarioSpec.from_json(spec), device=DEVICE).run_sweep(
            session.SweepGrid.from_json(grid), backend="batched", mode=mode)
        groups.extend({k: g.get(k) for k in ("lanes", "world", "rank_lanes", "rounds", "host_reads")}
                      for g in report.meta["groups"])
        return report

    t = time.perf_counter()
    out = {"rank": rank, "device": torch.cuda.current_device() if DEVICE == "cuda" else None,
           "sweep": {name: sweep_rows(run(spec, grid)) for name, (spec, grid) in sweep_cases().items()},
           "online": online_rows(run(*online_cases(scenariogen)[MESH_ONLINE], mode="online")),
           "fleet": fleet_rows(run(*fleet_cases()[MESH_FLEET]))}
    seconds["goldens"] = time.perf_counter() - t
    large, seconds["large"] = timed(torch, lambda: run(*full_grids(MESH_LARGE)[-1]))
    out["large"] = [stats_rows(p.streams) for p in large.points]

    # (c) the parent's checkpoint onto a (2, 2) mesh: every local shard is
    # the slice of the saved array that the leaf's placements give this
    # rank's mesh coordinate, nested in mesh-dim order.
    t = time.perf_counter()
    name, shape = MESH_CKPT
    specs = steps.build_cell(configs.get(name, smoke=True), shape).arg_specs[0]
    mesh = make_host_mesh(data=2, model=2, device=DEVICE)
    rules = MeshRules(mesh, train_rules(mesh))
    like = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=DEVICE), specs)
    restored, _ = ck.restore_resharded(workdir / "ckpt", 1, like, rules.tree_shardings(specs))
    coord = mesh.device_mesh.get_coordinate()
    equal = sharded = 0
    for key, leaf in zip(ck.store._paths(specs), tree_leaves(restored)):
        want = torch.from_numpy(np.load(workdir / "ckpt" / f"step_{1:08d}" / f"{key}.npy"))
        for i, p in enumerate(leaf.placements):
            if p.is_shard():
                size = want.shape[p.dim] // mesh.axis_sizes[i]
                want = want.narrow(p.dim, coord[i] * size, size)
        local = leaf.to_local()
        equal += local.device.type == DEVICE and torch.equal(local.cpu(), want)
        sharded += tuple(local.shape) != tuple(leaf.shape)
    out["restore"] = {"coord": coord, "leaves": len(tree_leaves(specs)), "equal": equal, "sharded": sharded}
    seconds["restore"] = time.perf_counter() - t

    # (d) constrain on the card: replicated -> Shard(0) on data -> replicated.
    t = time.perf_counter()
    mesh = make_host_mesh(data=world, model=1, device=DEVICE)
    rules = MeshRules(mesh, train_rules(mesh))
    x = torch.arange(float(8 * world * 16), device=DEVICE).reshape(8 * world, 16)
    split = rules.constrain(distribute_tensor(x, mesh.device_mesh, [Replicate(), Replicate()], src_data_rank=None),
                            ("batch", None))
    whole = rules.constrain(split, (None, None))
    out["constrain"] = {"placements": [str(split.placements), str(whole.placements)],
                        "split": split.device.type == DEVICE and torch.equal(split.to_local(), x[8 * rank: 8 * rank + 8]),
                        "whole": whole.device.type == DEVICE and torch.equal(whole.to_local(), x)}
    seconds["constrain"] = time.perf_counter() - t
    out.update(groups=groups, seconds=seconds,
               launches=[ops.int8_matmul.launches, flash_ops.flash_attention.launches])
    return out


def check_ranks(torch, core, ranks: list) -> None:
    """The parent's verdict on the mesh phase's rank results (``ranks``, one
    :func:`mesh_checks` dict a rank) against the goldens and ONE_RANK."""
    tol, multi_tol = core.audit.AUDIT_TOL, core.sim_multi_batch.MULTI_TOL
    large_rows = ONE_RANK["large"][0]
    for r in ranks:
        rank = r["rank"]
        check(DEVICE != "cuda" or r["device"] == rank % torch.cuda.device_count(),
              f"mesh: rank {rank} ran on cuda:{r['device']}")
        bad = sorted(n for n in SWEEP_GOLDENS if not sweep_agree(n, r["sweep"].get(n, []), SWEEP_GOLDENS[n], tol))
        check(not bad, f"mesh: rank {rank}'s sweep results differ from the reference's at {bad}")
        check(r["sweep"] == ONE_RANK["sweep"], f"mesh: rank {rank}'s sweep goldens differ from one rank's")
        check(online_agree(r["online"], ONLINE_GOLDENS[MESH_ONLINE], tol) and r["online"] == ONE_RANK["online"],
              f"mesh: rank {rank}'s {MESH_ONLINE} online grid differs")
        check(fleet_agree(MESH_FLEET, r["fleet"], FLEET_GOLDENS[MESH_FLEET], multi_tol)
              and r["fleet"] == ONE_RANK["fleet"], f"mesh: rank {rank}'s {MESH_FLEET} fleet grid differs")
        check(r["large"] == large_rows, f"mesh: rank {rank}'s {MESH_LARGE} full-width stats differ from one rank's")
        lanes = [g["lanes"] for g in r["groups"]]
        check(all(g["world"] == MESH_RANKS and g["rank_lanes"] == -(-g["lanes"] // MESH_RANKS) for g in r["groups"]),
              f"mesh: rank {rank} ran a group unsharded")
        check(any(n < MESH_RANKS for n in lanes) and any(n > MESH_RANKS and n % MESH_RANKS for n in lanes)
              and any(n % MESH_RANKS == 0 for n in lanes),
              f"mesh: rank {rank}'s groups miss a lane count below, off or on a multiple of {MESH_RANKS}: {lanes}")
        rs = r["restore"]
        check(rs["equal"] == rs["leaves"] and rs["sharded"] > 0,
              f"mesh: rank {rank} restored {rs['equal']} of {rs['leaves']} leaves as the saved slices "
              f"({rs['sharded']} sharded)")
        c = r["constrain"]
        check(c["placements"] == ["(Shard(dim=0), Replicate())", "(Replicate(), Replicate())"]
              and c["split"] and c["whole"], f"mesh: rank {rank}'s constrain round trip: {c}")
        check(r["launches"] == [0, 0], f"mesh: rank {rank} launched a model kernel: {r['launches']}")
    check(sorted(r["rank"] for r in ranks) == list(range(MESH_RANKS)), "mesh: a rank's result is missing")
    check(sorted(tuple(r["restore"]["coord"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)],
          "mesh: the restore's coordinates do not cover the (2, 2) mesh")


def phase_mesh(torch, core, session, scenariogen, configs, steps, smi: str) -> list:
    """MESH_RANKS spawned ranks of the port share the card (see MESH_RANKS):
    every rank's results must equal the goldens and the earlier phases'
    one-rank results, its groups' lanes must spread over the ranks, its
    restored shards must be the saved arrays' slices, its constrain round
    trip exact, and it must launch neither kernel (:func:`check_ranks`).
    Returns the ranks' results."""
    import multiprocessing
    import tempfile

    from repro_torch import checkpoint as ck

    t_phase = time.perf_counter()
    if len(ONE_RANK) < 4:  # the phase run alone: the one-rank results here
        batched = lambda spec, grid, mode="auto": session.Session(  # noqa: E731
            session.ScenarioSpec.from_json(spec), device=DEVICE).run_sweep(
            session.SweepGrid.from_json(grid), backend="batched", mode=mode)
        ONE_RANK["sweep"] = {name: sweep_rows(batched(*case)) for name, case in sweep_cases().items()}
        ONE_RANK["online"] = online_rows(batched(*online_cases(scenariogen)[MESH_ONLINE], mode="online"))
        ONE_RANK["fleet"] = fleet_rows(batched(*fleet_cases()[MESH_FLEET]))
        large, s1 = timed(torch, lambda: batched(*full_grids(MESH_LARGE)[-1]))
        ONE_RANK["large"] = ([stats_rows(p.streams) for p in large.points], s1)
    name, shape = MESH_CKPT
    with tempfile.TemporaryDirectory() as workdir:
        cell = steps.build_cell(configs.get(name, smoke=True), shape)
        ck.save(Path(workdir) / "ckpt", 1, cell.init_arg(0, SEED, "cpu"))
        ctx = multiprocessing.get_context("spawn")
        settings = {k: v for k, v in globals().items() if k.isupper() and k != "ONE_RANK"}
        procs = [ctx.Process(target=mesh_rank, args=(r, MESH_RANKS, workdir, settings)) for r in range(MESH_RANKS)]
        t_ranks = time.perf_counter()
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(max(MESH_TIMEOUT - (time.perf_counter() - t_ranks), 0.0))
            s_ranks = time.perf_counter() - t_ranks
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            check(not alive, f"mesh: ranks {alive} still running after {MESH_TIMEOUT} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * MESH_RANKS, f"mesh: the ranks exited {codes}")
        ranks = [json.loads((Path(workdir) / f"rank{r}.json").read_text()) for r in range(MESH_RANKS)]

    check_ranks(torch, core, ranks)
    large_rows, s1 = ONE_RANK["large"]
    n = len(large_rows)
    s4 = max(r["seconds"]["large"] for r in ranks)
    lane_counts = sorted({g["lanes"] for g in ranks[0]["groups"]})
    log(f"mesh: {MESH_RANKS} ranks sharing the card ({smi}): every rank holds the sweep goldens "
        f"({sum(map(len, ONE_RANK['sweep'].values()))} points), {MESH_ONLINE} online and {MESH_FLEET} fleet, equal "
        f"to one rank's field for field; groups of {lane_counts} lanes; {MESH_LARGE} {n} points x {SWEEP_FRAMES} "
        f"frames under SWEEP_TRACE: {1e3 * s4 / n:.3f} ms/point on {MESH_RANKS} ranks (first call, slowest rank) "
        f"against {1e3 * s1 / n:.3f} on one (the sweep phase's first call), stats equal; restore_resharded of {name} SMOKE "
        f"({ranks[0]['restore']['leaves']} leaves, {ranks[0]['restore']['sharded']} sharded on each rank) onto (2, 2) "
        f"equal to the saved slices; constrain Shard(0) -> Replicate on the card exact; no kernel launch; ranks "
        f"{s_ranks:.1f} s (" + ", ".join(f"{k} {max(r['seconds'][k] for r in ranks):.1f}"
                                   for k in ranks[0]["seconds"]) + f" s, slowest rank); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return ranks


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

# The reference's numbers for every case of fleet_cases(), from its per-point
# run_multi loop (tests/test_torch_fleet_goldens.py checks this table against
# ``repro``): per point, per client [frames total, processed, missed,
# offloaded, planner calls, accuracy sum], then [server jobs, server
# utilization, grants, denials].
FLEET_GOLDENS = {'offload/small': [[[16, 8, 0, 8, 16, 1.5999999999999999], [16, 0, 0, 0, 16, 0.0], 8, 1.0350000000000001, 8, 24],
                   [[16, 1, 15, 1, 16, 0.2], [16, 1, 15, 1, 16, 0.2], 32, 4.139999999999998, 32, 0],
                   [[16, 8, 0, 8, 16, 3.36], [16, 0, 0, 0, 16, 0.0], 8, 1.0350000000000001, 8, 24],
                   [[16, 0, 16, 0, 16, 0.0], [16, 0, 16, 0, 16, 0.0], 32, 4.139999999999998, 32, 0]],
 'offload/planner': [[[16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      0,
                      0.0,
                      64,
                      0],
                     [[16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      0,
                      0.0,
                      64,
                      0],
                     [[16, 0, 16, 0, 16, 0.0],
                      [16, 0, 16, 0, 16, 0.0],
                      [16, 0, 16, 0, 16, 0.0],
                      [16, 0, 16, 0, 16, 0.0],
                      64,
                      8.279999999999996,
                      64,
                      0],
                     [[16, 8, 0, 8, 16, 1.5999999999999999],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      8,
                      1.0350000000000001,
                      8,
                      56],
                     [[16, 8, 0, 8, 16, 1.5999999999999999],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      8,
                      1.0350000000000001,
                      8,
                      56],
                     [[16, 0, 16, 0, 16, 0.0],
                      [16, 0, 16, 0, 16, 0.0],
                      [16, 0, 16, 0, 16, 0.0],
                      [16, 0, 16, 0, 16, 0.0],
                      64,
                      8.279999999999996,
                      64,
                      0]],
 'offload/piecewise': [[[16, 8, 0, 8, 16, 2.0500000000000003],
                        [16, 0, 0, 0, 16, 0.0],
                        [16, 0, 0, 0, 16, 0.0],
                        8,
                        0.4725000000000001,
                        23,
                        25],
                       [[16, 8, 0, 8, 16, 2.0500000000000003],
                        [16, 0, 0, 0, 16, 0.0],
                        [16, 0, 0, 0, 16, 0.0],
                        8,
                        0.4725000000000001,
                        23,
                        25],
                       [[16, 0, 16, 0, 16, 0.0],
                        [16, 0, 16, 0, 16, 0.0],
                        [16, 0, 16, 0, 16, 0.0],
                        48,
                        6.209999999999996,
                        48,
                        0]],
 'offload/capacity': [[[16, 0, 0, 0, 16, 0.0], [16, 0, 0, 0, 16, 0.0], 0, 0.0, 0, 32],
                      [[16, 0, 16, 0, 16, 0.0], [16, 0, 16, 0, 16, 0.0], 32, 4.139999999999998, 32, 0]],
 'offload/backlog': [[[16, 0, 0, 0, 16, 0.0], [16, 0, 0, 0, 16, 0.0], [16, 0, 0, 0, 16, 0.0], 0, 0.0, 48, 0]],
 'offload/weights': [[[16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 6, 0, 6, 16, 1.2],
                      [16, 0, 0, 0, 16, 0.0],
                      6,
                      0.7762500000000001,
                      6,
                      58],
                     [[16, 0, 0, 0, 16, 0.0],
                      [16, 0, 0, 0, 16, 0.0],
                      [16, 6, 0, 6, 16, 2.52],
                      [16, 0, 0, 0, 16, 0.0],
                      6,
                      0.7762500000000001,
                      6,
                      58]],
 'max_accuracy/small': [[[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 6, 0],
                        [[16, 14, 2, 0, 4, 7.059999999999999],
                         [16, 14, 2, 0, 4, 7.059999999999999],
                         4,
                         0.06749999999999999,
                         8,
                         0],
                        [[16, 16, 0, 2, 4, 8.11], [16, 16, 0, 2, 4, 7.999999999999999], 4, 0.06749999999999999, 7, 1],
                        [[16, 0, 16, 0, 16, 0.0], [16, 0, 16, 0, 16, 0.0], 32, 4.139999999999998, 32, 0]],
 'max_accuracy/planner': [[[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 0, 16, 0, 16, 0.0],
                           [16, 0, 16, 0, 16, 0.0],
                           [16, 0, 16, 0, 16, 0.0],
                           [16, 0, 16, 0, 16, 0.0],
                           64,
                           8.279999999999996,
                           64,
                           0]],
 'max_accuracy/piecewise': [[[16, 16, 0, 2, 4, 7.859999999999999],
                             [16, 16, 0, 0, 3, 7.77],
                             [16, 16, 0, 0, 3, 7.77],
                             2,
                             0.033749999999999995,
                             8,
                             2],
                            [[16, 16, 0, 2, 4, 7.859999999999999],
                             [16, 16, 0, 0, 3, 7.77],
                             [16, 16, 0, 0, 3, 7.77],
                             2,
                             0.033749999999999995,
                             8,
                             2],
                            [[16, 12, 4, 0, 6, 6.02],
                             [16, 12, 4, 0, 6, 6.02],
                             [16, 12, 4, 0, 6, 6.02],
                             12,
                             1.5524999999999998,
                             18,
                             0]],
 'max_accuracy/capacity': [[[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 0, 6],
                           [[16, 14, 2, 0, 4, 7.169999999999998],
                            [16, 14, 2, 0, 4, 7.169999999999998],
                            4,
                            0.06749999999999999,
                            8,
                            0]],
 'max_accuracy/backlog': [[[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 9, 0]],
 'max_accuracy/weights': [[[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           6,
                           6],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           6,
                           6]],
 'max_utility/small': [[[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 6, 0],
                       [[16, 14, 2, 0, 3, 7.059999999999999],
                        [16, 14, 2, 0, 3, 7.059999999999999],
                        4,
                        0.06749999999999999,
                        6,
                        0],
                       [[16, 16, 0, 2, 3, 7.899999999999999], [16, 16, 0, 0, 3, 7.66], 2, 0.25875000000000004, 4, 2],
                       [[16, 12, 3, 0, 3, 6.239999999999998],
                        [16, 12, 3, 0, 3, 6.239999999999998],
                        6,
                        0.7762500000000001,
                        6,
                        0]],
 'max_utility/planner': [[[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 12, 3, 0, 3, 6.239999999999998],
                          [16, 12, 3, 0, 3, 6.239999999999998],
                          [16, 12, 3, 0, 3, 6.239999999999998],
                          [16, 12, 3, 0, 3, 6.239999999999998],
                          12,
                          1.5524999999999998,
                          12,
                          0]],
 'max_utility/piecewise': [[[16, 16, 0, 1, 3, 7.76],
                            [16, 16, 0, 0, 3, 7.66],
                            [16, 16, 0, 0, 3, 7.66],
                            1,
                            0.016874999999999998,
                            7,
                            2],
                           [[16, 16, 0, 1, 3, 7.76],
                            [16, 16, 0, 0, 3, 7.66],
                            [16, 16, 0, 0, 3, 7.66],
                            1,
                            0.016874999999999998,
                            7,
                            2],
                           [[16, 15, 1, 0, 3, 7.359999999999999],
                            [16, 15, 1, 0, 3, 7.359999999999999],
                            [16, 15, 1, 0, 3, 7.359999999999999],
                            3,
                            0.38812500000000005,
                            9,
                            0]],
 'max_utility/capacity': [[[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 0, 6],
                          [[16, 14, 2, 0, 3, 7.059999999999999],
                           [16, 14, 2, 0, 3, 7.059999999999999],
                           4,
                           0.5175000000000001,
                           6,
                           0]],
 'max_utility/backlog': [[[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 9, 0]],
 'max_utility/weights': [[[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          6,
                          6],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 2, 3, 7.899999999999999],
                          [16, 16, 0, 0, 3, 7.66],
                          2,
                          0.25875000000000004,
                          4,
                          8]],
 'jax_accuracy/small': [[[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 6, 0],
                        [[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 6, 0],
                        [[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 6, 0],
                        [[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 6, 0]],
 'jax_accuracy/planner': [[[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           12,
                           0]],
 'jax_accuracy/piecewise': [[[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 9, 0],
                            [[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 9, 0],
                            [[16, 16, 0, 0, 3, 7.77],
                             [16, 16, 0, 0, 3, 7.77],
                             [16, 16, 0, 0, 3, 7.77],
                             0,
                             0.0,
                             9,
                             0]],
 'jax_accuracy/capacity': [[[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 0, 6],
                           [[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 6, 0]],
 'jax_accuracy/backlog': [[[16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], [16, 16, 0, 0, 3, 7.77], 0, 0.0, 9, 0]],
 'jax_accuracy/weights': [[[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           6,
                           6],
                          [[16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           [16, 16, 0, 0, 3, 7.77],
                           0,
                           0.0,
                           6,
                           6]],
 'jax_utility/small': [[[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 6, 0],
                       [[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 6, 0],
                       [[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 6, 0],
                       [[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 6, 0]],
 'jax_utility/planner': [[[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          12,
                          0]],
 'jax_utility/piecewise': [[[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 9, 0],
                           [[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 9, 0],
                           [[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 9, 0]],
 'jax_utility/capacity': [[[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 0, 6],
                          [[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 6, 0]],
 'jax_utility/backlog': [[[16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], [16, 16, 0, 0, 3, 7.66], 0, 0.0, 9, 0]],
 'jax_utility/weights': [[[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          6,
                          6],
                         [[16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          [16, 16, 0, 0, 3, 7.66],
                          0,
                          0.0,
                          6,
                          6]],
 'track_accuracy/small': [[[16, 16, 0, 0, 8, 7.696], [16, 16, 0, 0, 8, 7.696], 0, 0.0, 16, 0],
                          [[16, 16, 0, 0, 8, 7.696], [16, 16, 0, 0, 8, 7.696], 0, 0.0, 16, 0],
                          [[16, 16, 0, 0, 8, 7.696], [16, 16, 0, 0, 8, 7.696], 0, 0.0, 16, 0],
                          [[16, 0, 16, 0, 16, 0.0], [16, 0, 16, 0, 16, 0.0], 32, 4.139999999999998, 32, 0]],
 'track_accuracy/planner': [[[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             32,
                             0],
                            [[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             32,
                             0],
                            [[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             32,
                             0],
                            [[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             32,
                             0],
                            [[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             32,
                             0],
                            [[16, 0, 16, 0, 16, 0.0],
                             [16, 0, 16, 0, 16, 0.0],
                             [16, 0, 16, 0, 16, 0.0],
                             [16, 0, 16, 0, 16, 0.0],
                             64,
                             8.279999999999996,
                             64,
                             0]],
 'track_accuracy/piecewise': [[[16, 16, 0, 0, 8, 7.696],
                               [16, 16, 0, 0, 8, 7.696],
                               [16, 16, 0, 0, 8, 7.696],
                               0,
                               0.0,
                               24,
                               0],
                              [[16, 16, 0, 0, 8, 7.696],
                               [16, 16, 0, 0, 8, 7.696],
                               [16, 16, 0, 0, 8, 7.696],
                               0,
                               0.0,
                               24,
                               0],
                              [[16, 12, 4, 0, 10, 5.772],
                               [16, 12, 4, 0, 10, 5.772],
                               [16, 12, 4, 0, 10, 5.772],
                               12,
                               1.5524999999999998,
                               30,
                               0]],
 'track_accuracy/capacity': [[[16, 16, 0, 0, 8, 7.696], [16, 16, 0, 0, 8, 7.696], 0, 0.0, 0, 16],
                             [[16, 16, 0, 0, 8, 7.696], [16, 16, 0, 0, 8, 7.696], 0, 0.0, 16, 0]],
 'track_accuracy/backlog': [[[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             24,
                             0]],
 'track_accuracy/weights': [[[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             16,
                             16],
                            [[16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             [16, 16, 0, 0, 8, 7.696],
                             0,
                             0.0,
                             16,
                             16]],
 'track_fixed/small': [[[16, 16, 0, 0, 6, 7.208500000000001], [16, 16, 0, 0, 6, 7.208500000000001], 0, 0.0, 12, 0],
                       [[16, 16, 0, 0, 6, 7.208500000000001], [16, 16, 0, 0, 6, 7.208500000000001], 0, 0.0, 12, 0],
                       [[16, 16, 0, 0, 6, 7.208500000000001], [16, 16, 0, 0, 6, 7.208500000000001], 0, 0.0, 12, 0],
                       [[16, 10, 6, 0, 6, 0.0], [16, 10, 6, 0, 6, 0.0], 12, 1.5524999999999998, 12, 0]],
 'track_fixed/planner': [[[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          24,
                          0],
                         [[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          24,
                          0],
                         [[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          24,
                          0],
                         [[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          24,
                          0],
                         [[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          24,
                          0],
                         [[16, 10, 6, 0, 6, 0.0],
                          [16, 10, 6, 0, 6, 0.0],
                          [16, 10, 6, 0, 6, 0.0],
                          [16, 10, 6, 0, 6, 0.0],
                          24,
                          3.1049999999999986,
                          24,
                          0]],
 'track_fixed/piecewise': [[[16, 16, 0, 0, 6, 7.208500000000001],
                            [16, 16, 0, 0, 6, 7.208500000000001],
                            [16, 16, 0, 0, 6, 7.208500000000001],
                            0,
                            0.0,
                            18,
                            0],
                           [[16, 16, 0, 0, 6, 7.208500000000001],
                            [16, 16, 0, 0, 6, 7.208500000000001],
                            [16, 16, 0, 0, 6, 7.208500000000001],
                            0,
                            0.0,
                            18,
                            0],
                           [[16, 14, 2, 0, 6, 5.852970012500001],
                            [16, 14, 2, 0, 6, 5.852970012500001],
                            [16, 14, 2, 0, 6, 5.852970012500001],
                            6,
                            0.7762500000000001,
                            18,
                            0]],
 'track_fixed/capacity': [[[16, 16, 0, 0, 6, 7.208500000000001], [16, 16, 0, 0, 6, 7.208500000000001], 0, 0.0, 0, 12],
                          [[16, 16, 0, 0, 6, 7.208500000000001],
                           [16, 16, 0, 0, 6, 7.208500000000001],
                           0,
                           0.0,
                           12,
                           0]],
 'track_fixed/backlog': [[[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          18,
                          0]],
 'track_fixed/weights': [[[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          12,
                          12],
                         [[16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          [16, 16, 0, 0, 6, 7.208500000000001],
                          0,
                          0.0,
                          12,
                          12]]}

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
    from repro_torch import configs, core, data, quant, scenariogen, serving, session
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.npu_matmul import ops, ref
    from repro_torch.launch import dryrun, serve, steps, train
    from repro_torch.models import common, convnets, diffusion, lm, vision
    from repro_torch.models import layers as L
    from repro_torch.serving.calibrate import _median_s
    from repro_torch.train import optim

    t0 = time.perf_counter()
    walls = {}  # phase -> wall seconds

    def phase(name, fn):
        t = time.perf_counter()
        out = fn()
        walls[name] = round(time.perf_counter() - t, 1)
        return out

    smi = phase("environment", lambda: phase_environment(torch, build, [ops.SOURCE, flash_ops.SOURCE]))
    agg, gemm_rows, b7_frame = phase("kernels", lambda: phase_kernels(torch, A, configs, common, ops, ref))
    flash_rows = phase("flash", lambda: phase_flash(torch, flash_ops, flash_ref))
    torch.cuda.empty_cache()
    gemms, attns = set(), set()
    with recording(ops, "int8_matmul", gemm_key, gemms), recording(flash_ops, "flash_attention", flash_key, attns):
        full_launches, t_ms = phase("serve_full", lambda: phase_serve_full(
            torch, A, configs, common, quant, ops, flash_ops, ref, core, serving))
        torch.cuda.empty_cache()
        vit_int8, vit_flash = phase("vit_full", lambda: phase_vit_full(
            torch, A, configs, common, quant, ops, flash_ops, flash_ref, core, serving, _median_s))
        torch.cuda.empty_cache()
        zoo_int8, zoo_flash = phase("zoo_full", lambda: phase_zoo_full(
            torch, A, configs, common, quant, ops, flash_ops, ref, core, serving, _median_s))
        torch.cuda.empty_cache()
        ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
        lm_report = phase("lm_full", lambda: phase_lm_full(
            torch, A, configs, common, steps, lm, L, flash_ops, flash_ref, _median_s))
        lm_int8, lm_flash = ops.int8_matmul.launches, flash_ops.flash_attention.launches
        check(lm_int8 == 0, f"lm_full launched the int8 kernel {lm_int8} times")
        torch.cuda.empty_cache()
        ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
        diff_report = phase("diffusion_full", lambda: phase_diffusion_full(
            torch, A, configs, common, steps, diffusion, flash_ops, flash_ref, _median_s))
        diff_int8, diff_flash = ops.int8_matmul.launches, flash_ops.flash_attention.launches
        check(diff_int8 == 0, f"diffusion_full launched the int8 kernel {diff_int8} times")
        torch.cuda.empty_cache()
        ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
        train_report = phase("train_full", lambda: phase_train_full(
            torch, configs, common, steps, diffusion, L, data, optim, train, (lm, diffusion, convnets, vision)))
        train_launches = (ops.int8_matmul.launches, flash_ops.flash_attention.launches)
        log(f"train_full: kernel launches (int8_matmul, flash_attention) {train_launches}")
        check(train_launches == (0, 0), "train_full launched a model kernel: training runs neither, as the reference")
        torch.cuda.empty_cache()
        serving_int8, serving_flash = phase("serving", lambda: phase_serving(torch, ops, flash_ops, serve, session))
    more_gemms, more_flash = phase("main shapes", lambda: phase_main_shapes(
        torch, ops, ref, flash_ops, flash_ref, gemms - gemm_rows.keys(), attns - flash_rows.keys()))
    readings = dryrun_readings(diff_report, train_report)
    # The dry run traces on meta and the simulators run on profiles, not on
    # models: no kernel launches.
    for name, fn in (("dryrun", lambda: phase_dryrun(dryrun, readings, smi)),
                     ("sim", lambda: phase_sim(torch, core, session, scenariogen, t_ms, smi)),
                     ("sweep", lambda: phase_sweep(torch, core, session, smi)),
                     ("online", lambda: phase_online(torch, core, session, scenariogen, smi)),
                     ("fleet", lambda: phase_fleet(torch, core, session, smi)),
                     ("cache", lambda: phase_cache(torch, core, session, smi)),
                     ("mesh", lambda: phase_mesh(torch, core, session, scenariogen, configs, steps, smi))):
        torch.cuda.empty_cache()
        ops.int8_matmul.launches = flash_ops.flash_attention.launches = 0
        phase(name, fn)
        launches = (ops.int8_matmul.launches, flash_ops.flash_attention.launches)
        log(f"{name}: kernel launches (int8_matmul, flash_attention) {launches}")
        check(launches == (0, 0), f"the {name} phase launched a model kernel")
    wall = time.perf_counter() - t0

    int8_launches = full_launches + vit_int8 + zoo_int8 + serving_int8
    flash_launches = vit_flash + zoo_flash + lm_flash + diff_flash + serving_flash
    log(f"kernels: [int8_matmul: {int8_launches} launches on the main path (serve_full {full_launches}, "
        f"vit_full {vit_int8}, zoo_full {zoo_int8}, lm_full 0, diffusion_full 0, train_full {train_launches[0]}, "
        f"serving {serving_int8}); flash_attention: {flash_launches} launches on the main path (vit_full {vit_flash}, "
        f"zoo_full {zoo_flash}, lm_full {lm_flash}, diffusion_full {diff_flash}, train_full {train_launches[1]}, "
        f"serving {serving_flash})]")
    for name, r in lm_report.items():
        log(f"lm_full summary {name} ({r['layers']} layers): prefill " + ", ".join(
            f"S {S}: {p['ms']:.2f} ms, {p['tokens_per_s']:.0f} tokens/s, {p['launches']} flash launches"
            for S, p in r["prefill"].items()) + f"; decode batch {r['decode']['batch']}: "
            f"{r['decode']['ms_per_step']:.2f} ms a step" + (
                f", int8 cache {r['decode_int8']['ms_per_step']:.2f}" if "decode_int8" in r else "")
            + f"; peak {r.get('peak_gb', 0.0):.2f} GB")
    for name, r in diff_report.items():
        log(f"diffusion_full summary {name} ({r['layers']} attention layers): " + ", ".join(
            f"{s}: batch {p['batch']}, {p['ms']:.2f} ms a step, {p['steps']} steps an image = "
            f"{p['steps'] * p['ms'] / 1e3:.3f} s (computed), {p['batch'] / (p['steps'] * p['ms']) * 1e3:.3f} images/s, "
            f"{p['launches']} flash launches a step, vs plain {p['rel']:.4%} (control {p['control']:.4%})"
            for s, p in r["shapes"].items()) + f"; wrong path {r['wrong']:.4%}; {DIFF_REQUEST} request "
            f"{r['request']['s']:.3f} s; peak {r.get('peak_gb', 0.0):.2f} GB")
    for name, r in train_report.items():
        if name == "restart":
            continue
        a, cut = r["agree"], "whole" if r["depth"] is None else f"depth {r['depth']}"
        log(f"train_full summary {name} ({r['shape']}, {cut}, "
            f"batch {r['batch']}, accum_steps {r['accum']}): {r['ms']:.1f} ms a step, {r['per_s']:.1f} {r['unit']}, "
            f"loss {r['losses'][0]:.5g} -> {r['losses'][-1]:.5g}, card vs CPU loss {a['loss_rel']:.2e} grads "
            f"{a['grad_rel']:.2e} (wrong path {a['wrong_grad_rel']:.2e})"
            + (f", device busy {r['busy_share']:.1%}" if "busy_share" in r else "")
            + f"; peak {r.get('peak_gb', 0.0):.2f} GB")
    # flash at every lm_full and diffusion_full shape, from phase 3 (launches a step where a step has several)
    main_flash = {s: ("LM prefill", None) for s in lm_flash_shapes(A, configs)}
    main_flash |= {s: ("diffusion", attention_layers(configs.get(m).cfg)) for s, m in DIFF_FLASH_SHAPES.items()}
    check(DIFF_FLASH_SHAPES.keys() <= attns, f"DIFF_FLASH_SHAPES not run by diffusion_full: "
          f"{sorted(DIFF_FLASH_SHAPES.keys() - attns)}")
    check(main_flash.keys() <= flash_rows.keys(), f"lm_full / diffusion_full shapes not timed in the flash phase: "
          f"{sorted(main_flash.keys() - flash_rows.keys())}")
    for shape, (what, per_step) in main_flash.items():
        r = flash_rows[shape]
        plain = "not timed (one call would hold all its scores)" if r["plain_ms"] is None else f"{r['plain_ms']:.4f}"
        log(f"flash at {what} shape {shape}: kernel {r['ms']:.4f} ms (eager {r['call_ms']:.4f}), SDPA "
            f"{r['library_ms']:.4f} ({r['ms'] / r['library_ms']:.2f}x), plain {plain}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it; for head dim {shape[5]}, run at {r['width']}), "
            f"{r['blocks']} blocks" + ("" if per_step is None else f"; {per_step} launches a step: "
            f"{per_step * r['ms']:.2f} ms of kernel a step against a bound of {per_step * r['bound_ms']:.2f}"))
    log(f"int8_matmul per frame of {B7} ({ZOO_GEMMS[B7]} calls at batch 1), beside the ResNet-50 + SqueezeNet frame "
        "of the kernels line: " + "  ".join(f"{k}={b7_frame[k]:.4f}" for k in (
            "ms", "plain_ms", "library_ms", "call_ms", "bound_ms", "bytes_ms", "ops_ms")))
    # The flash entry is one frame's attention: the 12 calls of a batch-1
    # ViT-S/16 forward at 224², as the int8 entry sums a frame's GEMMs.
    n_layers = configs.get(VIT).cfg.n_layers
    vit1 = flash_rows[(1, *VIT_SHAPE)]
    log(f"flash per frame ({n_layers} calls at batch 1, (S, T, H, KH, hd, causal, dtype) = {VIT_SHAPE}): "
        + "  ".join(f"{k}={n_layers * vit1[k]:.4f}" for k in ("ms", "plain_ms", "library_ms", "call_ms", "bound_ms")))
    log(f"chip_smoke: phase wall seconds {json.dumps(walls)} ({smi})")
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
        "train_full_launches": train_launches[0],
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
        "train_full_launches": train_launches[1],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
