"""The port's training cells (``launch/steps.build_cell``'s ``train``,
``denoise_train`` and ``classify_train`` kinds) against the reference's, on
the CPU, for smoke configs of every training family: a dense LM, an MoE LM,
DiT, Flux, ResNet (BatchNorm state) and ViT.

Both packages start from the same train state (``reference_params``' numpy
weights and BatchNorm statistics carried across by ``interop.from_jax``,
zero moments, step 0) and take two steps on the same two batches of the
port's ``SyntheticStream``, with ``accum_steps`` 1 and 2.

Tolerances and why:
  * ``step``: equal; the learning rate: rtol 1e-6 (both compute the
    schedule in f32);
  * ``m``, ``v``, BatchNorm state and the loss metrics: within ``RTOL`` =
    1e-4 of each leaf's max|value| (plus ``ATOL`` = 1e-7 for moments of
    gradients that are exactly zero, such as an attention key bias's, which
    read f32 noise), and ``grad_norm`` rtol 1e-4.  Each model module of both
    packages runs through the ``_F32`` stand-in of ``tests/test_torch_lm.py``
    (its ``bfloat16`` is float32), so what differs is f32 summed in another
    order;
  * params: an Adam step moves a weight by about lr whatever the size of its
    gradient, so a weight whose gradient is within f32 noise of zero (a key
    bias's, or one where the batch's terms cancel) may move either way: each
    weight within ``2 · lr`` a step, and the mean |difference| of every leaf
    but the attention key biases (whose exact gradient is zero: softmax is
    invariant to them, so every weight of theirs moves by noise) below
    ``MEAN_PARAM`` = 1% of lr a step.  A wrong update moves most weights by
    about lr.

DiT-XL/2 at full width and 4 of its 28 layers, from the published
adaLN-Zero init (the zero leaves zero), at lr 1e-3: the reference's loss
climbs by its 4th step (chip_smoke's train_full trains DiT at lr 1e-4 for
that reason), and the port's follows it step by step within
``DIT_LOSS_RTOL`` = 1e-2 in bf16 as both run (readings to 0.2%).

Beside the reference: ``accum_steps`` 2 against the full batch
(``tests/test_substrate.py::test_grad_accumulation_matches_full_batch``'s
bounds) and the LM's loss falling on one batch
(``tests/test_models.py::test_lm_train_loss_decreases``), in the port alone
and in bf16 as it runs.
"""
from __future__ import annotations

import dataclasses
import math

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first
from test_torch_lm import _F32  # a torch / jnp whose bfloat16 is float32

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.arch import ShapeSpec as JShapeSpec
from repro.arch import abstract_params as jabstract_params
from repro.launch import steps as jsteps
from repro.models import convnets as jconvnets
from repro.models import diffusion as jdiff
from repro.models import lm as jlm
from repro.models import vision as jvision
from repro.train import optim as joptim
from repro_torch import arch as A
from repro_torch import configs, interop
from repro_torch.data import DataSpec, SyntheticStream
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import steps
from repro_torch.models import common, convnets, diffusion, lm, vision
from repro_torch.train import optim

RTOL = 1e-4
ATOL = 1e-7
MEAN_PARAM = 0.01
STEPS = 2
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
CASES = {  # name -> (kind, batch, seq, img)
    "qwen3-0.6b": ("train", 4, 16, 0),
    "deepseek-moe-16b": ("train", 4, 16, 0),
    "dit-xl2": ("denoise_train", 4, 0, 64),
    "flux-dev": ("denoise_train", 4, 0, 64),
    "resnet-50": ("classify_train", 4, 0, 32),
    "vit-s16": ("classify_train", 4, 0, 32),
}


@pytest.fixture
def f32_mode(monkeypatch):
    for mod, jmod in ((lm, jlm), (diffusion, jdiff), (convnets, jconvnets), (vision, jvision)):
        monkeypatch.setattr(mod, "torch", _F32(torch, torch.float32))
        monkeypatch.setattr(jmod, "jnp", _F32(jnp, jnp.float32))


def _arch(name: str, shape_cls, *, smoke: bool = True, mod=configs):
    kind, batch, seq, img = CASES[name]
    arch = mod.get(name, smoke=smoke)
    return dataclasses.replace(arch, shapes=(shape_cls("t", kind, batch, seq=seq, img=img),))


def _states(name: str, seed: int = 0):
    """(reference train state, port train state) from the same numpy draws."""
    arch_j, params_j, state_j = reference_params(name, seed)
    params, state = interop.from_jax(configs.get(name, smoke=True), params_j, state_j, device=CPU)
    ts_j = {"params": jax.tree.map(jnp.asarray, params_j), "state": jax.tree.map(jnp.asarray, state_j),
            "opt": joptim.init_opt_state(params_j)}
    return ts_j, {"params": params, "state": state, "opt": optim.init_opt_state(params)}


def _paths(tree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}.{k}")]
    return [prefix]


def _close_tree(got, want, what: str, *, lr: float | None = None):
    """Every leaf of ``got`` against ``want`` (the reference's tree, carried
    across by ``interop``): within RTOL of max|want| + ATOL, or for params
    (``lr`` given) within 2 lr a step, mean within MEAN_PARAM lr a step."""
    names, got, want = _paths(got, what), common.tree_leaves(got), common.tree_leaves(want)
    assert len(got) == len(want), what
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        d = (g - w).abs()
        if lr is None:
            assert float(d.max()) <= RTOL * float(w.abs().max()) + ATOL, (name, float(d.max()))
        else:
            assert float(d.max()) <= 2 * lr * STEPS, (name, float(d.max()))
            assert name.endswith(".bk") or float(d.mean()) <= MEAN_PARAM * lr * STEPS, (name, float(d.mean()))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_train_cell_matches_reference(name, accum, f32_mode):
    from repro import configs as jconfigs

    arch_j, arch = _arch(name, JShapeSpec, mod=jconfigs), _arch(name, A.ShapeSpec)
    prog_j = jsteps.build_cell(arch_j, "t", adamw=joptim.AdamWConfig(**ADAMW), accum_steps=accum)
    prog = steps.build_cell(arch, "t", adamw=optim.AdamWConfig(**ADAMW), accum_steps=accum)
    assert (prog.name, prog.kind, prog.donate) == (prog_j.name, prog_j.kind, prog_j.donate) == (
        f"{arch.name}/t", CASES[name][0], (0,))
    ts_j, ts = _states(name)
    stream = SyntheticStream(DataSpec(arch, arch.shape("t"), seed=3))
    step_j = prog_j.jit()
    for i in range(STEPS):
        batch = stream.batch_at(i)
        ts_j, m_j = step_j(ts_j, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, m = prog(ts, {k: torch.tensor(v) for k, v in batch.items()})
        assert set(m) == set(m_j), (sorted(m), sorted(m_j))
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=RTOL if k != "lr" else 1e-6, atol=1e-9)
    assert ts["opt"]["step"].dtype == torch.int32 and ts["opt"]["step"].shape == ()
    assert int(ts["opt"]["step"]) == int(ts_j["opt"]["step"]) == STEPS
    carry = lambda tree: interop.from_jax(arch, jax.tree.map(np.asarray, tree), np_state, device=CPU)[0]  # noqa: E731
    np_state = jax.tree.map(np.asarray, ts_j["state"])
    _close_tree(ts["params"], carry(ts_j["params"]), "params", lr=ADAMW["lr"])
    _close_tree(ts["state"], interop.from_jax(arch, jax.tree.map(np.asarray, ts_j["params"]), np_state,
                                              device=CPU)[1], "state")
    for part in ("m", "v"):
        _close_tree(ts["opt"][part], carry(ts_j["opt"][part]), part)
    for p in common.tree_leaves(ts["params"]):
        assert not p.requires_grad


DIT_LOSS_RTOL = 1e-2


def test_dit_loss_climbs_at_lr_1e3_as_in_the_reference():
    from repro import configs as jconfigs

    def cut(arch, shape_cls):
        return dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, n_layers=4),
                                   shapes=(shape_cls("t", "denoise_train", 2, img=256),))

    arch_j, arch = cut(jconfigs.get("dit-xl2"), JShapeSpec), cut(configs.get("dit-xl2"), A.ShapeSpec)
    rng = np.random.default_rng(0)

    def draw(s):  # the reference's init rule, in numpy; zero leaves stay zero (adaLN-Zero)
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, float(s.init == "ones"), np.float32)
        scale = s.scale if s.scale is not None else 1 / np.sqrt(s.shape[-2])
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    params_j = jax.tree.map(draw, jabstract_params(arch_j)[0], is_leaf=lambda x: hasattr(x, "init"))
    attn, c = params_j["blocks"]["attn"], arch.cfg  # attention matrices at their own fan-in, as chip_smoke's
    for k in ("wq", "wk", "wv"):
        attn[k] = attn[k] * np.float32(math.sqrt(c.n_heads / c.d_model))
    attn["wo"] = attn["wo"] / np.float32(math.sqrt(c.n_heads))
    params, _ = interop.from_jax(arch, params_j, {}, device=CPU)
    adamw = dict(lr=1e-3, warmup_steps=1, total_steps=100)  # chip_smoke's TRAIN_ADAMW
    step_j = jsteps.build_cell(arch_j, "t", adamw=joptim.AdamWConfig(**adamw)).jit()
    prog = steps.build_cell(arch, "t", adamw=optim.AdamWConfig(**adamw))
    ts_j = {"params": jax.tree.map(jnp.asarray, params_j), "state": {}, "opt": joptim.init_opt_state(params_j)}
    ts = {"params": params, "state": {}, "opt": optim.init_opt_state(params)}
    batch = SyntheticStream(DataSpec(arch, arch.shape("t"), seed=0)).batch_at(0)
    losses_j, losses = [], []
    for _ in range(4):
        ts_j, m_j = step_j(ts_j, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, m = prog(ts, {k: torch.tensor(v) for k, v in batch.items()})
        losses_j.append(float(m_j["loss"]))
        losses.append(float(m["loss"]))
    print(f"dit-xl2, 4 layers, batch 2, lr 1e-3: reference {losses_j}, port {losses}")
    np.testing.assert_allclose(losses, losses_j, rtol=DIT_LOSS_RTOL)
    assert losses_j[3] > losses_j[0] and losses[3] > losses[0]


def test_training_never_calls_flash(monkeypatch):
    """The cells differentiate through the reference's attention branches:
    the flash wrapper (forward only) is patched to raise."""

    def refuse(*_a, **_k):
        raise AssertionError("the flash wrapper was called while training")

    monkeypatch.setattr(flash_ops, "attention", refuse)
    for name in ("qwen3-0.6b", "dit-xl2", "flux-dev", "vit-s16"):
        arch = _arch(name, A.ShapeSpec)
        prog = steps.build_cell(arch, "t", adamw=optim.AdamWConfig(**ADAMW))
        ts = prog.init_arg(0, 0, CPU)
        batch = A.make_inputs(arch, arch.shape("t"), 1, device=CPU)
        ts, m = prog(ts, batch)
        assert bool(torch.isfinite(m["loss"]))


def test_grad_accumulation_matches_full_batch():
    """``accum_steps`` 2 on the same global batch against one full-batch
    step, in bf16 as the port runs, with the reference test's bounds."""
    arch = dataclasses.replace(configs.get("vit-s16", smoke=True),
                               shapes=(A.ShapeSpec("t", "classify_train", 4, img=32),))
    kw = dict(adamw=optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, grad_clip=0.0))
    p1 = steps.build_cell(arch, "t", **kw)
    p2 = steps.build_cell(arch, "t", accum_steps=2, **kw)
    ts1 = p1.init_arg(0, 0, CPU)
    ts2 = p2.init_arg(0, 0, CPU)
    batch = A.make_inputs(arch, arch.shape("t"), 1, device=CPU)
    ts1, m1 = p1(ts1, batch)
    ts2, m2 = p2(ts2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m1["grad_norm"]) == pytest.approx(float(m2["grad_norm"]), rel=5e-2)
    for x, y in zip(common.tree_leaves(ts1["params"]), common.tree_leaves(ts2["params"])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2.5e-3)
    assert set(m2) == {"loss", "grad_norm", "lr"}


def test_lm_train_loss_decreases():
    arch = dataclasses.replace(configs.get("qwen3-0.6b", smoke=True), shapes=(A.ShapeSpec("t", "train", 4, seq=32),))
    prog = steps.build_cell(arch, "t", adamw=optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30))
    ts, batch = prog.init_args(0, device=CPU)  # the reference test's batch: init_args' (all-zero tokens)
    losses = []
    for _ in range(15):
        ts, metrics = prog(ts, batch)  # overfit one batch
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_accum_steps_must_divide_the_batch():
    arch = _arch("resnet-50", A.ShapeSpec)
    with pytest.raises(ValueError, match="microbatches"):
        steps.build_cell(arch, "t", accum_steps=3)
