"""The port's convnets against the reference on the same weights
(``interop.from_jax``), on the CPU.

Tolerances and why:
  * convs in f32: int8 operands bit-equal, outputs within 1e-5 — same patch
    order and padding, only the f32 summation order differs;
  * fake-quant weights: bit-equal (same f32 scale, divide and rounding);
  * smoke forwards: both cast images to bf16 and compute in bf16, whose
    8-bit mantissa rounds at different places in XLA and PyTorch; logits
    must agree within 3% of the logit scale (a few bf16 ulps accumulated
    over the network; 1.7% is the largest seen) and top-1 on at least 62 of
    64 frames (random weights leave near-ties that one bf16 ulp can flip).
"""
from __future__ import annotations

import functools

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.arch import classifier_forward as jforward
from repro.kernels.npu_matmul import ref as jref
from repro.models import convnets as jconv
from repro.models.common import matmul_backend as jbackend
from repro_torch import arch as A
from repro_torch import configs, interop, quant
from repro_torch.kernels.npu_matmul import ref
from repro_torch.models import convnets
from repro_torch.models.common import init_tree, matmul_backend, tree_leaves
from repro_torch.serving.engine import make_synthetic_video

LOGIT_RTOL = 0.03
MIN_TOP1_AGREE = 62  # of 64


def _recorder(store, quantize_row, quantize_col, to_np):
    def fn(a, b):
        xq, xs = quantize_row(a)
        wq, ws = quantize_col(b)
        store.append(tuple(to_np(t) for t in (xq, xs, wq, ws)))
        return a @ b

    return fn


@pytest.mark.parametrize(
    "k,stride,hw",
    [(1, 1, 9), (1, 2, 9), (1, 2, 8), (3, 1, 9), (3, 2, 9), (3, 2, 8), (7, 2, 12), (7, 2, 11)],
)
def test_conv_matches_reference_f32(k, stride, hw):
    """SAME conv, direct and im2col, in f32: odd and even sizes exercise the
    asymmetric stride-2 padding; the stride-2 1x1 takes the patches branch."""
    rng = np.random.default_rng(k * 100 + stride * 10 + hw)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
    w = (rng.standard_normal((k, k, 4, 8)) / k).astype(np.float32)
    tx = torch.tensor(x).permute(0, 3, 1, 2)
    tw = torch.tensor(w.transpose(3, 2, 0, 1).copy())

    direct_j = np.asarray(jconv.conv(jnp.asarray(w), jnp.asarray(x), stride=stride))
    direct_t = convnets.conv(tw, tx, stride=stride).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(direct_t, direct_j, rtol=1e-5, atol=1e-5)

    rec_j, rec_t = [], []
    with jbackend(_recorder(rec_j, jref.quantize_rowwise, jref.quantize_colwise, np.asarray)):
        routed_j = np.asarray(jconv.conv(jnp.asarray(w), jnp.asarray(x), stride=stride))
    with matmul_backend(_recorder(rec_t, ref.quantize_rowwise, ref.quantize_colwise, lambda t: t.numpy())):
        routed_t = convnets.conv(tw, tx, stride=stride).permute(0, 2, 3, 1).numpy()
    assert len(rec_j) == len(rec_t) == 1
    for a, b in zip(rec_t[0], rec_j[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(routed_t, routed_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(routed_t, direct_j, rtol=1e-5, atol=1e-5)


@functools.cache
def _reference_qparams(name):
    """The reference's fake-quant weights, computed eagerly as its calibration
    does: under ``jax.jit`` XLA rewrites the divide by the scale and flips
    the last bit of a few weights, so only the eager values are the
    reference's deployed NPU weights."""
    _, params_j, _ = reference_params(name, seed=11)
    return jax.tree.map(np.asarray, jquant.fake_quant_tree(jax.tree.map(jnp.asarray, params_j)))


def _both(name):
    arch_j, params_j, state_j = reference_params(name, seed=11)
    arch_t = configs.get(name, smoke=True)
    params_t, state_t = interop.from_jax(arch_t, params_j, state_j, device=CPU)
    return arch_j, params_j, state_j, arch_t, params_t, state_t


@pytest.mark.parametrize("name", ["resnet-50", "squeezenet"])
def test_npu_variant_bit_equal(name):
    _, params_j, state_j, arch_t, params_t, _ = _both(name)
    q_t, stats_t = quant.npu_variant(params_t, A.abstract_params(arch_t)[0])
    q_j_as_t, _ = interop.from_jax(arch_t, _reference_qparams(name), state_j, device=CPU)
    for a, b in zip(tree_leaves(q_t), tree_leaves(q_j_as_t)):
        assert torch.equal(a, b)
    assert quant.quant_error_stats(params_t, q_j_as_t) == stats_t


@pytest.mark.parametrize("variant", ["edge", "npu"])
@pytest.mark.parametrize("name", ["resnet-50", "squeezenet"])
def test_smoke_forward_matches_reference(name, variant):
    arch_j, params_j, state_j, arch_t, params_t, state_t = _both(name)
    frames, _ = make_synthetic_video(64, res=32, seed=5)

    def f_j(p, x):
        return jforward(arch_j, p, state_j, x, train=False)[0]

    def f_t(p, x):
        return A.classifier_forward(arch_t, p, state_t, x, train=False)[0]

    p_j = jax.tree.map(jnp.asarray, params_j)
    if variant == "npu":
        p_j = jax.tree.map(jnp.asarray, _reference_qparams(name))
        params_t, _ = quant.npu_variant(params_t, A.abstract_params(arch_t)[0])
        f_j = jquant.npu_forward(f_j, interpret=True)
        f_t = quant.npu_forward(f_t)
    out_j = np.asarray(jax.jit(f_j)(p_j, jnp.asarray(frames)))
    with torch.no_grad():
        out_t = f_t(params_t, torch.tensor(frames)).numpy()
    assert out_t.shape == out_j.shape == (64, 10) and out_t.dtype == np.float32
    scale = float(np.max(np.abs(out_j)))
    assert float(np.max(np.abs(out_t - out_j))) <= LOGIT_RTOL * scale
    agree = int(np.sum(out_t.argmax(-1) == out_j.argmax(-1)))
    assert agree >= MIN_TOP1_AGREE, agree


def test_train_mode_forward_and_state_match_reference():
    """train=True (what calibration differentiates): batch statistics in f32,
    logits and the updated running statistics close to the reference's."""
    arch_j, params_j, state_j, arch_t, params_t, state_t = _both("resnet-50")
    frames, _ = make_synthetic_video(16, res=32, seed=6)
    out_j, ns_j = jax.jit(lambda p, x: jforward(arch_j, p, state_j, x, train=True))(
        jax.tree.map(jnp.asarray, params_j), jnp.asarray(frames))
    with torch.no_grad():
        out_t, ns_t = A.classifier_forward(arch_t, params_t, state_t, torch.tensor(frames), train=True)
    out_j = np.asarray(out_j)
    assert float(np.max(np.abs(out_t.numpy() - out_j))) <= LOGIT_RTOL * float(np.max(np.abs(out_j)))
    _, ns_j_as_t = interop.from_jax(arch_t, params_j, jax.tree.map(np.asarray, ns_j), device=CPU)
    for a, b in zip(tree_leaves(ns_t), tree_leaves(ns_j_as_t)):
        # the statistics of bf16 activations: a few bf16 ulps of the values
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name,smoke,expected", [
    ("resnet-50", True, 10), ("squeezenet", True, 26),   # smoke configs
    ("resnet-50", False, 54), ("squeezenet", False, 26),  # full width: 53 convs + head; 25 convs + classifier
])
def test_backend_calls_per_forward(name, smoke, expected):
    """Every conv with groups == 1 and the head lower to one backend GEMM."""
    arch_t = configs.get(name, smoke=smoke)
    specs, state_specs = A.abstract_params(arch_t)
    params = init_tree(torch.Generator().manual_seed(0), specs, device=CPU)
    state = init_tree(torch.Generator().manual_seed(1), state_specs, device=CPU)
    calls = []
    with matmul_backend(lambda a, b: (calls.append(a.shape), a @ b)[1]), torch.no_grad():
        A.classifier_forward(arch_t, params, state, torch.zeros(1, 32, 32, 3), train=False)
    assert len(calls) == expected
    if smoke:
        arch_j, params_j, state_j = reference_params(name, seed=0, smoke=True)
        calls_j = []

        def traced(p, x):  # the backend records shapes while jit traces
            with jbackend(lambda a, b: (calls_j.append(a.shape), a @ b)[1]):
                return jforward(arch_j, p, state_j, x, train=False)[0]

        jax.jit(traced)(jax.tree.map(jnp.asarray, params_j), jnp.zeros((1, 32, 32, 3)))
        assert len(calls_j) == expected
        assert [tuple(c) for c in calls] == [tuple(c) for c in calls_j]


def test_from_jax_rejects_mismatched_trees():
    _, params_j, state_j = reference_params("squeezenet", seed=0)
    arch_t = configs.get("resnet-50", smoke=True)
    with pytest.raises(ValueError):
        interop.from_jax(arch_t, params_j, state_j, device=CPU)
