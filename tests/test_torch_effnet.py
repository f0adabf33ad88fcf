"""The port's EfficientNet against the reference on the same weights
(``interop.from_jax``), on the CPU.

Tolerances and why:
  * ``_round_filters``, ``stages()``, parameter counts, backend call shapes:
    exact (the same integer arithmetic);
  * the depthwise conv and one ``_mbconv`` block in f32: within 1e-5 (rtol
    and atol) — the same padding and per-channel products, only the f32
    summation order differs; the block's new BatchNorm state likewise;
  * fake-quant weights and the stem GEMM's int8 operands: bit-equal (same f32
    scale, divide and rounding);
  * smoke forwards: both cast images to bf16 and compute in bf16, rounding at
    different places in XLA and PyTorch; logits within 3% of the logit scale
    and top-1 on at least 62 of 64 frames, ``test_torch_convnets.py``'s
    limits, which hold for the smoke B7's ten blocks too (measured at seed
    11: 0.36% and 64/64 for the edge variant, 1.34% and 64/64 for the NPU
    variant);
  * train-mode forward, in f32 in both packages (why: its docstring):
    logits within 1e-4 of the logit scale, running statistics within 1e-5.
"""
from __future__ import annotations

import math

from test_torch_ref import CPU, reference_params  # installs the jax 0.9 shims first

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jquant
from repro.arch import abstract_params as jabstract
from repro.arch import classifier_forward as jforward
from repro.kernels.npu_matmul import ref as jref
from repro.models import convnets as jconv
from repro.models.common import ParamSpec as JSpec
from repro.models.common import matmul_backend as jbackend
from repro_torch import arch as A
from repro_torch import configs, interop, quant
from repro_torch.kernels.npu_matmul import ref
from repro_torch.models import convnets
from repro_torch.models.common import matmul_backend, tree_leaves
from repro_torch.serving.engine import make_synthetic_video

NAME = "efficientnet-b7"
F32 = dict(rtol=1e-5, atol=1e-5)
LOGIT_RTOL = 0.03
MIN_TOP1_AGREE = 62  # of 64
SMOKE_GEMMS = 42  # stem + 3 per expand-1 block + 4 per other block (9) + head conv + head
B_MULTIPLIERS = [(1.0, 1.0), (1.0, 1.1), (1.1, 1.2), (1.2, 1.4), (1.4, 1.8), (1.6, 2.2), (1.8, 2.6), (2.0, 3.1)]


def _np_tree(rng, specs_j):
    """numpy weights for a reference spec tree, drawn as ``reference_params``
    draws them (fan-in scaled; biases, BN scales and statistics non-trivial)."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if s.init == "zeros":
            return rng.normal(0.0, 0.05, s.shape).astype(np.float32)
        if s.init == "ones":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[-4:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, specs_j, is_leaf=lambda x: isinstance(x, JSpec))


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("width,depth", B_MULTIPLIERS, ids=[f"b{i}" for i in range(8)])
def test_stages_match_reference(width, depth):
    c = convnets.EfficientNetConfig("e", width_mult=width, depth_mult=depth)
    cj = jconv.EfficientNetConfig("e", width_mult=width, depth_mult=depth)
    assert c.stages() == cj.stages()
    assert (c.stem_ch, c.head_ch) == (cj.stem_ch, cj.head_ch)
    for ch in (16, 24, 32, 40, 80, 112, 192, 320, 1280):
        assert convnets._round_filters(ch, width) == jconv._round_filters(ch, width)


@pytest.mark.parametrize("k,stride,hw", [(3, 1, 9), (3, 2, 9), (3, 2, 8), (5, 1, 8), (5, 2, 9), (5, 2, 8)])
def test_depthwise_conv_matches_reference_f32(k, stride, hw):
    """``conv(groups=C)`` with the SAME padding of either parity; under an
    active backend it stays a grouped conv in both packages (0 GEMMs)."""
    C = 6
    rng = np.random.default_rng(k * 100 + stride * 10 + hw)
    x = rng.standard_normal((2, hw, hw, C)).astype(np.float32)
    w = (rng.standard_normal((k, k, 1, C)) / k).astype(np.float32)
    tw = torch.tensor(w.transpose(3, 2, 0, 1).copy())  # HWIO [k, k, 1, C] -> OIHW [C, 1, k, k]
    expect = np.asarray(jconv.conv(jnp.asarray(w), jnp.asarray(x), stride=stride, groups=C))
    np.testing.assert_allclose(_nhwc(convnets.conv(tw, _nchw(x), stride=stride, groups=C)), expect, **F32)
    calls, calls_j = [], []
    with matmul_backend(lambda a, b: (calls.append(a.shape), a @ b)[1]):
        routed = _nhwc(convnets.conv(tw, _nchw(x), stride=stride, groups=C))
    with jbackend(lambda a, b: (calls_j.append(a.shape), a @ b)[1]):
        jconv.conv(jnp.asarray(w), jnp.asarray(x), stride=stride, groups=C)
    assert calls == calls_j == []
    np.testing.assert_allclose(routed, expect, **F32)


MBCONV_CASES = {  # name: (cin, cout, expand, k, stride) — residual where stride 1 and cin == cout
    "expand1_residual": (8, 8, 1, 3, 1),
    "expand1_stride2": (8, 16, 1, 3, 2),
    "expand6_residual": (8, 8, 6, 5, 1),
    "expand6_stride2": (8, 12, 6, 3, 2),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(MBCONV_CASES))
def test_mbconv_matches_reference_f32(case, train):
    cin, cout, expand, k, stride = MBCONV_CASES[case]
    rng = np.random.default_rng(cin * expand + k + stride)
    p_j = _np_tree(rng, jconv._mbconv_specs(cin, cout, expand, k, 0.25))
    s_j = _np_tree(rng, jconv._mbconv_state(cin, cout, expand))
    x = rng.standard_normal((2, 9, 9, cin)).astype(np.float32)
    y_j, ns_j = jconv._mbconv(jax.tree.map(jnp.asarray, p_j), jax.tree.map(jnp.asarray, s_j), jnp.asarray(x),
                              stride, k, train)
    p = interop._walk("", p_j, convnets._mbconv_specs(cin, cout, expand, k, 0.25), CPU)
    s = interop._walk("", s_j, convnets._mbconv_state(cin, cout, expand), CPU)
    with torch.no_grad():
        y, ns = convnets._mbconv(p, s, _nchw(x), stride, train)
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), **F32)
    assert sorted(ns) == sorted(ns_j)
    for key in ns:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(ns[key][stat].numpy(), np.asarray(ns_j[key][stat]), **F32)


@pytest.mark.parametrize("smoke,expected", [(False, 66_347_960), (True, None)], ids=["full", "smoke"])
def test_param_counts_match_reference(smoke, expected):
    arch, arch_j = configs.get(NAME, smoke=smoke), jconfigs.get(NAME, smoke=smoke)
    count_j = sum(math.prod(s.shape) for s in jax.tree.leaves(
        jabstract(arch_j)[0], is_leaf=lambda x: isinstance(x, JSpec)))
    assert A.n_params(arch) == count_j
    if expected is not None:
        assert count_j == expected


def test_from_jax_carries_stacked_depthwise_weights():
    """Stacked depthwise ``[L, k, k, 1, cmid]`` -> ``[L, cmid, 1, k, k]`` through
    the conv transpose; the stacked SE biases ``[L, cmid]`` arrive as they are."""
    arch = configs.get(NAME, smoke=True)
    _, params_j, state_j = reference_params(NAME, seed=4)
    params, state = interop.from_jax(arch, params_j, state_j, device=CPU)
    dw_j, dw = params_j["stage3_rest"]["dw"], params["stage3_rest"]["dw"]
    assert dw_j.ndim == 5 and dw_j.shape[3] == 1
    L, k, _, _, cmid = dw_j.shape
    assert tuple(dw.shape) == (L, cmid, 1, k, k)
    np.testing.assert_array_equal(dw.numpy(), dw_j.transpose(0, 4, 3, 1, 2))
    np.testing.assert_array_equal(params["stage3_rest"]["se_e"]["b"].numpy(), params_j["stage3_rest"]["se_e"]["b"])
    np.testing.assert_array_equal(state["stage3_rest"]["bn_d"]["var"].numpy(), state_j["stage3_rest"]["bn_d"]["var"])


@pytest.fixture(scope="module")
def smoke_weights():
    arch_j, params_j, state_j = reference_params(NAME, seed=11)
    arch = configs.get(NAME, smoke=True)
    params, state = interop.from_jax(arch, params_j, state_j, device=CPU)
    return arch_j, params_j, state_j, arch, params, state


@pytest.fixture(scope="module")
def smoke_qparams_j(smoke_weights):
    """The reference's fake-quant weights, computed eagerly as its calibration
    does (under ``jax.jit`` XLA may rewrite the divide by the scale)."""
    params_j = smoke_weights[1]
    return jax.tree.map(np.asarray, jquant.fake_quant_tree(jax.tree.map(jnp.asarray, params_j)))


def test_npu_variant_bit_equal(smoke_weights, smoke_qparams_j):
    """Every floating leaf of rank >= 2, per last axis in the reference's HWIO
    layout: the stacked depthwise weights per channel, and the stacked 1-D
    leaves of the rest blocks (SE biases, BN scale/bias ``[L, ch]``) per
    channel across their layers."""
    _, params_j, state_j, arch, params, _ = smoke_weights
    q_t, stats = quant.npu_variant(params, A.abstract_params(arch)[0])
    q_j, _ = interop.from_jax(arch, smoke_qparams_j, state_j, device=CPU)
    for a, b in zip(tree_leaves(q_t), tree_leaves(q_j)):
        assert torch.equal(a, b)
    assert quant.quant_error_stats(params, q_j) == stats
    assert stats.leaves_quantized > 0
    assert not torch.equal(q_t["stage3_rest"]["dw"], params["stage3_rest"]["dw"])
    assert torch.equal(q_t["stage3_first"]["se_r"]["b"], params["stage3_first"]["se_r"]["b"])  # 1-D: kept


def _recorder(store, quantize_row, quantize_col, to_np):
    def fn(a, b):
        store.append(tuple(to_np(t) for t in (*quantize_row(a), *quantize_col(b))))
        return a @ b

    return fn


def test_backend_calls_per_smoke_forward_match_reference(smoke_weights):
    """42 GEMMs in the same order and shapes (the reference's traced, not
    run); the stem's im2col operands, quantized, bit-equal."""
    arch_j, params_j, state_j, arch, params, state = smoke_weights
    frames, _ = make_synthetic_video(2, res=32, seed=1)
    calls, calls_j = [], []
    with matmul_backend(lambda a, b: (calls.append((a.shape[0], a.shape[1], b.shape[1])), a @ b)[1]), \
            torch.no_grad():
        A.classifier_forward(arch, params, state, torch.tensor(frames), train=False)

    def traced(p, x):
        with jbackend(lambda a, b: (calls_j.append((a.shape[0], a.shape[1], b.shape[1])), a @ b)[1]):
            return jforward(arch_j, p, state_j, x, train=False)[0]

    jax.eval_shape(traced, jax.tree.map(jnp.asarray, params_j), jnp.asarray(frames))
    assert len(calls) == len(calls_j) == SMOKE_GEMMS
    assert calls == [tuple(map(int, c)) for c in calls_j]
    assert calls[0] == (2 * 16 * 16, 27, arch.cfg.stem_ch)

    rec, rec_j = [], []  # the stem conv (3x3, stride 2) on the bf16 frames
    with matmul_backend(_recorder(rec, ref.quantize_rowwise, ref.quantize_colwise, lambda t: t.numpy())):
        convnets.conv(params["stem"]["conv"], torch.tensor(frames).to(torch.bfloat16).permute(0, 3, 1, 2), stride=2)
    with jbackend(_recorder(rec_j, jref.quantize_rowwise, jref.quantize_colwise, np.asarray)):
        jconv.conv(jnp.asarray(params_j["stem"]["conv"]), jnp.asarray(frames).astype(jnp.bfloat16), stride=2)
    assert len(rec) == len(rec_j) == 1
    for a, b in zip(rec[0], rec_j[0]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def smoke_logits(smoke_weights, smoke_qparams_j):
    """(port, reference) logits of 64 frames for each variant, each reference
    forward traced once."""
    arch_j, params_j, state_j, arch, params, state = smoke_weights
    frames, _ = make_synthetic_video(64, res=32, seed=5)

    def f_j(p, x):
        return jforward(arch_j, p, state_j, x, train=False)[0]

    def f_t(p, x):
        return A.classifier_forward(arch, p, state, x, train=False)[0]

    qparams_j = smoke_qparams_j
    qparams, _ = quant.npu_variant(params, A.abstract_params(arch)[0])
    out = {}
    for variant, fj, pj, ft, pt in (
        ("edge", f_j, params_j, f_t, params),
        ("npu", jquant.npu_forward(f_j, interpret=True), qparams_j, quant.npu_forward(f_t), qparams),
    ):
        out_j = np.asarray(jax.jit(fj)(jax.tree.map(jnp.asarray, pj), jnp.asarray(frames)))
        with torch.no_grad():
            out[variant] = (ft(pt, torch.tensor(frames)).numpy(), out_j)
    return out


@pytest.mark.parametrize("variant", ["edge", "npu"])
def test_smoke_forward_matches_reference(smoke_logits, variant):
    out_t, out_j = smoke_logits[variant]
    assert out_t.shape == out_j.shape == (64, 10) and out_t.dtype == np.float32
    scale = float(np.max(np.abs(out_j)))
    assert float(np.max(np.abs(out_t - out_j))) <= LOGIT_RTOL * scale
    agree = int(np.sum(out_t.argmax(-1) == out_j.argmax(-1)))
    assert agree >= MIN_TOP1_AGREE, agree


class _F32:
    """A stand-in for a module's ``torch`` / ``jnp`` whose ``bfloat16`` is
    float32, so a forward that casts its images to bf16 computes in f32."""

    def __init__(self, mod, f32):
        self._mod, self.bfloat16 = mod, f32

    def __getattr__(self, name):
        return getattr(self._mod, name)


def test_train_mode_forward_and_state_match_reference(smoke_weights, monkeypatch):
    """train=True (what calibration differentiates): batch statistics through
    every rest block, restacked.  Both forwards run in f32 (their bf16 cast
    made f32): in bf16 the batch statistics of the smoke B7's 2x2 and 1x1
    maps at 32² amplify rounding, and the reference differs from itself,
    jitted against eager, by 13.9% of the logit scale (the port from the
    eager reference by 11.2%); in f32 the two agree within 4.2e-6."""
    arch_j, params_j, state_j, arch, params, state = smoke_weights
    monkeypatch.setattr(convnets, "torch", _F32(torch, torch.float32))
    monkeypatch.setattr(jconv, "jnp", _F32(jnp, jnp.float32))
    frames, _ = make_synthetic_video(16, res=32, seed=6)
    out_j, ns_j = jax.jit(lambda p, x: jforward(arch_j, p, state_j, x, train=True))(
        jax.tree.map(jnp.asarray, params_j), jnp.asarray(frames))
    with torch.no_grad():
        out_t, ns_t = A.classifier_forward(arch, params, state, torch.tensor(frames), train=True)
    out_j = np.asarray(out_j)
    assert out_t.dtype == torch.float32
    assert float(np.max(np.abs(out_t.numpy() - out_j))) <= 1e-4 * float(np.max(np.abs(out_j)))
    _, ns_j_as_t = interop.from_jax(arch, params_j, jax.tree.map(np.asarray, ns_j), device=CPU)
    assert tuple(ns_t["stage3_rest"]["bn_d"]["mean"].shape) == tuple(state["stage3_rest"]["bn_d"]["mean"].shape)
    for a, b in zip(tree_leaves(ns_t), tree_leaves(ns_j_as_t)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)
