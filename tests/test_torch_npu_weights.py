"""Tensors an inference forward derives from its leaves, kept across calls
(``models.common.kept``): the NPU path's int8 weights, BatchNorm's terms and
weight casts; and the quantizers, on the CPU.

What is kept must be bit-equal to deriving it at every call (the
reference's way; for the NPU, the plain backend ``ref.npu_matmul_ref``); a
write to a leaf must derive it anew; an entry must go with its leaf; a leaf
in autograd keeps nothing.  The quantizers must give the reference's int8
values and scales bit for bit.
"""
from __future__ import annotations

import gc

from test_torch_ref import CPU  # installs the jax 0.9 shims first

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.npu_matmul import ref as jref
from repro_torch import arch as A
from repro_torch import configs, quant
from repro_torch.kernels.npu_matmul import ref
from repro_torch.models import common, convnets
from repro_torch.quant import npu_exec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["rowwise", "colwise"])
def test_quantizers_match_reference(which, dtype):
    """Random values with an all-zero slice (scale 1), exact halves (ties
    round to even) and a transposed view (the conv weight's ``[K, N]``)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((37, 29)) * 4).astype(np.float32)
    x[5] = 0.0
    x[:, 7] = 0.0
    x[2, :6] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.0]
    t = torch.tensor(x).to(dtype)
    if which == "colwise":
        t = t.t().contiguous().t()  # the same values, laid out as the conv's transposed view
    got = getattr(ref, f"quantize_{which}")(t)
    want = getattr(jref, f"quantize_{which}")(jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    assert got[0].dtype == torch.int8 and got[0].is_contiguous() and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _conv_view(w: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` of an OIHW leaf, as ``convnets._conv_via_matmul`` gives it."""
    return w.reshape(w.shape[0], -1).t()


def _live() -> int:
    gc.collect()
    return len(common.KEPT)


def test_kept_int8_weights_equal_quantizing_each_call():
    g = torch.Generator().manual_seed(0)
    stacked = torch.randn(3, 8, 4, 3, 3, generator=g)  # [L, O, I, KH, KW]
    before = _live()
    for layer in torch.unbind(stacked):
        for dtype in (torch.bfloat16, torch.float32):
            first = npu_exec.int8_weight(_conv_view(layer), dtype)
            want = ref.quantize_colwise(_conv_view(layer).to(dtype))
            assert all(torch.equal(a, b) for a, b in zip(first, want))
            again = npu_exec.int8_weight(_conv_view(layer), dtype)  # a new view of the same place: kept
            assert again[0] is first[0] and again[1] is first[1]
    assert _live() == before + 6
    del stacked, layer
    assert _live() == before


def test_a_write_derives_anew_and_an_entry_goes_with_its_leaf():
    before = _live()
    w = torch.randn(8, 4, 1, 1, generator=torch.Generator().manual_seed(1))
    first = npu_exec.int8_weight(_conv_view(w), torch.bfloat16)
    with torch.no_grad():
        w.mul_(2.0)
    after = npu_exec.int8_weight(_conv_view(w), torch.bfloat16)
    assert after[0] is not first[0]
    assert torch.equal(after[1], first[1] * 2.0) and torch.equal(after[0], first[0])
    assert _live() == before + 1
    del w
    assert _live() == before
    for _ in range(3):  # a weight cast for each call is a fresh root: its entry goes with it
        npu_exec.int8_weight(torch.randn(4, 8).to(torch.bfloat16), torch.bfloat16)
    assert _live() == before


def test_a_leaf_in_autograd_keeps_nothing():
    before = _live()
    w = torch.randn(8, 4, requires_grad=True)
    y = common.cast(w, torch.float64)
    assert y.grad_fn is not None and _live() == before
    y.sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
    with torch.no_grad():
        kept = common.cast(w, torch.float64)
        assert kept is common.cast(w, torch.float64) and _live() == before + 1


def test_a_meta_leaf_keeps_nothing():
    """A step traced on ``meta`` (the dry run) issues every operation at
    every call."""
    before = _live()
    w = torch.empty(8, 4, device="meta")
    with torch.no_grad():
        assert common.cast(w, torch.bfloat16) is not common.cast(w, torch.bfloat16)
        assert npu_exec.int8_weight(w, torch.bfloat16)[0].is_meta
    assert _live() == before


@pytest.mark.parametrize("train", [False, True])
def test_batchnorm_bit_equal_to_its_formula(train):
    """Eval keeps (shift, scale, bias) and holds no leaf; train keeps
    nothing and its gradients reach the leaves."""
    g = torch.Generator().manual_seed(4)
    C = 6
    p = {"scale": torch.randn(C, generator=g), "bias": torch.randn(C, generator=g)}
    s = {"mean": torch.randn(C, generator=g), "var": torch.rand(C, generator=g) + 0.5}
    x = torch.randn(2, C, 5, 5, generator=g).to(torch.bfloat16)
    if train:
        for t in p.values():
            t.requires_grad_(True)
    x32 = x.float()
    mean, var = (x32.mean(dim=(0, 2, 3)), x32.var(dim=(0, 2, 3), unbiased=False)) if train else (s["mean"], s["var"])
    inv = torch.rsqrt(var + 1e-5) * p["scale"]
    want = ((x32 - mean[:, None, None]) * inv[:, None, None] + p["bias"][:, None, None]).to(x.dtype)
    before = _live()
    for _ in range(2):
        got, _ = convnets.batchnorm(p, s, x, train)
        assert torch.equal(got, want)
    if train:
        assert _live() == before
        got.float().sum().backward()
        assert p["scale"].grad is not None and p["bias"].grad is not None
    else:
        assert _live() == before + 1
        del p, s
        assert _live() == before


@pytest.mark.parametrize("name", ["resnet-50", "efficientnet-b7", "squeezenet"])
def test_npu_forward_keeps_int8_weights_and_equals_the_plain_backend(name, monkeypatch):
    """Two NPU forwards of a smoke classifier: both bit-equal to the plain
    backend, which quantizes both sides at every call; the second quantizes
    no weight."""
    arch = configs.get(name, smoke=True)
    specs, state_specs = A.abstract_params(arch)
    params = common.init_tree(torch.Generator().manual_seed(0), specs, device=CPU)
    state = common.init_tree(torch.Generator().manual_seed(1), state_specs, device=CPU)
    qparams, _ = quant.npu_variant(params, specs)
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(2))

    def forward(p, images):
        return A.classifier_forward(arch, p, state, images, train=False)[0]

    with common.matmul_backend(ref.npu_matmul_ref), torch.no_grad():
        plain = forward(qparams, x)
    quantized = []
    real = ref.quantize_colwise
    monkeypatch.setattr(ref, "quantize_colwise", lambda w: (quantized.append(w.shape), real(w))[1])
    npu = quant.npu_forward(forward)
    first = npu(qparams, x)
    n_first = len(quantized)
    second = npu(qparams, x)
    assert n_first > 0 and len(quantized) == n_first
    assert torch.equal(first, plain) and torch.equal(second, plain)
