"""The port's NPU int8 matmul against the reference's Pallas kernel.

Tolerances and why:
  * quantization (values and scales): bit-equal — both sides do the same f32
    divide, round-half-to-even and clip;
  * the GEMM: rtol 1e-5 / atol 1e-4, and 1e-6 at M=1 — the tolerances of
    tests/test_kernels.py.  The integer sums are exact on both sides; the
    outputs can still differ in the last bit because the reference oracle
    multiplies ``acc * xs * ws`` left to right while the kernels compute
    ``acc * (xs * ws)``.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.npu_matmul import ops as jops
from repro.kernels.npu_matmul import ref as jref
from repro_torch.kernels.npu_matmul import ops, ref

SHAPES = [  # tests/test_kernels.py:27, :56-58 and the M=1 golden at :78
    (128, 512, 128), (256, 1024, 384), (64, 300, 100), (8, 128, 128), (1, 64, 1),
    (130, 70, 9), (130, 700, 129), (3, 33, 65), (257, 513, 127), (1, 96, 10),
]


def _operands(m, k, n, dtype=np.float32):
    rng = np.random.default_rng(m * 1000 + n + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 256, 64), (3, 33, 65), (1, 147, 64)])
def test_quantize_bit_equal(m, k, n, dtype):
    x, w = _operands(m, k, n)
    x[-1] = 0.0  # an all-zero row (a padded batch row) takes scale 1
    w[:, -1] = 0.0
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tw = torch.tensor(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    for jfn, tfn, a, b in (
        (jref.quantize_rowwise, ref.quantize_rowwise, jx, tx),
        (jref.quantize_colwise, ref.quantize_colwise, jw, tw),
    ):
        jq, js = jfn(a)
        tq, ts = tfn(b)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_matches_reference_kernel(m, k, n):
    x, w = _operands(m, k, n)
    jxq, jxs = jref.quantize_rowwise(jnp.asarray(x))
    jwq, jws = jref.quantize_colwise(jnp.asarray(w))
    kernel = np.asarray(jops.npu_matmul_prequant(jxq, jxs, jwq, jws, interpret=True))
    oracle = np.asarray(jref.int8_matmul_ref(jxq, jwq, jxs, jws))
    out = ops.int8_matmul(
        torch.tensor(np.asarray(jxq)), torch.tensor(np.asarray(jwq)),
        torch.tensor(np.asarray(jxs)), torch.tensor(np.asarray(jws)),
    )
    assert out.shape == (m, n) and out.dtype == torch.float32
    tol = dict(rtol=1e-6, atol=1e-6) if m == 1 else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), kernel, **tol)
    np.testing.assert_allclose(out.numpy(), oracle, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npu_matmul_dtypes(dtype):
    """f32 and bf16 activations/weights (tests/test_kernels.py:38-47 tolerance)."""
    x, w = _operands(64, 256, 64)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    expect = np.asarray(jops.npu_matmul(jx, jw, interpret=True), np.float32)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tw = torch.tensor(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    out = ops.npu_matmul(tx, tw)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4, atol=1e-3)


def test_cpu_path_launches_nothing():
    x, w = _operands(8, 128, 16)
    before = ops.int8_matmul.launches
    ops.npu_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert ops.int8_matmul.launches == before


def test_plain_version_is_exact_integer_sum():
    """Worst-case operands (all ±127, K = 4608, the widest K of ResNet-50):
    the f64 integer sum is exact, so the plain version equals int64 math."""
    k = 4608
    xq = torch.full((2, k), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    wq = torch.full((k, 3), -127, dtype=torch.int8)
    ones = torch.ones(2), torch.ones(3)
    out = ref.int8_matmul_ref(xq, wq, *ones)
    exact = (xq.to(torch.int64) @ wq.to(torch.int64)).to(torch.float32)
    assert torch.equal(out, exact)


@pytest.mark.parametrize(
    "bad",
    ["dtype", "inner", "scale_shape", "empty"],
)
def test_int8_matmul_rejects_bad_operands(bad):
    xq = torch.zeros((4, 8), dtype=torch.int8)
    wq = torch.zeros((8, 5), dtype=torch.int8)
    xs, ws = torch.ones(4), torch.ones(5)
    if bad == "dtype":
        xq = xq.to(torch.int32)
    elif bad == "inner":
        wq = torch.zeros((7, 5), dtype=torch.int8)
    elif bad == "scale_shape":
        ws = torch.ones(4)
    else:
        xq, xs = torch.zeros((0, 8), dtype=torch.int8), torch.ones(0)
    with pytest.raises((TypeError, ValueError)):
        ops.int8_matmul(xq, wq, xs, ws)
