"""The port's CUDA kernel on the card, against its plain version.

Needs an NVIDIA card and nvcc; skips elsewhere.  Imports only ``torch`` and
``repro_torch`` (no JAX), so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerance: exact.  Both sides sum int8 products exactly (int32 in the
kernel, float64 below 2^53 in the plain version) and apply the same single
f32 epilogue multiply, so outputs are compared bit for bit.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import arch as A
from repro_torch import configs, quant
from repro_torch.kernels.npu_matmul import ops, ref
from repro_torch.models.common import init_tree, matmul_backend

SHAPES = [  # tests/test_kernels.py, then main-path shapes: the ResNet-50 stem,
    # the per-frame head, the SqueezeNet stem (K = 27) and a stage-3 3x3 conv
    (128, 512, 128), (256, 1024, 384), (64, 300, 100), (8, 128, 128), (1, 64, 1),
    (130, 70, 9), (130, 700, 129), (3, 33, 65), (257, 513, 127), (1, 96, 10),
    (12544, 147, 64), (1, 2048, 1000), (12544, 27, 64), (49, 4608, 512),
]


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


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    xq = torch.zeros(8, 16, dtype=torch.int8, device=cuda_device)
    wq = torch.zeros(8, 16, dtype=torch.int8, device=cuda_device).t()
    with pytest.raises(ValueError):
        ops.int8_matmul(xq, wq, torch.ones(8, device=cuda_device), torch.ones(8, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("name,gemms", [("resnet-50", 10), ("squeezenet", 26)])
def test_npu_forward_through_kernel_equals_plain_backend(cuda_device, name, gemms):
    arch = configs.get(name, smoke=True)
    specs, state_specs = A.abstract_params(arch)
    params = init_tree(torch.Generator().manual_seed(0), specs, device=cuda_device)
    state = init_tree(torch.Generator().manual_seed(1), state_specs, device=cuda_device)
    qparams, _ = quant.npu_variant(params)

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
