"""NPU execution: run the int8 variant's matmuls through the real kernel.

``quantize.py`` makes the *weights* real int8 (fake-quant round-off); this
module makes the *arithmetic* real: inside an :class:`npu_execution` context
every GEMM a model lowers through ``models.common.matmul()`` — classifier
heads, and convolutions via im2col (``models/convnets.py``) — executes as
``kernels/npu_matmul``'s w8a8 CUDA kernel (its plain version for CPU tensors)
instead of a float contraction.  Weights are re-quantized on every call, as
in the reference; per-output-channel scales match ``quantize._fake_quant``,
so quantizing the already fake-quant weights gives back the deployed int8
values.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..kernels.npu_matmul import ops as npu_ops
from ..models import common


def npu_dense(x2d: torch.Tensor, w2d: torch.Tensor) -> torch.Tensor:
    """One NPU-path GEMM: quantize both sides to int8 and run the kernel."""
    return npu_ops.npu_matmul(x2d, w2d)


class npu_execution(common.matmul_backend):
    """Context manager: every ``models.common.matmul()`` call (and every conv
    lowered through it) routes through ``kernels/npu_matmul`` while active."""

    def __init__(self):
        super().__init__(npu_dense)


def npu_forward(forward: Callable[..., Any]) -> Callable[..., Any]:
    """Wrap a classifier forward so its matmuls execute on the NPU path; the
    wrapped ``forward`` itself stays the full-precision edge variant."""

    def fwd(*args, **kwargs):
        with npu_execution(), torch.no_grad():
            return forward(*args, **kwargs)

    return fwd
