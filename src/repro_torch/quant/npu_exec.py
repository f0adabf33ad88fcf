"""NPU execution: run the int8 variant's matmuls through the real kernel.

``quantize.py`` makes the *weights* real int8 (fake-quant round-off); this
module makes the *arithmetic* real: inside an :class:`npu_execution` context
every GEMM a model lowers through ``models.common.matmul()`` — classifier
heads, and convolutions via im2col (``models/convnets.py``) — executes as
``kernels/npu_matmul``'s w8a8 CUDA kernel (its plain version for CPU tensors)
instead of a float contraction.  A weight is quantized per output channel
at its first GEMM and kept in int8 while its leaf lives and is not written
(``int8_weight``), as an NPU holds its deployed int8 model; the
activations are quantized per row at every call.  The int8 values and scales
are those of quantizing the weight at every call, as the reference does;
per-output-channel scales match ``quantize._fake_quant``, so quantizing the
already fake-quant weights gives back the deployed int8 values.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..kernels.npu_matmul import ops as npu_ops
from ..kernels.npu_matmul import ref as npu_ref
from ..models import common


def int8_weight(w: torch.Tensor, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """``(w_q [K, N] int8, w_scale [N] f32)`` of weight view ``w`` cast to
    ``dtype``, quantized per output channel at its first GEMM and then
    ``kept`` while its leaf lives and is not written: a weight cast anew
    for each call is quantized each call."""
    return common.kept(("npu_int8", dtype), lambda t: npu_ref.quantize_colwise(t.to(dtype)), w)


def _npu_gemm(x2d: torch.Tensor, w: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One NPU-path GEMM on int8 weights ``(w_q, w_scale)``: the activations
    quantized per row, then the kernel."""
    x_q, x_scale = npu_ref.quantize_rowwise(x2d)
    return npu_ops.int8_matmul(x_q, w[0], x_scale, w[1])


class npu_execution(common.matmul_backend):
    """Context manager: every ``models.common.matmul()`` call (and every conv
    lowered through it) routes through ``kernels/npu_matmul`` while active,
    on the int8 weights ``int8_weight`` keeps."""

    def __init__(self):
        super().__init__(_npu_gemm, int8_weight)


def npu_forward(forward: Callable[..., Any]) -> Callable[..., Any]:
    """Wrap a classifier forward so its matmuls execute on the NPU path; the
    wrapped ``forward`` itself stays the full-precision edge variant."""

    def fwd(*args, **kwargs):
        with npu_execution(), torch.no_grad():
            return forward(*args, **kwargs)

    return fwd
