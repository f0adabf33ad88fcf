"""Plain PyTorch version of the NPU int8 matmul (w8a8, per-channel scales).

The ground truth the CUDA kernel must match bit for bit: exact integer
accumulation of int8 x int8 products, then the f32 epilogue in the kernel's
order, ``float(acc) * (x_scale[m] * w_scale[n])``.
"""
from __future__ import annotations

import torch


def _quantize(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale per slice along ``dim``
    (reduced over): scale = max|x| / 127 (1 where the slice is all zero),
    q = clamp(round(x / scale), -127, 127) in f32.  ``torch.round`` rounds
    half to even, like ``jnp.round``.  Eight launches on the card: the max
    is taken in f32 without a cast of ``x``, and the division promotes
    ``x`` to f32 itself."""
    amax = torch.linalg.vector_norm(x, float("inf"), dim=dim, dtype=torch.float32)
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = (x / scale.unsqueeze(dim)).round_().clamp_(-127, 127).to(torch.int8)
    return q.contiguous(), scale


def quantize_rowwise(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of activations [M, K].
    Returns (q [M,K] int8, scale [M] f32)."""
    return _quantize(x, 1)


def quantize_colwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of weights [K, N]."""
    return _quantize(w, 0)


def int8_matmul_ref(
    x_q: torch.Tensor,  # [M, K] int8
    w_q: torch.Tensor,  # [K, N] int8
    x_scale: torch.Tensor,  # [M] f32
    w_scale: torch.Tensor,  # [N] f32
) -> torch.Tensor:
    """[M, N] f32.  The integer sum is taken in float64, which is exact here:
    every partial sum is an integer of magnitude at most 127² · K < 2^53, and
    it works on the card, where ``torch.matmul`` has no int32 path.  The
    f64 -> f32 cast then rounds that integer exactly as the kernel's
    int32 -> f32 conversion does."""
    acc = x_q.to(torch.float64) @ w_q.to(torch.float64)
    return acc.to(torch.float32) * (x_scale[:, None] * w_scale[None, :])


def npu_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """End-to-end fake-quant matmul: quantize both sides, int8 GEMM, dequant."""
    xq, xs = quantize_rowwise(x.reshape(-1, x.shape[-1]))
    wq, ws = quantize_colwise(w)
    out = int8_matmul_ref(xq, wq, xs, ws)
    return out.reshape(*x.shape[:-1], w.shape[-1])
