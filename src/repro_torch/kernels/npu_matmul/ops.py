"""Public wrapper for the NPU int8 matmul.

``int8_matmul(x_q, w_q, x_scale, w_scale)`` runs the hand-written Hopper
kernel (``csrc/int8_matmul.cu``) on CUDA tensors and the plain version
(``ref.int8_matmul_ref``) on CPU tensors; any other device raises.  There is
no fallback: on a CUDA tensor the kernel launches or the call raises.
``npu_matmul(x, w)`` quantizes on the fly (per-row activations, per-channel
weights) and calls ``int8_matmul``.

``int8_matmul.launches`` counts kernel launches (CPU calls do not count), so a
run can show that its GEMMs went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import build
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "int8_matmul.cu"


@functools.cache
def _kernel():
    fn = build.load_library(SOURCE).repro_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x_q, w_q, x_scale, w_scale) -> tuple[int, int, int]:
    if x_q.dim() != 2 or w_q.dim() != 2:
        raise ValueError(f"int8_matmul wants 2-D operands, got {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    M, K = x_q.shape
    K2, N = w_q.shape
    if K != K2:
        raise ValueError(f"int8_matmul: inner dims differ, {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    if min(M, N, K) < 1:
        raise ValueError(f"int8_matmul: empty operand, {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    if x_scale.shape != (M,) or w_scale.shape != (N,):
        raise ValueError(
            f"int8_matmul: scales {tuple(x_scale.shape)}/{tuple(w_scale.shape)} "
            f"do not match M={M}, N={N}"
        )
    for name, t, dt in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                        ("x_scale", x_scale, torch.float32), ("w_scale", w_scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"int8_matmul: {name} must be {dt}, got {t.dtype}")
        if t.device != x_q.device:
            raise ValueError(f"int8_matmul: {name} on {t.device}, x_q on {x_q.device}")
    return M, N, K


def int8_matmul(
    x_q: torch.Tensor,  # [M, K] int8
    w_q: torch.Tensor,  # [K, N] int8
    x_scale: torch.Tensor,  # [M] f32
    w_scale: torch.Tensor,  # [N] f32
) -> torch.Tensor:
    """[M, N] f32 = float(x_q @ w_q) * (x_scale[:, None] * w_scale[None, :])."""
    M, N, K = _check(x_q, w_q, x_scale, w_scale)
    if x_q.device.type == "cpu":
        return ref.int8_matmul_ref(x_q, w_q, x_scale, w_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu tensors, got {x_q.device}")
    for name, t in (("x_q", x_q), ("w_q", w_q), ("x_scale", x_scale), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    with torch.cuda.device(x_q.device):
        err = _kernel()(
            x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
            out.data_ptr(), M, N, K, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def npu_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, N] -> [..., N] f32 through int8 quantization (both sides)."""
    xq, xs = ref.quantize_rowwise(x.reshape(-1, x.shape[-1]))
    wq, ws = ref.quantize_colwise(w)
    out = int8_matmul(xq, wq, xs, ws)
    return out.reshape(*x.shape[:-1], w.shape[-1])
