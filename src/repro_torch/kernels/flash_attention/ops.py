"""Public wrapper for flash attention.

``attention(q, k, v, causal=...)`` runs the hand-written Hopper kernel
(``csrc/flash_attention.cu``) on CUDA tensors and the plain version
(``ref.sdpa_ref``) on CPU tensors; any other device raises.  There is no
fallback: on a CUDA tensor the kernel launches or the call raises.

The source holds two kernels and the wrapper picks one at launch
(``kernel_path``): bf16 with 16-byte aligned q, k, v runs on the tensor
cores (``mma.sync`` fed by ``ldmatrix`` and ``cp.async``); f32, and bf16
views at an address that is not 16-byte aligned, run on the CUDA cores.
``blocks`` gives the grid either kernel launches.

``flash_attention.launches`` counts kernel launches (CPU calls do not
count), so a run can show that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import build
from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = {"fma": 0, "mma": 1}  # CUDA-core kernel, tensor-core kernel
ROWS = 16  # query rows of the (s, g)-folded row axis per block, in both kernels
WARPS = 4  # warps per block; the tensor-core kernel splits the KV tiles among them
MAX_GRID_Y = 65535  # the kernels' grid puts B * KH on y


@functools.cache
def _kernel():
    fn = build.load_library(SOURCE).repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants 4-D q/k/v, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if min(B, S, T, H, KH) < 1:
        raise ValueError(f"flash_attention: empty operand, q {tuple(q.shape)} k {tuple(k.shape)}")
    if H % KH != 0:
        raise ValueError(f"flash_attention: {H} query heads do not group over {KH} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the kernel takes {list(DTYPES)}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    return B, S, T, H, KH, hd


def kernel_path(dtype: torch.dtype, *ptrs: int) -> str:
    """``"mma"`` (tensor cores) for bf16 whose every pointer is 16-byte
    aligned, the tensor-core kernel's ``cp.async`` granule; ``"fma"`` (CUDA
    cores) otherwise.  f32 stays on the CUDA cores: the reference's f32
    tolerance rules out TF32."""
    return "mma" if dtype == torch.bfloat16 and all(p % 16 == 0 for p in ptrs) else "fma"


def kv_tile(hd: int) -> int:
    """KV columns per tile of the tensor-core kernel (``MmaCfg::KV``)."""
    return 32 if hd <= 64 else 16


def blocks(B: int, S: int, H: int, KH: int) -> int:
    """Blocks of ``WARPS`` warps either kernel launches: one per 16 rows of
    the (s, g)-folded row axis of each (batch, KV head)."""
    return -(-(H // KH) * S // ROWS) * B * KH


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """q [B,S,H,hd], k/v [B,T,KH,hd] (f32 or bf16, contiguous, hd in
    ``HEAD_DIMS``) -> [B,S,H,hd] in q's dtype.  The causal mask is
    bottom-right aligned (query ``s`` sees key ``t <= s + T - S``)."""
    B, S, T, H, KH, hd = _check(q, k, v)
    if q.device.type == "cpu":
        return ref.sdpa_ref(q, k, v, causal=causal)
    if B * KH > MAX_GRID_Y:
        raise ValueError(f"flash_attention: B * KH = {B * KH} exceeds the kernel's grid ({MAX_GRID_Y})")
    out = torch.empty_like(q)
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    with torch.cuda.device(q.device):
        err = _kernel()(
            *ptrs, out.data_ptr(), B, S, T, H, KH, hd, int(causal), DTYPES[q.dtype],
            PATHS[kernel_path(q.dtype, *ptrs)], 1.0 / (hd**0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def attention(q, k, v, *, causal: bool = True, block_q: int = 256, block_kv: int = 512):
    """The reference's ``ops.attention`` signature.  ``block_q``/``block_kv``
    are the TPU kernel's VMEM tile sizes.  The CUDA kernels' tiles are fixed
    in their source: a block of 4 warps owns 16 query rows; on the tensor
    cores its warps split the KV tiles (32 columns, 16 at hd 128) among
    themselves and merge at the end, on the CUDA cores each warp owns 4 of
    the rows for the whole sweep over 32-column tiles.  So the two sizes are
    accepted and ignored."""
    del block_q, block_kv
    return flash_attention(q, k, v, causal=causal)
