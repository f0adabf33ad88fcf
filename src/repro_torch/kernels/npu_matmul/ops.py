"""Public wrapper for the NPU int8 matmul.

``int8_matmul(x_q, w_q, x_scale, w_scale)`` runs the hand-written Hopper
kernel (``csrc/int8_matmul.cu``) on CUDA tensors and the plain version
(``ref.int8_matmul_ref``) on CPU tensors; any other device raises.  There is
no fallback: on a CUDA tensor the kernel launches or the call raises.
``npu_matmul(x, w)`` quantizes on the fly (per-row activations, per-channel
weights) and calls ``int8_matmul``.

The kernel runs on the int8 tensor cores.  Per call the wrapper picks, in
plain Python that the CPU tests hold:
  * ``plan(M, N, K)``: the row tile (16, 64 or 128 rows by 64 columns) and a
    split-K count, so that a call puts about one wave of blocks on the card;
  * ``load_widths(K, N, x_ptr, w_ptr)``: per operand, 16-byte ``cp.async``
    copies where its row stride and base pointer allow them, else a masked
    narrow path (4-byte words, or bytes).
Split-K sums int32 partial tiles in a workspace allocated once per device
(``workspace``); the last block of a tile resets its counter, so a call
allocates and clears nothing.  Launches on one device must therefore be
ordered, as they are on one stream.

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
SMS = 132  # streaming multiprocessors of an H100 SXM: one wave of blocks
BN = 64  # output columns per block (BN in csrc/int8_matmul.cu)
BK = 128  # K bytes per pipeline step (BK in csrc/int8_matmul.cu)
ROW_TILES = (16, 64, 128)  # output rows per block
THIN_M = 256  # up to this many rows, 16-row tiles
MAX_SPLITS = 8  # the last block of a tile reads every split's partial tile
MIN_SPLIT_STEPS = 2  # BK steps a split walks, at least
WS_TILES = SMS  # split-K: output tiles x splits the workspace holds ...
WS_ELEMS = WS_TILES * 64 * BN  # ... as int32 partial tiles of at most 64 rows
MAX_GRID_Y = 65535  # the kernel's grid puts the row tiles on y


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(M: int, N: int, K: int) -> tuple[int, int]:
    """(row tile, K splits) for an [M, K] x [K, N] call.

    The row tile is 128 where that alone gives a wave of blocks; else 16 for
    thin M (at most ``THIN_M`` rows: small tiles give more blocks, and
    M = 1 pads to 16 rows, not 64), else 64.  Where the tiles are fewer than
    a wave, K is split among up to ``SMS // tiles`` blocks a tile (at most
    ``MAX_SPLITS``), each walking at least ``MIN_SPLIT_STEPS`` steps, and
    the count is trimmed so that no split is empty (``k_per_split``)."""
    n_tiles = cdiv(N, BN)
    if cdiv(M, 128) * n_tiles >= SMS:
        bm = 128
    else:
        bm = 16 if M <= THIN_M else 64
    tiles = cdiv(M, bm) * n_tiles
    k_steps = cdiv(K, BK)
    splits = max(1, min(SMS // tiles, k_steps // MIN_SPLIT_STEPS, MAX_SPLITS))
    return bm, cdiv(k_steps, k_per_split(K, splits))


def k_per_split(K: int, splits: int) -> int:
    """BK steps each split walks; split s covers steps [s * k_per, (s + 1) * k_per)."""
    return cdiv(cdiv(K, BK), splits)


def load_widths(K: int, N: int, x_ptr: int, w_ptr: int) -> tuple[int, int]:
    """Load width in bytes of x_q [M, K] and of w_q [K, N]: 16 (``cp.async``
    copies) where every row starts 16-byte aligned, i.e. the row stride and
    the base pointer are multiples of 16; else the narrow path, with 4-byte
    words where both are multiples of 4 and single bytes otherwise."""
    def width(stride: int, ptr: int) -> int:
        return next(w for w in (16, 4, 1) if stride % w == 0 and ptr % w == 0)
    return width(K, x_ptr), width(N, w_ptr)


def workspace(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The split-K partial tiles and per-tile arrival counters of ``device``,
    allocated (the counters zeroed) at its first call and kept."""
    return _workspace(device.index if device.index is not None else torch.cuda.current_device())


@functools.cache
def _workspace(index: int) -> tuple[torch.Tensor, torch.Tensor]:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("int8_matmul: call it once on this device before capturing a CUDA graph "
                           "(its split-K workspace is allocated at the first call)")
    device = torch.device("cuda", index)
    got = (torch.empty(WS_ELEMS, dtype=torch.int32, device=device),
           torch.zeros(WS_TILES, dtype=torch.int32, device=device))
    torch.cuda.synchronize(device)  # the counters are zero before any stream launches on them
    return got


@functools.cache
def _kernel():
    fn = build.load_library(SOURCE).repro_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
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
    bm, splits = plan(M, N, K)
    if cdiv(M, bm) > MAX_GRID_Y:
        raise ValueError(f"int8_matmul: M = {M} exceeds the kernel's grid ({MAX_GRID_Y} tiles of {bm} rows)")
    x_ptr, w_ptr = x_q.data_ptr(), w_q.data_ptr()
    x_width, w_width = load_widths(K, N, x_ptr, w_ptr)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    with torch.cuda.device(x_q.device):
        partials, counters = workspace(x_q.device)
        err = _kernel()(
            x_ptr, w_ptr, x_scale.data_ptr(), w_scale.data_ptr(), out.data_ptr(),
            M, N, K, bm, splits, k_per_split(K, splits), x_width, w_width,
            partials.data_ptr(), counters.data_ptr(), torch.cuda.current_stream().cuda_stream,
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
