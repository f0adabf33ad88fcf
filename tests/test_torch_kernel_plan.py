"""What the port's CUDA wrappers decide before they launch, held on the CPU.

The int8 GEMM's ``plan`` (row tile and split-K count), ``k_per_split`` and
``load_widths``, and flash attention's ``kernel_path`` and ``blocks``, are
plain Python: the kernels trust them for bounds (every split non-empty, the
workspace large enough, 16-byte copies only where rows are 16-byte aligned),
so they are held here over the shapes the card checks and a grid around
them.  Exact integer checks; no tolerance.
"""
from __future__ import annotations

import itertools
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the repo root
from chip_smoke import FLASH_SHAPES, GEMM_SHAPES, MISALIGNED, at_offset  # noqa: E402

from repro_torch import arch as A
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.npu_matmul import ops, ref
from repro_torch.models.common import matmul_backend, tree_map

GRID = [  # (M, K, N): thin to tall M, ragged and long K, narrow to wide N
    (m, k, n) for m, k, n in itertools.product((1, 17, 49, 196, 257, 3136, 12544, 100352),
                                               (16, 27, 64, 147, 1000, 4608), (10, 64, 1000, 2048))
]
SHAPES = list(dict.fromkeys(GEMM_SHAPES + [(m, k, n) for m, k, n, _ in MISALIGNED] + GRID))


def _blocks(M, N, K):
    bm, splits = ops.plan(M, N, K)
    return ops.cdiv(M, bm) * ops.cdiv(N, ops.BN) * splits


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_splits_cover_k_exactly_once(m, k, n):
    _, splits = ops.plan(m, n, k)
    per = ops.k_per_split(k, splits) * ops.BK
    ranges = [(s * per, min((s + 1) * per, k)) for s in range(splits)]
    assert all(lo < hi for lo, hi in ranges), f"an empty split in {ranges}"
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), f"splits overlap or leave a gap: {ranges}"


def test_splits_cover_k_exactly_once_over_the_grid():
    for m, k, n in SHAPES:
        _, splits = ops.plan(m, n, k)
        per = ops.k_per_split(k, splits)
        covered = [step for s in range(splits) for step in range(s * per, min((s + 1) * per, ops.cdiv(k, ops.BK)))]
        assert covered == list(range(ops.cdiv(k, ops.BK))), (m, k, n)
        assert (splits - 1) * per < ops.cdiv(k, ops.BK), f"{(m, k, n)}: the last split is empty"


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_plan_fits_workspace_and_grid(m, k, n):
    bm, splits = ops.plan(m, n, k)
    tiles = ops.cdiv(m, bm) * ops.cdiv(n, ops.BN)
    assert bm in ops.ROW_TILES and 1 <= splits <= ops.MAX_SPLITS
    assert ops.cdiv(m, bm) <= ops.MAX_GRID_Y
    if splits > 1:
        assert tiles * splits * bm * ops.BN <= ops.WS_ELEMS  # int32 partial tiles
        assert tiles <= ops.WS_TILES  # one arrival counter per output tile
        assert tiles * splits <= ops.SMS  # about one wave


def test_plan_fits_workspace_over_the_grid():
    for m, k, n in SHAPES:
        bm, splits = ops.plan(m, n, k)
        tiles = ops.cdiv(m, bm) * ops.cdiv(n, ops.BN)
        if splits > 1:
            assert tiles * splits * bm * ops.BN <= ops.WS_ELEMS and tiles <= ops.WS_TILES, (m, k, n)
            assert ops.k_per_split(k, splits) >= ops.MIN_SPLIT_STEPS or splits == 1, (m, k, n)


def _b7_gemm_shapes(batch: int) -> list[tuple[int, int, int]]:
    """(M, K, N) of every GEMM a full-width EfficientNet-B7 NPU forward issues
    at 224², in call order, traced on the meta device (shapes, no compute)."""
    arch = configs.get("efficientnet-b7")
    specs, state_specs = A.abstract_params(arch)
    params, state = (tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), t)
                     for t in (specs, state_specs))
    shapes = []
    with matmul_backend(lambda x, w: (shapes.append((x.shape[0], x.shape[1], w.shape[1])), x @ w)[1]):
        A.classifier_forward(arch, params, state, torch.empty(batch, 224, 224, 3, device="meta"), train=False)
    return shapes


@pytest.mark.parametrize("batch", [1, 8])
def test_b7_gemm_shapes_take_valid_launches(batch):
    """B7's 219 GEMMs, shapes ResNet-50 and SqueezeNet never gave the kernel
    (squeeze-excite pairs at M = batch with K and N down to 8, K = 12 or 20
    on the narrow path, the stem's K = 27, the head conv and head): every
    plan fits the grid and the workspace, its splits cover K exactly once,
    and each operand's loads are the widest its row stride allows."""
    shapes = _b7_gemm_shapes(batch)
    assert len(shapes) == 219
    assert shapes[0] == (batch * 112 * 112, 27, 64)
    assert shapes[-2:] == [(batch * 49, 640, 2560), (batch, 2560, 1000)]
    for pair in [((batch, 32, 8), (batch, 8, 32)), ((batch, 288, 12), (batch, 12, 288)),
                 ((batch, 3840, 160), (batch, 160, 3840))]:
        assert all(s in shapes for s in pair), pair
    base = 1 << 20
    for m, k, n in dict.fromkeys(shapes):
        bm, splits = ops.plan(m, n, k)
        tiles = ops.cdiv(m, bm) * ops.cdiv(n, ops.BN)
        assert bm in ops.ROW_TILES and 1 <= splits <= ops.MAX_SPLITS and ops.cdiv(m, bm) <= ops.MAX_GRID_Y
        if splits > 1:
            assert tiles * splits * bm * ops.BN <= ops.WS_ELEMS and tiles <= ops.WS_TILES, (m, k, n)
        per = ops.k_per_split(k, splits)
        assert (splits - 1) * per < ops.cdiv(k, ops.BK) <= splits * per, (m, k, n)
        widths = ops.load_widths(k, n, base, base)
        assert widths == tuple(next(w for w in (16, 4, 1) if d % w == 0) for d in (k, n)), (m, k, n)


@pytest.mark.parametrize("m,k,n,min_blocks", [
    (49, 4608, 512, 100),  # ResNet-50 stage 4, 3x3: 8 blocks before the split
    (49, 2048, 512, 100),
    (1, 2048, 1000, 100),  # the head at batch 1
    (196, 2304, 256, 100),
])
def test_thin_long_k_shapes_fill_the_card(m, k, n, min_blocks):
    assert _blocks(m, n, k) >= min_blocks
    assert ops.plan(m, n, k)[1] > 1


@pytest.mark.parametrize("m", [1, 2, 8, 16])
def test_few_rows_take_the_16_row_tile(m):
    assert ops.plan(m, 1000, 2048)[0] == 16


def test_tall_shapes_take_the_128_row_tile_unsplit():
    assert ops.plan(100352, 64, 147) == (128, 1)  # ResNet-50 conv1 at batch 8


@pytest.mark.parametrize("k,n,x_off,w_off,widths", [
    (512, 512, 0, 0, (16, 16)),
    (147, 64, 0, 0, (1, 16)),  # ResNet-50 conv1: K ragged
    (27, 64, 0, 0, (1, 16)),  # SqueezeNet conv1
    (2048, 1000, 0, 0, (16, 4)),  # the head: N % 16 = 8, N % 4 = 0
    (64, 10, 0, 0, (16, 1)),  # the smoke models' head
    (300, 100, 0, 0, (4, 4)),
    (512, 512, 1, 0, (1, 16)),  # a base pointer off alignment forbids 16-byte loads
    (512, 512, 0, 8, (16, 4)),
    (512, 512, 4, 2, (4, 1)),
])
def test_load_widths(k, n, x_off, w_off, widths):
    base = 1 << 20
    assert ops.load_widths(k, n, base + x_off, base + w_off) == widths


@pytest.mark.parametrize("m,k,n,offset", MISALIGNED)
def test_load_widths_of_offset_tensors(m, k, n, offset):
    """chip_smoke's misaligned operands: views ``offset`` bytes into their
    storage take the narrow path, and the CPU path still equals the plain version."""
    g = torch.Generator().manual_seed(m + k + n)
    xq, xs = ref.quantize_rowwise(torch.randn(m, k, generator=g))
    wq, ws = ref.quantize_colwise(torch.randn(k, n, generator=g))
    xo, wo = at_offset(torch, xq, offset), at_offset(torch, wq, offset)
    assert torch.equal(xo, xq) and xo.is_contiguous()
    x_w, w_w = ops.load_widths(k, n, xo.data_ptr(), wo.data_ptr())
    assert x_w < 16 and w_w < 16
    assert torch.equal(ops.int8_matmul(xo, wo, xs, ws), ref.int8_matmul_ref(xq, wq, xs, ws))


@pytest.mark.parametrize("dtype,offsets,path", [
    (torch.bfloat16, (0, 0, 0), "mma"),
    (torch.float32, (0, 0, 0), "fma"),  # f32 stays on the CUDA cores
    (torch.bfloat16, (2, 0, 0), "fma"),  # q one element off 16-byte alignment
    (torch.bfloat16, (0, 0, 8), "fma"),  # v likewise
    (torch.bfloat16, (16, 32, 48), "mma"),
])
def test_flash_kernel_path(dtype, offsets, path):
    base = 1 << 20
    assert flash_ops.kernel_path(dtype, *(base + o for o in offsets)) == path


@pytest.mark.parametrize("b,s,t,h,kh,hd,causal,dtype", FLASH_SHAPES)
def test_flash_blocks_cover_the_folded_rows(b, s, t, h, kh, hd, causal, dtype):
    """One block per 16 rows of each (batch, KV head)'s G·S folded rows."""
    blocks = flash_ops.blocks(b, s, h, kh)
    per_head = blocks // (b * kh)
    assert per_head * b * kh == blocks
    assert (per_head - 1) * flash_ops.ROWS < (h // kh) * s <= per_head * flash_ops.ROWS
    assert b * kh <= flash_ops.MAX_GRID_Y


def test_flash_blocks_at_vit_s16():
    assert flash_ops.blocks(1, 197, 6, 6) == 78  # 13 row tiles x 6 heads at batch 1
    assert flash_ops.blocks(8, 197, 6, 6) == 624
    assert flash_ops.kv_tile(64) == 32 and flash_ops.kv_tile(128) == 16
