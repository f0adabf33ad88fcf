"""The port's dry run (``launch/dryrun``) of the vision cells against the
reference's, on the CPU: ViT-S/16, EfficientNet-B7, Swin-B and ResNet-50 at cls_224,
cls_384, serve_b1 and serve_b128, SMOKE configs at the published shapes, traced on
``meta`` (the rules and bands in ``test_torch_analysis.py``); the work units
behind MODEL_FLOPS at the full configs."""
from __future__ import annotations

import pytest
from test_torch_analysis import check_dot_flops, check_flash_bytes, check_totals, check_work_units, family_cells
from test_torch_analysis import reference_work_units

FAMILIES = ("vit", "effnet", "swin", "resnet")
CELLS = family_cells(FAMILIES)


@pytest.fixture(scope="module")
def ref_units():
    return reference_work_units(FAMILIES)


def test_cells_cover_the_family():
    assert len(CELLS) == 16


@pytest.mark.parametrize("name,shape", CELLS)
def test_dot_flops_equal_reference(name, shape):
    check_dot_flops(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_totals_beside_reference(name, shape):
    check_totals(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_flash_accounting_lowers_bytes(name, shape):
    check_flash_bytes(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_work_units_equal_reference(ref_units, name, shape):
    check_work_units(ref_units, name, shape)
