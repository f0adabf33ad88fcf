"""The port's shape bucketing (``core/bucketing``) against the reference's.

Group keys must equal the reference's so a grid partitions into the same
groups and pads to the same widths in either package: all three quantizers
are compared for every n in 1..10,000, exactly.  The reference's own
contract (never shrinks, monotone, idempotent, ladder values are fixed
points) is checked on the port's functions over the same range; the
reference's hypothesis tests of it do not import on jax 0.9.
"""
from __future__ import annotations

import test_torch_ref  # noqa: F401  (installs the jax 0.9 shims first)

import pytest

from repro.core import bucketing as jbucketing
from repro_torch.core import bucketing as tbucketing

N = range(1, 10_001)
QUANTIZERS = ("quant_w", "quant_bins", "quant_pow2")


def test_ladder_equals_reference():
    assert tbucketing.W_LADDER == jbucketing.W_LADDER


@pytest.mark.parametrize("name", QUANTIZERS)
def test_quantizer_equals_reference(name):
    t, j = getattr(tbucketing, name), getattr(jbucketing, name)
    assert [t(n) for n in N] == [j(n) for n in N]


def test_quant_bins_quantum_equals_reference():
    for q in (1, 32, 128):
        assert [tbucketing.quant_bins(n, q) for n in range(0, 2000)] == \
            [jbucketing.quant_bins(n, q) for n in range(0, 2000)]


@pytest.mark.parametrize("name", QUANTIZERS)
def test_quantizer_contract(name):
    quant = getattr(tbucketing, name)
    out = [quant(n) for n in N]
    assert all(q >= n for q, n in zip(out, N)), "never shrinks"
    assert all(a <= b for a, b in zip(out, out[1:])), "monotone"
    assert all(quant(q) == q for q in set(out)), "idempotent on its outputs"


def test_ladder_values_are_fixed_points():
    assert all(tbucketing.quant_w(w) == w for w in tbucketing.W_LADDER)
    assert tbucketing.quant_w(129) == 256 and tbucketing.quant_pow2(1) == 1
