"""The MoE LMs' serving steps under mesh rules on real ranks:
qwen2-moe-a2.7b (8 experts top-4 with shared experts, 4 / 4 heads) and
deepseek-moe-16b (8 experts top-6), SMOKE configs in f32, on 4 gloo ranks
against the reference's 4 forced host devices and the port without rules:
the checks of ``tests/test_torch_lm_rules.py``.  On (1, 4) the experts
split over ``model`` (EP: each rank runs two experts' slots, one sum of the
partial outputs with the shared experts'), on (2, 2) over two ranks a
batch group, on (4, 1) only the batch.
"""
from __future__ import annotations

import pytest
from test_torch_lm_rules import DECODE, PREFILL, case, check_case, run_cases

CASES = {
    "qwen2-moe/prefill/1x4": case("qwen2-moe-a2.7b", PREFILL, "1x4"),
    "qwen2-moe/prefill/2x2": case("qwen2-moe-a2.7b", PREFILL, "2x2"),
    "qwen2-moe/decode/1x4": case("qwen2-moe-a2.7b", DECODE, "1x4"),
    "qwen2-moe/decode/4x1": case("qwen2-moe-a2.7b", DECODE, "4x1"),
    "deepseek/prefill/1x4": case("deepseek-moe-16b", PREFILL, "1x4"),
    "deepseek/prefill/4x1": case("deepseek-moe-16b", PREFILL, "4x1"),
    "deepseek/decode/2x2": case("deepseek-moe-16b", DECODE, "2x2", length=4),
    "deepseek/decode_int8/1x4": case("deepseek-moe-16b", DECODE, "1x4", quant=True),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_rules_moe"), CASES, seed=31)


@pytest.mark.parametrize("key", list(CASES))
def test_ruled_moe_step_equals_reference_on_ranks(results, key):
    check_case(results[key])
