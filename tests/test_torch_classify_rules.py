"""The classifiers' serving steps under mesh rules on real ranks: ViT-S/16,
Swin-B, ResNet-50, EfficientNet-B7 and SqueezeNet, SMOKE configs in f32,
through ``launch/steps.build_cell(..., rules=MeshRules(mesh,
serve_rules(mesh)))`` (``classify_serve``) on 4 gloo ranks, against the
reference's ``build_cell`` under ``jax.jit(in_shardings=prog.shardings())``
on 4 forced host devices and against the port's step without rules: the
checks of ``tests/test_torch_diffusion_rules.py``, on the logits put
together from the ranks' shards (split over ``vocab`` where the ``model``
extent divides the classes).

Meshes (2, 2), (1, 4) and (4, 1) for ViT and ResNet-50, (1, 4) and (2, 2)
for Swin and EfficientNet-B7, (1, 4) for SqueezeNet, all at batch 4 on
32 x 32 images; ``serve_b1``'s batch of 1 on (2, 2), where the batch stays
whole on ``data``.  The convs split their output channels over ``model``
(``conv_out``), BatchNorm and the SE biases follow, depthwise convs run on
the rank's channels; the SMOKE widths the extent does not divide stay
whole.  ViT's SMOKE config has 4 heads, which 4 divides; a variant with 6
heads (d 96, ``dataclasses.replace``) on (1, 4) keeps its heads whole on
every rank while its MLP splits.
"""
from __future__ import annotations

import pytest
from test_torch_diffusion_rules import MESHES, case, check_case, run_cases

SERVE = ("serve", "classify_serve", 4, 0, 32)
SERVE_B1 = ("serve_b1", "classify_serve", 1, 0, 32)

CASES = {
    **{f"vit/{m}": case("vit-s16", SERVE, m) for m in MESHES},
    "vit_6_heads/1x4": case("vit-s16", SERVE, "1x4", n_heads=6, d_model=96),
    **{f"resnet/{m}": case("resnet-50", SERVE, m) for m in MESHES},
    "resnet/serve_b1/2x2": case("resnet-50", SERVE_B1, "2x2"),
    "swin/1x4": case("swin-b", SERVE, "1x4"),
    "swin/2x2": case("swin-b", SERVE, "2x2"),
    "effnet/2x2": case("efficientnet-b7", SERVE, "2x2"),
    "effnet/1x4": case("efficientnet-b7", SERVE, "1x4"),
    "squeezenet/1x4": case("squeezenet", SERVE, "1x4"),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("classify_rules"), CASES, seed=41)


@pytest.mark.parametrize("key", list(CASES))
def test_ruled_classify_serve_equals_reference_on_ranks(results, key):
    check_case(key, results[key])
