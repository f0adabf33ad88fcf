"""The classifiers' training step under mesh rules on real ranks: ViT-S/16
on (2, 2), Swin-B on (1, 4), ResNet-50 on (2, 2) and (4, 1) (and with
``accum_steps`` 2 on (2, 2)), EfficientNet-B7 on (2, 2), SMOKE configs in
f32 at batch 4 on 32 x 32 images, through ``launch/steps.build_cell(...,
rules=MeshRules(mesh, train_rules(mesh)))`` (``classify_train``) on 4 gloo
ranks, against the reference's ``build_cell`` on 4 forced host devices and
against the port's step without rules: the checks of
``tests/test_torch_lm_train_rules.py``.  BatchNorm takes its statistics
over the whole batch, split over ``data``, and its running state comes back
whole on every rank; the logits stay split on ``vocab`` where ``model``
divides the classes; with ``accum_steps`` 2 the microbatches are rows of the
global batch, so each microbatch's statistics are the reference's.
"""
from __future__ import annotations

import pytest
from test_torch_lm_train_rules import case, check_case, run_cases

CLASSIFY = ("classify_train", 4, 0, 32)

CASES = {
    "vit/2x2": case("vit-s16", CLASSIFY, "2x2"),
    "swin/1x4": case("swin-b", CLASSIFY, "1x4"),
    "resnet/2x2": case("resnet-50", CLASSIFY, "2x2"),
    "resnet/4x1": case("resnet-50", CLASSIFY, "4x1"),
    "resnet_accum2/2x2": case("resnet-50", CLASSIFY, "2x2", accum=2),
    "effnet/2x2": case("efficientnet-b7", ("classify_train", 4, 0, 64), "2x2"),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("classify_train_rules"), CASES, seed=81)


@pytest.mark.parametrize("key", list(CASES))
def test_ruled_classify_train_step_equals_reference_on_ranks(results, key):
    check_case(key, results[key])
