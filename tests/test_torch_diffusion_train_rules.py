"""The diffusion models' training step under mesh rules on real ranks:
DiT-XL/2 on (2, 2) and Flux-dev on (1, 4), SMOKE configs in f32, at batch 4
on an 8 x 8 latent, through ``launch/steps.build_cell(...,
rules=MeshRules(mesh, train_rules(mesh)))`` (``denoise_train``) on 4 gloo
ranks, against the reference's ``build_cell`` on 4 forced host devices and
against the port's step without rules: the checks of
``tests/test_torch_lm_train_rules.py``.  DiT's adaLN modulation is gathered
under autograd (its columns split over ``model``); Flux's image residual and
its joint sequence split over ``act_seq`` while the gradient flows back
through them; the losses are the global batch's means.  Flux once more
with every attention through ``blockwise_sdpa`` on the rank's heads
(``BLOCKWISE_THRESHOLD`` 0 in both packages), as train_1024 trains.
"""
from __future__ import annotations

import pytest
from test_torch_lm_train_rules import case, check_case, run_cases

DENOISE = ("denoise_train", 4, 0, 64)

CASES = {
    "dit/2x2": case("dit-xl2", DENOISE, "2x2"),
    "flux/1x4": case("flux-dev", DENOISE, "1x4"),
    "flux_blockwise/1x4": case("flux-dev", DENOISE, "1x4", blockwise=True),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("diffusion_train_rules"), CASES, seed=71)


@pytest.mark.parametrize("key", list(CASES))
def test_ruled_denoise_train_step_equals_reference_on_ranks(results, key):
    check_case(key, results[key])
