"""Uniform architecture surface for the classifier families the port has:
an ``Arch`` names a family and its config; ``abstract_params`` and
``classifier_forward`` dispatch on the family.  configs/<id>.py files
instantiate these.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .models import convnets, vision
from .models.common import param_count


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # resnet | effnet | squeezenet | vit | swin
    cfg: Any


def abstract_params(arch: Arch):
    """(params specs, state specs) for ``arch``."""
    if arch.family == "resnet":
        return convnets.resnet_abstract(arch.cfg)
    if arch.family == "effnet":
        return convnets.effnet_abstract(arch.cfg)
    if arch.family == "squeezenet":
        return convnets.squeezenet_abstract(arch.cfg)
    if arch.family == "vit":
        return vision.vit_abstract_params(arch.cfg), {}
    if arch.family == "swin":
        return vision.swin_abstract_params(arch.cfg), {}
    raise ValueError(f"family {arch.family!r} is not ported (have resnet, effnet, squeezenet, vit, swin)")


def classifier_forward(arch: Arch, params, state, images, *, train: bool):
    """images [B, H, W, 3] -> (logits [B, n_classes] f32, new_state)."""
    if arch.family == "resnet":
        return convnets.resnet_forward(arch.cfg, params, state, images, train=train)
    if arch.family == "effnet":
        return convnets.effnet_forward(arch.cfg, params, state, images, train=train)
    if arch.family == "squeezenet":
        return convnets.squeezenet_forward(arch.cfg, params, state, images, train=train)
    if arch.family == "vit":
        return vision.vit_forward(arch.cfg, params, images), state
    if arch.family == "swin":
        return vision.swin_forward(arch.cfg, params, images), state
    raise ValueError(f"family {arch.family!r} is not a ported classifier family")


def n_params(arch: Arch) -> int:
    return param_count(abstract_params(arch)[0])
