"""Uniform architecture surface: every ported arch is an ``Arch`` with a
family adapter providing abstract params, state, input specs and, for the
classifiers, the forward.  configs/<id>.py files instantiate these;
``launch/steps`` builds one step program per (arch, shape) from them.

Families ported: ``lm`` (the decoder LMs) and the five classifier families
(resnet, effnet, squeezenet, vit, swin).  ``dit`` and ``flux`` are not
ported yet (ROADMAP item 9) and raise ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .device import resolve_device
from .models import convnets, lm, vision
from .models.common import ParamSpec, param_count, spec

_CLASSIFIERS = ("vit", "swin", "resnet", "effnet", "squeezenet")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | denoise_train | denoise_step | classify_train | classify_serve
    batch: int
    seq: int = 0  # LM sequence / KV-cache length
    img: int = 0  # image resolution (pixel space)
    steps: int = 0  # sampler steps (documentation; one step is run)


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # lm | resnet | effnet | squeezenet | vit | swin (dit | flux: not ported)
    cfg: Any
    shapes: tuple[ShapeSpec, ...] = ()
    notes: str = ""
    # The reference's per-arch overrides of its mesh sharding rules.  The port
    # runs on one card, so they are carried as documentation only.
    sharding_overrides: dict | None = None

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}; have {[s.name for s in self.shapes]}")


def _not_ported(arch: Arch) -> ValueError:
    return ValueError(f"family {arch.family!r} ({arch.name}) is not ported; ROADMAP item 9")


def abstract_params(arch: Arch):
    """(params specs, state specs) for ``arch``."""
    if arch.family == "lm":
        return lm.abstract_params(arch.cfg), {}
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
    if arch.family in ("dit", "flux"):
        raise _not_ported(arch)
    raise ValueError(f"unknown family {arch.family!r}")


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


# Input specs per (arch, shape) ----------------------------------------------


def input_specs(arch: Arch, shape: ShapeSpec) -> dict[str, ParamSpec]:
    """Abstract batch inputs with the reference's logical axes."""
    B = shape.batch
    f = arch.family
    if f == "lm":
        if shape.kind == "train":
            return {
                "tokens": spec((B, shape.seq), ("batch", "seq"), dtype=torch.int32, init="zeros"),
                "labels": spec((B, shape.seq), ("batch", "seq"), dtype=torch.int32, init="zeros"),
            }
        if shape.kind == "prefill":
            return {"tokens": spec((B, shape.seq), ("batch", "seq"), dtype=torch.int32, init="zeros")}
        if shape.kind == "decode":
            return {"token": spec((B, 1), ("batch", None), dtype=torch.int32, init="zeros")}
    if f in ("dit", "flux"):
        raise _not_ported(arch)
    if f in _CLASSIFIERS:
        base = {"images": spec((B, shape.img, shape.img, 3), ("batch", "spatial", None, None))}
        if shape.kind == "classify_train":
            base["labels"] = spec((B,), ("batch",), dtype=torch.int32, init="zeros")
        return base
    raise ValueError(f"no input spec for {arch.name}/{shape.name}")


def make_inputs(arch: Arch, shape: ShapeSpec, seed: int | torch.Generator = 0, *,
                device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """Concrete random inputs for ``input_specs(arch, shape)``: integer
    inputs uniform below the vocabulary (LM) or the class count, float ones
    standard normal.  Inputs draw from ``seed`` (an int, or a generator on
    ``device``) in sorted-name order."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, s in sorted(input_specs(arch, shape).items()):
        if s.dtype.is_floating_point:
            out[name] = torch.randn(s.shape, generator=gen, dtype=s.dtype, device=device)
        else:
            hi = arch.cfg.vocab if arch.family == "lm" else getattr(arch.cfg, "n_classes", 1000)
            out[name] = torch.randint(0, hi, s.shape, generator=gen, dtype=s.dtype, device=device)
    return out
