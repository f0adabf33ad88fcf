"""Uniform architecture surface: every ported arch is an ``Arch`` with a
family adapter providing abstract params, state, input specs and, for the
classifiers, the forward.  configs/<id>.py files instantiate these;
``launch/steps`` builds one step program per (arch, shape) from them.

Families: ``lm`` (the decoder LMs), ``dit`` and ``flux`` (the diffusion
backbones) and the five classifier families (resnet, effnet, squeezenet,
vit, swin) — every family the reference registers.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .device import resolve_device
from .models import convnets, diffusion, lm, vision
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
    family: str  # lm | dit | flux | vit | swin | resnet | effnet | squeezenet
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


def abstract_params(arch: Arch):
    """(params specs, state specs) for ``arch``."""
    if arch.family == "lm":
        return lm.abstract_params(arch.cfg), {}
    if arch.family == "dit":
        return diffusion.dit_abstract_params(arch.cfg), {}
    if arch.family == "flux":
        return diffusion.flux_abstract_params(arch.cfg), {}
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


def _img_latent(arch: Arch, img: int) -> tuple[int, int]:
    """(latent side, latent channels) of a diffusion arch at ``img`` pixels."""
    if arch.family in ("dit", "flux"):
        return img // 8, arch.cfg.in_ch
    raise ValueError(f"{arch.name}: family {arch.family!r} has no latent")


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
        lat, ch = _img_latent(arch, shape.img)
        base = {
            "x": spec((B, lat, lat, ch), ("batch", None, None, None)),
            "t": spec((B,), ("batch",)),
        }
        if f == "dit":
            base["y"] = spec((B,), ("batch",), dtype=torch.int32, init="zeros")
        else:
            base["txt"] = spec((B, arch.cfg.txt_len, arch.cfg.txt_dim), ("batch", None, None))
            base["vec"] = spec((B, arch.cfg.vec_dim), ("batch", None))
            base["guidance"] = spec((B,), ("batch",))
        if shape.kind == "denoise_train":
            base["noise"] = spec((B, lat, lat, ch), ("batch", None, None, None))
        else:
            base["dt"] = spec((B,), ("batch",))
        return base
    if f in _CLASSIFIERS:
        base = {"images": spec((B, shape.img, shape.img, 3), ("batch", "spatial", None, None))}
        if shape.kind == "classify_train":
            base["labels"] = spec((B,), ("batch",), dtype=torch.int32, init="zeros")
        return base
    raise ValueError(f"no input spec for {arch.name}/{shape.name}")


def make_inputs(arch: Arch, shape: ShapeSpec, seed: int | torch.Generator = 0, *,
                device: torch.device | str = "cuda") -> dict[str, torch.Tensor]:
    """Concrete random inputs for ``input_specs(arch, shape)``, by the
    reference's per-name rules: integer inputs uniform below the vocabulary
    (LM) or the class count; a diffusion step's ``t`` uniform in [0.02,
    0.98], ``dt`` filled with 0.02, ``guidance`` with 4.0; every other float
    standard normal.  Inputs draw from ``seed`` (an int, or a generator on
    ``device``) in sorted-name order."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, s in sorted(input_specs(arch, shape).items()):
        if name == "dt":
            out[name] = torch.full(s.shape, 0.02, dtype=s.dtype, device=device)
        elif name == "guidance":
            out[name] = torch.full(s.shape, 4.0, dtype=s.dtype, device=device)
        elif name == "t":
            out[name] = torch.rand(s.shape, generator=gen, dtype=s.dtype, device=device) * 0.96 + 0.02
        elif s.dtype.is_floating_point:
            out[name] = torch.randn(s.shape, generator=gen, dtype=s.dtype, device=device)
        else:
            hi = arch.cfg.vocab if arch.family == "lm" else getattr(arch.cfg, "n_classes", 1000)
            out[name] = torch.randint(0, hi, s.shape, generator=gen, dtype=s.dtype, device=device)
    return out
