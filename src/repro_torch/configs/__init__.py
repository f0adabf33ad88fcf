"""Architecture registry: ``get(name)`` resolves an arch by id — the ten
assigned architectures (four decoder LMs, two diffusion backbones, four
classifiers) and the paper's own compact model (squeezenet).

Each module exports CONFIG (the published config) and SMOKE (a reduced
same-family config for CPU tests and in-process calibration).
"""
from __future__ import annotations

import importlib

from ..arch import Arch

_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-0.6b": "qwen3_0_6b",
    "command-r-35b": "command_r_35b",
    "dit-xl2": "dit_xl2",
    "flux-dev": "flux_dev",
    "vit-s16": "vit_s16",
    "efficientnet-b7": "efficientnet_b7",
    "swin-b": "swin_b",
    "resnet-50": "resnet_50",
    "squeezenet": "squeezenet",
}

ASSIGNED = tuple(k for k in _MODULES if k != "squeezenet")
ALL = tuple(_MODULES)


def get(name: str, *, smoke: bool = False) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def cells() -> list[tuple[str, str]]:
    """All 40 assigned (arch, shape) cells: every shape of every assigned arch."""
    return [(name, s.name) for name in ASSIGNED for s in get(name).shapes]
