"""Architecture registry: ``get(name)`` resolves an arch by id — the five
classifiers and the four decoder LMs.

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
    "resnet-50": "resnet_50",
    "squeezenet": "squeezenet",
    "vit-s16": "vit_s16",
    "efficientnet-b7": "efficientnet_b7",
    "swin-b": "swin_b",
}

ALL = tuple(_MODULES)


def get(name: str, *, smoke: bool = False) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
