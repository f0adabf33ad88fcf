"""Architecture registry: ``get(name)`` resolves a classifier by id.

Each module exports CONFIG (the published config) and SMOKE (a reduced
same-family config for CPU tests and in-process calibration).
"""
from __future__ import annotations

import importlib

from ..arch import Arch

_MODULES = {
    "resnet-50": "resnet_50",
    "squeezenet": "squeezenet",
}

ALL = tuple(_MODULES)


def get(name: str, *, smoke: bool = False) -> Arch:
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG
