"""Carry weights across from the JAX reference.

``from_jax(arch, params, state)`` takes the reference's nested dicts of
numpy arrays (``jax.tree.map(np.asarray, ...)`` of its params/state) and
returns the port's trees: conv weights HWIO -> OIHW (stacked blocks
``[L, KH, KW, I, O]`` -> ``[L, O, I, KH, KW]``, kept stacked), matrices and
vectors unchanged, BatchNorm state carried over.  Structure and shapes are
checked against ``arch``'s own specs.  This module imports nothing of the
reference; it only reads arrays.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .arch import Arch, abstract_params
from .device import resolve_device


def _convert(name: str, a: np.ndarray, spec, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    elif a.ndim == 5:
        a = a.transpose(0, 4, 3, 1, 2)
    if tuple(a.shape) != spec.shape:
        raise ValueError(f"{name}: converted shape {a.shape} != expected {spec.shape}")
    return torch.tensor(np.ascontiguousarray(a), dtype=spec.dtype, device=device)


def _walk(name: str, tree: Any, specs: Any, device: torch.device) -> Any:
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{name or 'root'}: keys {got} != expected {sorted(specs)}")
        return {k: _walk(f"{name}/{k}", tree[k], specs[k], device) for k in specs}
    return _convert(name, tree, specs, device)


def from_jax(arch: Arch, params: Any, state: Any, *, device: torch.device | str = "cuda"):
    """(params, state) of the reference -> (params, state) of the port."""
    device = resolve_device(device)
    specs, state_specs = abstract_params(arch)
    return _walk("", params, specs, device), _walk("", state, state_specs, device)
