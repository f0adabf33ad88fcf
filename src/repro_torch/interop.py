"""Carry weights across from the JAX reference.

``from_jax(arch, params, state)`` takes the reference's nested dicts of
numpy arrays (``jax.tree.map(np.asarray, ...)`` of its params/state) and
returns the port's trees: conv weights (the leaves whose spec says
``init="conv"``) HWIO -> OIHW (stacked blocks ``[L, KH, KW, I, O]`` ->
``[L, O, I, KH, KW]``, kept stacked); every other leaf unchanged, whatever
its rank (ViT's stacked ``wq [L, d, H, hd]``, an LM's stacked ``blocks``
leaves such as the MoE experts' ``[L, E, d, f]``, its ``embed``); BatchNorm
state carried over.  Structure and shapes are checked against ``arch``'s own
specs (for an LM, ``lm.abstract_params``).  This module imports nothing of the
reference; it only reads arrays.

:func:`place` lays such a tree out on the mesh of a ``MeshRules`` over
ranks: each rank keeps its slice of every leaf as a DTensor, as
``launch/steps``' ``init_args`` lays out drawn weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .arch import Arch, abstract_params
from .device import resolve_device
from .models.common import tree_map


def _convert(name: str, a: np.ndarray, spec, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if spec.init == "conv":
        a = a.transpose(*range(a.ndim - 4), a.ndim - 1, a.ndim - 2, a.ndim - 4, a.ndim - 3)
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


def place(tree: Any, specs: Any, rules, *, device: torch.device | str = "cuda") -> Any:
    """A tree of arrays (numpy or tensors, of ``specs``' structure and
    shapes, each keeping its own dtype) on ``device``, every leaf laid out on
    the mesh of ``rules`` as its spec resolves (``MeshRules.place``): a
    DTensor of this rank's slice."""
    device = resolve_device(device)
    return tree_map(lambda s, a: rules.place(torch.as_tensor(a, device=device), s), specs, tree)
