"""Model substrate foundations: parameter specs, materialization, and the
matmul backend hook.

A model family provides:
  abstract(cfg) -> (params specs, state specs)   nested dicts of ParamSpec
  forward(cfg, params, state, images, *, train)  plain function on tensors

Parameters are nested dicts of tensors, mirroring the reference's pytrees
key for key, so a weight has one obvious counterpart on each side
(``interop.from_jax`` converts layouts).  Convolution weights are stored
OIHW, PyTorch's layout; matrices are [K, N] and multiply as ``x @ w``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim (documentation)
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | conv
    scale: float | None = None  # override fan-in scaling

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def spec(shape: Iterable[int], axes: Iterable[str | None], **kw) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), **kw)


def _fan_in(shape: tuple[int, ...], init: str) -> float:
    if len(shape) == 1:
        return 1.0
    if init == "conv":  # [..., O, I, KH, KW]
        return float(math.prod(shape[-3:]))
    return float(shape[-2])


def init_param(gen: torch.Generator, s: ParamSpec, device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    scale = s.scale if s.scale is not None else 1.0 / math.sqrt(max(_fan_in(s.shape, s.init), 1.0))
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(device=device, dtype=s.dtype)


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leaf-wise over nested dicts (keys visited in sorted order,
    the order JAX flattens a dict pytree in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_tree(gen: torch.Generator, specs: Tree, *, device: torch.device | str = "cuda") -> Tree:
    """Materialize a spec tree; leaves draw from ``gen`` in sorted-key order."""
    device = torch.device(device)
    return tree_map(lambda s: init_param(gen, s, device), specs)


def param_count(specs: Tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


# ---------------------------------------------------------------------------
# Activation sharding hook.  The port runs on one card, so shard() is the
# identity; models keep the call sites so they read like the reference.
# ---------------------------------------------------------------------------


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# Matmul backend hook — the "NPU execution" seam.  Model families lower their
# GEMMs (classifier heads, and convolutions via im2col) through matmul(); an
# installed backend replaces the plain contraction — quant/npu_exec uses this
# to route every matmul of the int8 variant through the CUDA int8 kernel.
# Outside a backend context matmul() is exactly ``x @ w``, so training and the
# full-precision "edge" path are untouched.
# ---------------------------------------------------------------------------

_ACTIVE_MATMUL: list[Any] = []


class matmul_backend:
    """Context manager installing fn(x2d [M, K], w2d [K, N]) -> [M, N] for
    every matmul() call."""

    def __init__(self, fn: Any):
        self.fn = fn

    def __enter__(self):
        _ACTIVE_MATMUL.append(self.fn)
        return self.fn

    def __exit__(self, *exc):
        _ACTIVE_MATMUL.pop()


def current_matmul():
    return _ACTIVE_MATMUL[-1] if _ACTIVE_MATMUL else None


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, N] through the active backend (plain ``@`` if none).
    The backend's output is cast back to the activation dtype."""
    if not _ACTIVE_MATMUL:
        return x @ w
    fn = _ACTIVE_MATMUL[-1]
    lead = x.shape[:-1]
    out = fn(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)
