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
import functools
import math
from typing import Any, Callable, Iterable

import torch
from torch.utils.checkpoint import checkpoint

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim (documentation)
    dtype: torch.dtype = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed | conv
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
    if init == "embed":
        return 1.0
    return float(shape[-2])


# Elements of one f32 draw: a larger leaf (deepseek-moe's stacked experts,
# [28, 64, 2048, 1408] = 5.2e9) is drawn a run of leading-axis slices at a
# time, so its transient f32 copy stays at most 1 GiB.
DRAW_ELEMENTS = 1 << 28


def init_param(gen: torch.Generator, s: ParamSpec, device: torch.device) -> torch.Tensor:
    """Materialize one spec: fan-in scaled normals drawn in f32 on the
    generator's device, then cast to ``s.dtype`` on ``device``."""
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    scale = s.scale if s.scale is not None else 1.0 / math.sqrt(max(_fan_in(s.shape, s.init), 1.0))
    if math.prod(s.shape) <= DRAW_ELEMENTS:
        x = torch.randn(s.shape, generator=gen, dtype=torch.float32, device=gen.device)
        return (x * scale).to(device=device, dtype=s.dtype)
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    rows = max(1, DRAW_ELEMENTS // math.prod(s.shape[1:]))
    for i in range(0, s.shape[0], rows):
        x = torch.randn((min(rows, s.shape[0] - i), *s.shape[1:]), generator=gen, dtype=torch.float32,
                        device=gen.device)
        out[i:i + rows] = x.mul_(scale)
    return out


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


def stack_specs(specs: Tree, n: int) -> Tree:
    """Add a leading 'layers' dim of size ``n`` to every spec in the tree
    (repeated blocks stored stacked, as the reference scans over them)."""
    return tree_map(lambda s: dataclasses.replace(s, shape=(n, *s.shape), axes=("layers", *s.axes)), specs)


def unstack_tree(tree: Tree) -> list[Tree]:
    """Every layer of a stacked tree, from one ``torch.unbind`` a leaf.  Under
    autograd an unbind's backward stacks the layers' gradients once, where
    indexing a layer at a time would scatter each layer's into a zero-filled
    copy of the whole stack."""
    per_leaf = tree_map(lambda t: torch.unbind(t, 0), tree)
    n = len(tree_leaves(per_leaf)[0])
    return [tree_map(lambda parts: parts[i], per_leaf) for i in range(n)]


def checkpointed(remat: bool, block: Callable) -> Callable:
    """``block``, checkpointed when ``remat`` and an autograd graph is being
    built (``torch.utils.checkpoint``, non-reentrant): only its inputs are
    kept, and it runs again in the backward pass, as under the reference's
    ``jax.checkpoint``.  Otherwise ``block`` itself."""
    if not (remat and torch.is_grad_enabled()):
        return block
    return functools.partial(checkpoint, block, use_reentrant=False)


def init_tree(gen: torch.Generator, specs: Tree, *, device: torch.device | str = "cuda") -> Tree:
    """Materialize a spec tree; leaves draw from ``gen`` in sorted-key order."""
    device = torch.device(device)
    return tree_map(lambda s: init_param(gen, s, device), specs)


def abstract_tree(specs: Tree) -> Tree:
    """``meta``-device tensors of each spec's shape and dtype: a full config
    sized without allocating anything."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def param_count(specs: Tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def param_bytes(specs: Tree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for s in tree_leaves(specs))


# ---------------------------------------------------------------------------
# dtype policy (mixed precision)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast(self, tree: Tree) -> Tree:
        c = self.compute_dtype
        return tree_map(lambda x: x.to(c) if x.is_floating_point() else x, tree)


TRAIN_POLICY = Policy()
SERVE_POLICY = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, output_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Activation sharding helper — models call shard(x, "batch", "seq", "embed")
# and the active MeshRules resolves it (``MeshRules.constrain``: a DTensor is
# redistributed to the resolved placements).  Outside a rules context it is
# the identity, so single-card runs never see a mesh.
# ---------------------------------------------------------------------------

_ACTIVE_RULES: list[Any] = []


class activation_rules:
    """Context manager installing a MeshRules for shard() calls."""

    def __init__(self, rules: Any):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    if not _ACTIVE_RULES:
        return x
    return _ACTIVE_RULES[-1].constrain(x, axes)


def current_rules():
    return _ACTIVE_RULES[-1] if _ACTIVE_RULES else None


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
