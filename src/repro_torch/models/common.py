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
import sys
import weakref
from typing import Any, Callable, Hashable, Iterable

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


def unstack(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``torch.unbind(t, 0)``: views of each entry of a stacked leaf.  A
    DTensor (replicated along its stack) unbinds its local tensor, and each
    view is a DTensor laid out as ``t`` without that dim, so an in-place
    write to one lands in ``t``."""
    if not is_dtensor(t):
        return torch.unbind(t, 0)
    from torch.distributed.tensor import Shard

    if any(p.is_shard(0) for p in t.placements):
        raise ValueError(f"unstack of a DTensor split along its stack: {t.placements}")
    placements = [Shard(p.dim - 1) if p.is_shard() else p for p in t.placements]
    return tuple(like(t, part, placements) for part in torch.unbind(t.to_local(), 0))


def unstack_tree(tree: Tree) -> list[Tree]:
    """Every layer of a stacked tree, from one ``torch.unbind`` a leaf.  Under
    autograd an unbind's backward stacks the layers' gradients once, where
    indexing a layer at a time would scatter each layer's into a zero-filled
    copy of the whole stack."""
    per_leaf = tree_map(unstack, tree)
    n = len(tree_leaves(per_leaf)[0])
    return [tree_map(lambda parts: parts[i], per_leaf) for i in range(n)]


def checkpointed(remat: bool, block: Callable) -> Callable:
    """``block``, checkpointed when ``remat`` and an autograd graph is being
    built (``torch.utils.checkpoint``, non-reentrant): only its inputs are
    kept, and it runs again in the backward pass, as under the reference's
    ``jax.checkpoint``.  Otherwise ``block`` itself.  The run in the
    backward pass has the mesh rules that were active in the forward
    (``activation_rules``), wherever the backward is called from."""
    if not (remat and torch.is_grad_enabled()):
        return block
    rules = current_rules()
    if rules is not None:
        def ruled(*args):
            with activation_rules(rules):
                return block(*args)

        return functools.partial(checkpoint, ruled, use_reentrant=False)
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
# Local shards.  A step over ranks (``launch/steps.build_cell`` with rules)
# takes DTensors; the layers compute on each rank's local shards and meet the
# other ranks only through ``sharding.rules``' collectives and ``shard``.  On
# a plain tensor these helpers are the identity (``local_slice``: the whole
# dim, split over no axis), so one code path serves one card and many ranks.
# ---------------------------------------------------------------------------


def is_dtensor(x: Any) -> bool:
    tensor_mod = sys.modules.get("torch.distributed.tensor")  # no DTensor exists before it is loaded
    return tensor_mod is not None and isinstance(x, tensor_mod.DTensor)


def local(x: Any) -> Any:
    """A DTensor's local tensor (the tensor itself, so in-place writes land
    in the DTensor); anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def mesh_of(x: Any) -> Any:
    """A DTensor's ``DeviceMesh``; ``None`` for a plain tensor."""
    return x.device_mesh if is_dtensor(x) else None


def local_slice(t: torch.Tensor, dim: int) -> tuple[slice, tuple[str, ...]]:
    """The part of dimension ``dim`` of ``t`` that this rank holds (a head,
    MLP, vocabulary, expert or cache-slot range), and the mesh axes that
    split it, outermost first (``()``: the whole dim)."""
    if not is_dtensor(t):
        return slice(0, t.shape[dim]), ()
    mesh = t.device_mesh
    coord, axes, index, n = mesh.get_coordinate(), [], 0, 1
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            index, n = index * mesh.size(i) + coord[i], n * mesh.size(i)
            axes.append(mesh.mesh_dim_names[i])
    size = t.shape[dim] // n
    return slice(index * size, (index + 1) * size), tuple(axes)


def on_mesh(y: torch.Tensor, mesh: Any, dims: dict[int, tuple[str, ...]]) -> torch.Tensor:
    """The local tensor ``y`` as a DTensor on ``mesh`` whose dim ``d`` is
    split over the mesh axes ``dims[d]`` (the rest replicated); ``y`` itself
    where ``mesh`` is None.  No collective."""
    if mesh is None:
        return y
    from torch.distributed.tensor import Replicate, Shard

    owner = {a: d for d, axes in dims.items() for a in axes}
    placements = [Shard(owner[a]) if a in owner else Replicate() for a in mesh.mesh_dim_names]
    return _from_local(y, mesh, placements)


def rows_like(ref: Any, y: torch.Tensor) -> torch.Tensor:
    """The local tensor ``y`` laid out on dim 0 (the batch) as DTensor
    ``ref``, its other dims whole; ``y`` itself where ``ref`` is plain."""
    return on_mesh(y, mesh_of(ref), {0: local_slice(ref, 0)[1]})


def like(ref: Any, y: torch.Tensor, placements=None) -> torch.Tensor:
    """The local tensor ``y`` laid out as DTensor ``ref`` (or with
    ``placements`` on its mesh); ``y`` itself where ``ref`` is plain."""
    if not is_dtensor(ref):
        return y
    return _from_local(y, ref.device_mesh, ref.placements if placements is None else placements)


def _from_local(y: torch.Tensor, mesh: Any, placements) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(y, mesh, placements, run_check=False)


def plus(x: Any, y: Any) -> Any:
    """``x + y`` of two tensors laid out alike, on their local tensors, laid
    out as ``x`` (a residual add with no DTensor op)."""
    return like(x, local(x) + local(y))


# ---------------------------------------------------------------------------
# Weights over ranks under autograd (a training step; ``sharding.rules``
# gives each collective its adjoint).  Under ``train_rules`` a leaf's
# ``embed`` dim splits over ``data`` (FSDP): ``used_on`` gathers it for use
# and reduce-scatters its gradient.  A tensor the ranks hold whole that is
# used on rows split over a mesh axis (a norm's scale on a residual split
# over its sequence) has a partial gradient on each rank: ``used_on`` sums
# it over those axes.  The batch axes are left out of that sum: the step
# sums every leaf's gradient over them once (``launch/steps``).
# ---------------------------------------------------------------------------

BATCH_AXES = ("pod", "data")


def split_axes(x: Any) -> tuple[str, ...]:
    """The mesh axes that split a dim of DTensor ``x``, the batch axes
    left out; ``()`` for a plain tensor."""
    if not is_dtensor(x):
        return ()
    names = x.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(x.placements) if p.is_shard() and names[i] not in BATCH_AXES)


def used_on(t: Any, on: Any = None) -> torch.Tensor:
    """The local tensor of ``t`` (a weight leaf, or an activation held whole
    over the non-batch axes) for use on the local rows of ``on``: its dims
    split over the batch axes gathered (their gradient reduce-scattered),
    and its gradient summed over the axes that split ``on`` but not ``t``.
    ``t`` itself on one card."""
    mesh = mesh_of(t) if is_dtensor(t) else mesh_of(on)
    if mesh is None:
        return t
    from ..sharding.rules import all_gather, grad_sum

    y, held = local(t), set()
    if is_dtensor(t):
        names = mesh.mesh_dim_names
        for d in sorted({p.dim for p in t.placements if p.is_shard()}):
            axes = tuple(names[i] for i, p in enumerate(t.placements) if p.is_shard(d))
            fsdp = tuple(a for a in axes if a in BATCH_AXES)
            if fsdp and fsdp != axes:
                raise ValueError(f"dim {d} of a leaf splits over {axes}: batch and other axes on one dim")
            if fsdp:
                y = all_gather(y, d, mesh, fsdp, scatter_grad=True)
            held.update(axes)
    if on is None or not (torch.is_grad_enabled() and y.requires_grad):
        return y
    return grad_sum(y, mesh, tuple(a for a in split_axes(on) if a not in held))


def weights(p: Tree, on: Any = None) -> Tree:
    """``used_on`` of every leaf of the tree ``p``."""
    return tree_map(lambda t: used_on(t, on), p)


def batch_mean(t: torch.Tensor, ref: Any) -> torch.Tensor:
    """The mean of every element of ``t``, this rank's rows of a batch laid
    out on dim 0 as DTensor ``ref``: over the whole batch (one sum over the
    batch's mesh axes); ``torch.mean(t)`` on one card."""
    rows = local_slice(ref, 0)[1]
    if not rows:
        return torch.mean(t)
    from ..sharding.rules import all_sum

    mesh = mesh_of(ref)
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in rows)
    return all_sum(torch.sum(t), mesh, rows) / (t.numel() * n)


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
    every matmul() call, ``w2d`` cast to the activation dtype.  Where
    ``weights`` is given, fn gets ``weights(w2d, dtype)`` in its place, with
    ``w2d`` as the model holds it (a view of its weight leaf), so that the
    backend can keep what it derives from a leaf across calls."""

    def __init__(self, fn: Any, weights: Any = None):
        self.fn, self.weights = fn, weights

    def __enter__(self):
        _ACTIVE_MATMUL.append((self.fn, self.weights))
        return self.fn

    def __exit__(self, *exc):
        _ACTIVE_MATMUL.pop()


def current_matmul():
    return _ACTIVE_MATMUL[-1][0] if _ACTIVE_MATMUL else None


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, N] through the active backend (plain ``@`` if none),
    ``w`` cast to the activation dtype.  The backend's output is cast back
    to the activation dtype."""
    if not _ACTIVE_MATMUL:
        return x @ w.to(x.dtype)
    fn, weights = _ACTIVE_MATMUL[-1]
    lead = x.shape[:-1]
    out = fn(x.reshape(-1, x.shape[-1]), w.to(x.dtype) if weights is None else weights(w, x.dtype))
    return out.reshape(*lead, w.shape[-1]).to(x.dtype)


# ---------------------------------------------------------------------------
# Tensors derived from leaves, kept across calls.  An inference forward
# derives the same tensors from its leaves at every call (a weight's cast,
# BatchNorm's scale, an NPU weight's int8 values); ``kept`` computes each at
# its first call and gives it back while the leaves it reads live and are
# not written, so a forward issues fewer operations from the host.
# ---------------------------------------------------------------------------

KEPT: dict[tuple, tuple[tuple[int, ...], Any]] = {}  # key -> (the roots' versions, fn's result)


def kept(tag: Hashable, fn: Callable[..., Any], *leaves: torch.Tensor) -> Any:
    """``fn(*leaves)``, computed once for these leaves and then kept.  A
    leaf is known by its root tensor (``t._base``, else ``t``) and its place
    in it; an entry holds the roots' version counters, so a write to a leaf
    (an in-place op; a ``.data`` swap is not seen) computes it anew, and it
    goes when a root is freed, before that memory can be reused.  ``tag``
    names ``fn`` and its constants.  Where a leaf takes part in autograd, is
    an inference tensor (no version counter) or lies on ``meta`` (no values;
    a traced step, as the dry run's, counts every operation), ``fn`` runs at
    every call.  What ``fn`` returns must hold no leaf, not even as a view,
    or the leaf would never be freed."""
    if any(t.is_meta or t.is_inference() or (t.requires_grad and torch.is_grad_enabled()) for t in leaves):
        return fn(*leaves)
    roots = tuple(t if t._base is None else t._base for t in leaves)
    key = (tag, *((id(r), t.dtype, t.storage_offset(), t.shape, t.stride()) for r, t in zip(roots, leaves)))
    versions = tuple(r._version for r in roots)
    entry = KEPT.get(key)
    if entry is not None and entry[0] == versions:
        return entry[1]
    got = fn(*leaves)
    if entry is None:
        for r in {id(r): r for r in roots}.values():
            weakref.finalize(r, KEPT.pop, key, None)
    KEPT[key] = (versions, got)
    return got


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``; a cast to another dtype is ``kept``."""
    return t if t.dtype == dtype else kept(("cast", dtype), lambda u: u.to(dtype), t)
