"""Roofline analysis of a step traced on the ``meta`` device: the port's
counterpart of the reference's ``launch/analysis``.

The reference lowers a step over 512 fake devices and walks its jaxpr.  The
port runs the step's own code on ``meta`` tensors (shapes and dtypes, no
values, nothing allocated) under a counting ``TorchDispatchMode``, and walks
the aten ops as they are dispatched.  The forward, autograd's backward and
``torch.utils.checkpoint``'s recompute are all dispatched, so each is
counted where it runs, as the reference counts remat bodies as written.

Counting rules, the reference's (``jaxpr_costs``) op for op:

* a matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``_int_mm``, ...)
  counts 2·batch·m·n·k;
* a convolution counts 2·(output positions)·(kernel elements), and
  ``convolution_backward`` the same for each gradient it computes, the
  weight's over the output gradient's positions and the input's over the
  positions of the convolution's input before its explicit SAME padding.
  That last is the reference's rule for a strided convolution's input
  gradient: XLA writes it as a convolution whose output is the input, so it
  counts stride² the forward's FLOPs (ROADMAP §3);
* the ops the reference's ``_ELEMENTWISE_FREE`` names (views, reshapes,
  permutes, casts, slices, cat, pad, flip, copies, constant fills) count 0
  FLOPs;
* every other op counts one FLOP an output element;
* every op that writes counts its outputs' bytes (a write-once model), and
  a trace adds its top-level inputs' bytes.  A view (``view``, ``permute``,
  ``expand``, ``select``, ``detach``, ...) aliases its input and writes
  nothing, so it counts nothing: torch's ``einsum`` alone puts several
  around each product, full-size views of a KV cache among them, where a
  jaxpr has one ``dot_general``.  A host tensor copied to the traced
  device (a constant table such as the sincos position embedding, which
  the model makes once and caches) counts nothing either, as a jaxpr's
  constants count nothing.

Memory is the counterpart of ``compiled.memory_analysis()``: the peak of
live bytes over the trace, arguments, outputs and the temporaries alive at
once, each storage counted once while a tensor holds it.

A rank's trace (one rank of a fake process group, ``launch/dryrun``) counts
that device's work: a DTensor is counted by its local tensor, and an op on
DTensors is left to DTensor (the counter declines it), which runs it as
local ops and ``_c10d_functional`` collectives that the counter then sees,
so nothing is counted twice or at the global shape.  Collectives are the
``_c10d_functional`` ops and the plain ``c10d`` ops that
``torch.distributed``'s calls issue (``sharding.rules``' sums and
gathers), by the reference's kinds, each at 0 FLOPs and its result's bytes
on this device (an all-gather's gathered output, an all-reduce's buffer, a
reduce-scatter's part), priced with the reference's ring factors; a step
on one card issues none.  Their sites, as ``sites`` keeps the others', give
``top_collectives``.

Roofline terms, with the spec-sheet peaks of one NVIDIA H100 80GB HBM3 (SXM)
at its 700 W limit:
  compute_s    = flops / chips / PEAK_FLOPS      (dense bf16)
  memory_s     = bytes / chips / HBM_BW
  collective_s = sum over kinds of bytes * factor / LINK_BW

Not ported: the reference's HLO-text parsers (``parse_collectives``,
``top_collective_sites`` and their helpers), since the port makes no HLO and
counts its collectives as ops; and ``analytic_memory_gb``'s 0.4 / 0.6
factors, which correct XLA-CPU inflation for a TPU estimate (the port quotes
no TPU figure).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from ..models.common import is_dtensor

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s, the card above
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s per direction, NVLink 4
HBM_BYTES = 80e9  # device memory: what "fits" is held to

_MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_int_mm", "mv", "addmv", "dot", "vdot"}
_CONVS = {"convolution", "convolution_backward"}
# The reference's _ELEMENTWISE_FREE that are not views (a view counts
# nothing at all): casts, copies, concatenation, padding, reversal, and
# constant fills (broadcasts of a literal in a jaxpr).
_ELEMENTWISE_FREE = {
    "_to_copy", "clone", "copy", "copy_", "cat", "stack", "constant_pad_nd", "flip", "roll",
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_empty", "new_empty_strided", "new_zeros", "new_ones", "new_full", "fill", "fill_", "zero_",
    "scalar_tensor",
}
# _c10d_functional op -> the reference's collective kind (the result is the
# op's output); ring-algorithm data volume factors (x result bytes), per device.
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# c10d op (what dist.all_reduce, dist.all_gather, ... issue) -> its kind; the
# result is the op's first argument, written in place.
_C10D_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter", "alltoall_base_": "all-to-all",
}
_OP_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0  # write-once model: op outputs + top-level inputs

    def __iadd__(self, o: "Costs"):
        self.flops += o.flops
        self.bytes += o.bytes
        return self

    def scaled(self, k: float) -> "Costs":
        return Costs(self.flops * k, self.bytes * k)


@dataclasses.dataclass
class Trace:
    """What one traced call counted."""

    costs: Costs  # every op, top-level inputs' bytes included
    dot_flops: float  # the matmuls' and convolutions' share of costs.flops
    sites: dict  # (aten op, output shape) -> [bytes, flops, count]
    argument_bytes: int  # distinct storages of the arguments
    output_bytes: int  # distinct storages of the outputs that are not arguments'
    alias_bytes: int  # distinct storages of the outputs that are arguments' (updated in place)
    peak_bytes: int  # live bytes at their highest, arguments included
    collectives: dict  # as the reference's parse_collectives: by_kind, total_bytes, est_seconds, op_sites
    collective_sites: dict  # (kind, result dtype, result shape) -> [bytes, count]
    seconds: float  # wall time of the traced call


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree of tuples, lists and dicts, a DTensor as its
    local tensor (what this device holds)."""
    if isinstance(tree, torch.Tensor):
        return [tree._local_tensor if is_dtensor(tree) else tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _bytes_of(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _positions(t_or_shape) -> float:
    """Elements of one channel: N·H·W of an NCHW activation."""
    shape = tuple(t_or_shape.shape if isinstance(t_or_shape, torch.Tensor) else t_or_shape)
    return math.prod(shape) / shape[1]


def _matmul_flops(name: str, args) -> float:
    if name in ("mm", "_int_mm"):
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name in ("baddbmm", "addbmm"):
        a, b = args[1], args[2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2.0 * args[0].numel()
    if name == "addmv":
        return 2.0 * args[1].numel()
    return 2.0 * args[0].numel()  # dot, vdot


@functools.cache
def _rule(func) -> tuple[str, str, str]:
    """(kind, name, site name) of an op.  Kinds: "view" (aliases an input
    and writes nothing; so do ``wait_tensor`` and ``_wrap_tensor_autograd``,
    which hand back a collective's result),
    "collective" (a ``_c10d_functional`` op: its output is the result),
    "c10d" (a ``c10d`` collective: its first argument is the result),
    "functional" (returns fresh tensors and writes none of its arguments),
    "other" (writes in place)."""
    packet = func.overloadpacket
    name, schema, qualified = packet.__name__, func._schema, packet._qualified_op_name
    if func.is_view or name in ("_unsafe_view", "wait_tensor", "_wrap_tensor_autograd"):
        kind = "view"
    elif qualified.startswith("_c10d_functional::") and name in _COLLECTIVE_KIND:
        kind = "collective"
    elif qualified.startswith("c10d::") and name in _C10D_KIND:
        kind = "c10d"
    elif schema.is_mutable or any(r.alias_info is not None for r in schema.returns):
        kind = "other"
    else:
        kind = "functional"
    return kind, name, str(packet)


def _meta_key(a):
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_meta_key(x) for x in a)
    return (type(a), a)


class _Meta(tuple):
    """(shape, stride, dtype) of a tensor output in a template."""


def _template(out):
    if isinstance(out, torch.Tensor):
        return _Meta((out.shape, out.stride(), out.dtype))
    if isinstance(out, (tuple, list)):
        return type(out)([_template(x) for x in out])
    return out


def _rebuild(template):
    if isinstance(template, _Meta):
        return torch.empty_strided(template[0], template[1], dtype=template[2], device="meta")
    if isinstance(template, (tuple, list)):
        return type(template)([_rebuild(x) for x in template])
    return template


def _fresh(t: torch.Tensor) -> bool:
    """A dense tensor of its own, as ``empty_strided`` would make it."""
    return t.storage_offset() == 0 and t.untyped_storage().nbytes() == (
        torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta").untyped_storage().nbytes())


class CostCounter(TorchDispatchMode):
    """Counts every aten op dispatched while it is active (the rules in the
    module docstring) and tracks live bytes by storage."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.dot_flops = 0.0
        self.sites: dict = {}
        self.collectives: dict[str, float] = {}
        self.collective_sites: dict = {}  # (kind, result dtype, result shape) -> [bytes, count]
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()  # storage -> bytes, while it lives
        self._unpadded = WeakIdKeyDictionary()  # padded storage -> shape before the pad
        self._outputs: dict = {}  # (op, argument metadata) -> its outputs' (tree, shapes, strides, dtypes)

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed (once per storage)."""
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def _conv_flops(self, name: str, args, out) -> float:
        if name == "convolution":
            return 2.0 * _positions(out) * args[1].numel()
        grad_out, inp, weight, mask = args[0], args[1], args[2], args[10]
        flops = 0.0
        if mask[0]:
            flops += 2.0 * _positions(self._unpadded.get(inp.untyped_storage(), inp.shape)) * weight.numel()
        if mask[1]:
            flops += 2.0 * _positions(grad_out) * weight.numel()
        if mask[2]:
            flops += float(out[2].numel())
        return flops

    def _cached(self, func, args, kwargs):
        """``func(*args, **kwargs)`` of a functional op on ``meta``: seen before
        at the same argument metadata, fresh outputs of the shapes and
        strides it gave then.  A meta kernel computes shapes in Python, and
        ``blockwise_sdpa``'s loops repeat a few shapes thousands of times."""
        key = (func, _meta_key(args), _meta_key(tuple(kwargs.items())))
        template = self._outputs.get(key)
        if template is None:
            out = func(*args, **kwargs)
            if all(_fresh(t) for t in _tensors(out)):
                self._outputs[key] = _template(out)
            return out
        return _rebuild(template)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)  # DTensor working out a result's layout: no work on the device
        if any(t is not torch.Tensor and t is not torch.nn.Parameter for t in types):
            # A DTensor (or a collective's async result) runs it as plain ops
            # and collectives, counted as they come.
            return NotImplemented
        kind, name, site = _rule(func)
        kwargs = kwargs or {}
        if kind == "view":  # aliases its input: writes nothing
            return func(*args, **kwargs)
        if kind in ("collective", "c10d"):
            return self._collective(func, args, kwargs, kind, name)
        inputs = _tensors((args, kwargs))
        if kind == "functional" and all(t.device.type == "meta" for t in inputs):
            out = self._cached(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if outs and any(t.device != outs[0].device for t in inputs):
            return out  # a host constant copied over: a jaxpr's constants count nothing
        out_bytes = sum(_bytes_of(t) for t in outs)
        dot = 0.0
        if name in _MATMULS:
            dot = flops = _matmul_flops(name, args)
        elif name in _CONVS:
            dot = flops = self._conv_flops(name, args, out)
        elif name in _ELEMENTWISE_FREE:
            flops = 0.0
            if name == "constant_pad_nd":
                self._unpadded[outs[0].untyped_storage()] = tuple(args[0].shape)
        else:
            flops = float(sum(t.numel() for t in outs))
        self.costs.flops += flops
        self.costs.bytes += out_bytes
        self.dot_flops += dot
        rec = self.sites.setdefault((site, tuple(outs[0].shape) if outs else ()), [0.0, 0.0, 0])
        rec[0] += out_bytes
        rec[1] += dot
        rec[2] += 1
        for t in outs:
            self.hold(t)
        return out

    def _collective(self, func, args, kwargs, kind: str, name: str):
        """A collective: 0 FLOPs, its result's bytes on this device, by the
        reference's kind and at its site; a fresh output is live bytes."""
        out = func(*args, **kwargs)
        result = _tensors(out) if kind == "collective" else _tensors(args[0])
        n = sum(_bytes_of(t) for t in result)
        coll = (_COLLECTIVE_KIND if kind == "collective" else _C10D_KIND)[name]
        self.collectives[coll] = self.collectives.get(coll, 0.0) + n
        self.costs.bytes += n
        site = (coll, str(result[0].dtype).removeprefix("torch."), tuple(result[0].shape))
        rec = self.collective_sites.setdefault(site, [0.0, 0])
        rec[0] += n
        rec[1] += 1
        for t in result:
            self.hold(t)
        return out

    def collective_summary(self) -> dict[str, Any]:
        seconds = sum(_OP_FACTOR[kind] * b / LINK_BW for kind, b in self.collectives.items())
        return {"by_kind": dict(self.collectives), "total_bytes": sum(self.collectives.values()),
                "est_seconds": seconds, "op_sites": sum(c for _, c in self.collective_sites.values())}


def trace(fn, *args) -> Trace:
    """Run ``fn(*args)`` once under a ``CostCounter``; ``args`` are trees of
    tensors, on ``meta`` for a step sized without running it."""
    counter = CostCounter()
    arg_tensors = _tensors(args)
    for t in arg_tensors:
        counter.hold(t)
    argument_bytes = counter.live
    arg_storages = WeakIdKeyDictionary({t.untyped_storage(): True for t in arg_tensors})
    t0 = time.perf_counter()
    with counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    new, alias = {}, {}
    for st in (t.untyped_storage() for t in _tensors(out)):
        (alias if st in arg_storages else new)[id(st)] = st.nbytes()
    costs = Costs(counter.costs.flops, counter.costs.bytes + sum(_bytes_of(t) for t in arg_tensors))
    return Trace(costs, counter.dot_flops, counter.sites, argument_bytes, sum(new.values()), sum(alias.values()),
                 counter.peak, counter.collective_summary(), counter.collective_sites, seconds)


def traced_costs(fn, *args) -> Costs:
    return trace(fn, *args).costs


def site_rows(sites: dict, k: int = 15) -> list[dict]:
    """The ``k`` (aten op, output shape) sites with the most bytes."""
    rows = [{"prim": name, "shape": list(shape), "bytes": b, "flops": f, "count": c}
            for (name, shape), (b, f, c) in sites.items()]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:k]


def collective_rows(sites: dict, k: int = 12) -> list[dict]:
    """The ``k`` collective sites (kind, result dtype and shape) with the
    most bytes, as the reference's ``top_collective_sites`` rows: ``type``
    the result's, ``trips`` the times it was issued."""
    rows = [{"kind": kind, "type": f"{dtype}{list(shape)}", "bytes": b, "trips": c}
            for (kind, dtype, shape), (b, c) in sites.items()]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:k]


def top_cost_sites(fn, *args, k: int = 15) -> list[dict]:
    """Attribute the write-once bytes / flops to (aten op, shape) sites."""
    return site_rows(trace(fn, *args).sites, k)


# ---------------------------------------------------------------------------
# Roofline assembly
# ---------------------------------------------------------------------------


def roofline(flops: float, bytes_: float, collective: dict, chips: int) -> dict[str, Any]:
    compute_s = flops / chips / PEAK_FLOPS
    memory_s = bytes_ / chips / HBM_BW
    collective_s = collective["est_seconds"]  # already per-device
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    return {
        **terms,
        "bottleneck": bottleneck,
        "step_s_lower_bound": step_s,
        "roofline_fraction": compute_s / step_s if step_s > 0 else 0.0,
    }


def model_flops(kind: str, n_params: int, n_active: int, tokens: float) -> float:
    """MODEL_FLOPS: 6*N*D train, 2*N*D forward-only."""
    n = n_active or n_params
    return (6.0 if "train" in kind else 2.0) * n * tokens
