"""Build step programs per (arch x shape) cell.

``build_cell(arch, shape_name, adamw=None, accum_steps=1)`` returns a
CellProgram with:
  fn          the step callable (train_step / prefill / decode /
              denoise_step / classify_serve)
  arg_specs   ParamSpec trees of its arguments (``common.abstract_tree``
              sizes them without allocating)
  donate      argument indices the step updates in place (the train state,
              the KV cache)

``prog.init_args(seed, device="cuda")`` materializes the arguments and
``prog(*args)`` runs the step.  Serving parameters are drawn directly in
bf16 from the cast specs, a leaf at a time: no full f32 tree is ever made
(command-r's would be 130 GB).

A training cell (``train``, ``denoise_train``, ``classify_train``) takes
``(ts, batch)``, with ``ts = {"params" f32, "state", "opt": {"m", "v" f32,
"step" int32}}`` (16 bytes a parameter), and returns ``(ts, metrics)``:
the loss's gradient by ``torch.autograd.grad`` over the parameter leaves,
then one AdamW update (``train/optim``) written into ``ts`` in place.  With
``accum_steps`` > 1 the batch's leading dimension splits into that many
microbatches, run in order with BatchNorm state carried through them, and
their f32 gradients are summed and divided once.  ``meta["loss_fn"]`` is the
kind's ``loss_fn(params, state, batch) -> (loss, (metrics, new_state))``;
``value_and_grad`` gives its loss and gradients without an update.

A ``denoise_step`` cell runs one sampler step of DiT (DDIM, cosine
schedule) or Flux (rectified-flow Euler) on ``{"x", "t", "dt", ...}``.

With ``rules`` (a ``MeshRules`` over a mesh of ``torch.distributed`` ranks)
every kind runs on every rank under ``activation_rules``, as the
reference's ``_with_rules``: ``prog.shardings()`` gives each argument
leaf's spec, ``prog.init_args`` each rank's slices as DTensors (a leaf
drawn whole, its slice kept), and a serving step returns DTensors (logits
on ``vocab``, the cache on its ``kv_seq_axis``, next latents on the batch).
A training step over ranks differentiates through ``sharding.rules``'
collectives (each with its adjoint; FSDP leaves gathered for use and their
gradients reduce-scattered), sums every other leaf's gradient over the
batch's mesh axes once, and updates each rank's shards of the train state
in place, so the state keeps the layout ``prog.shardings()`` gives it.
With ``accum_steps`` > 1 microbatch ``i`` is rows ``[i·B/a, (i+1)·B/a)`` of
the global batch laid out again over the batch's axes, as the reference
cuts it.  The batch must split evenly over those axes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import arch as A
from ..device import resolve_device
from ..models import diffusion, layers, lm
from ..models.common import (ParamSpec, abstract_tree, activation_rules, batch_mean, init_param, init_tree, like,
                             local, local_slice, mesh_of, spec, tree_leaves, tree_map)
from ..sharding.rules import MeshRules, all_gather, all_sum, batch_axes
from ..train import optim


@dataclasses.dataclass
class CellProgram:
    name: str
    kind: str
    fn: Callable
    arg_specs: tuple  # ParamSpec trees
    donate: tuple[int, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)
    rules: MeshRules | None = None

    def shardings(self):
        """Each argument leaf's resolved spec (the reference's
        ``in_shardings``); None without rules."""
        if self.rules is None:
            return None
        return tuple(self.rules.tree_shardings(s) for s in self.arg_specs)

    def init_arg(self, i: int, seed: int = 0, device: torch.device | str = "cuda"):
        """Argument ``i``, drawn on ``device`` from seed ``seed + 7919 * i``
        (the reference folds ``i`` into its key), so each argument can be made
        alone and equals its entry in ``init_args``.  On ``meta``: shapes, no
        values.  Under the cell's ``rules`` each rank draws a leaf
        whole, keeps its slice as a DTensor and frees the rest before the
        next leaf (empty and ones leaves are made as slices): the values are
        the unsharded ones.  On ``meta`` under rules over a process group,
        each leaf is a ``meta`` DTensor of this rank's slice (a dry run's
        rank)."""
        device = resolve_device(device)
        specs, rules = self.arg_specs[i], self.rules
        meta = device.type == "meta"
        gen = None if meta else torch.Generator(device=device).manual_seed(seed + 7919 * i)
        if rules is None or rules.mesh.device_mesh is None:
            return abstract_tree(specs) if meta else init_tree(gen, specs, device=device)

        def leaf(s: ParamSpec):
            if s.init in ("zeros", "ones"):
                return rules.constant(s, device)
            whole = torch.empty(s.shape, dtype=s.dtype, device=device) if meta else init_param(gen, s, device)
            return rules.place(whole, s)

        return tree_map(leaf, specs)

    def init_args(self, seed: int = 0, device: torch.device | str = "cuda") -> tuple:
        return tuple(self.init_arg(i, seed, device) for i in range(len(self.arg_specs)))

    def __call__(self, *args):
        return self.fn(*args)


def _cast_specs(specs, dtype: torch.dtype):
    def cast(s: ParamSpec):
        return dataclasses.replace(s, dtype=dtype) if s.dtype.is_floating_point else s

    return tree_map(cast, specs)


def _shape_cfg(arch: A.Arch, shape: A.ShapeSpec) -> A.Arch:
    """Per-shape config overrides (long-context KV axis, 384px windows...)."""
    cfg = arch.cfg
    if arch.family == "lm" and shape.name.startswith("long_"):
        cfg = dataclasses.replace(cfg, kv_seq_axis="long_kv_seq")
    if arch.family == "lm" and shape.kind == "train":
        cfg = dataclasses.replace(cfg, seq_shard_acts=True)
    if arch.family == "vit" and shape.img and shape.img != cfg.img_res:
        cfg = dataclasses.replace(cfg, img_res=shape.img)
    if arch.family == "swin" and shape.img and shape.img != cfg.img_res:
        window = 12 if shape.img % (cfg.patch * 12 * 8) == 0 else cfg.window
        cfg = dataclasses.replace(cfg, img_res=shape.img, window=window)
    return dataclasses.replace(arch, cfg=cfg)


def _with_rules(rules: MeshRules | None, fn: Callable) -> Callable:
    """``fn`` run under ``activation_rules(rules)``; ``fn`` itself without."""
    if rules is None:
        return fn

    def wrapped(*args):
        with activation_rules(rules):
            return fn(*args)

    return wrapped


def _loss_fn(arch: A.Arch, kind: str) -> Callable:
    """``loss_fn(params, state, batch) -> (loss, (metrics, new_state))`` of a
    training kind."""
    cfg = arch.cfg
    if kind == "train":

        def loss_fn(params, state, batch):
            loss, metrics = lm.train_loss(cfg, params, batch["tokens"], batch["labels"])
            return loss, (metrics, state)

    elif kind == "denoise_train" and arch.family == "dit":

        def loss_fn(params, state, batch):
            loss, m = diffusion.dit_train_loss(cfg, params, batch["x"], batch["t"], batch["y"], batch["noise"])
            return loss, (m, state)

    elif kind == "denoise_train":

        def loss_fn(params, state, batch):
            loss, m = diffusion.flux_train_loss(cfg, params, batch["x"], batch["txt"], batch["vec"], batch["t"],
                                                batch["noise"])
            return loss, (m, state)

    else:  # classify_train

        def loss_fn(params, state, batch):
            logits, new_state = A.classifier_forward(arch, params, state, batch["images"], train=True)
            loss = batch_mean(layers.token_nll(logits, batch["labels"]), logits)
            return loss, ({"ce": loss}, new_state)

    return loss_fn


def _local_grads(loss_fn, params, state, batch):
    """``value_and_grad`` before the gradients' sum over the batch's mesh
    axes."""
    alias = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, (metrics, new_state) = loss_fn(alias, state, batch)
        grads = torch.autograd.grad(loss, tree_leaves(alias), allow_unused=True, materialize_grads=True)
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return (loss.detach(), (tree_map(detach, metrics), tree_map(detach, new_state))), list(grads)


def _batch_summed(grads: list, params, batch) -> list:
    """Over ranks, each gradient summed over the mesh axes that split the
    batch and not its leaf (a leaf split over them, FSDP, had its gradient
    reduce-scattered in the backward pass); the gradients as they are on
    one card."""
    rows = local_slice(next(iter(batch.values())), 0)[1]
    if not rows:
        return grads
    mesh = mesh_of(next(iter(batch.values())))
    names = mesh.mesh_dim_names
    out = []
    for p, g in zip(tree_leaves(params), grads):
        held = {names[i] for i, q in enumerate(p.placements) if q.is_shard()}
        out.append(like(p, all_sum(local(g), mesh, tuple(a for a in rows if a not in held))))
    return out


def value_and_grad(loss_fn, params, state, batch):
    """(loss, (metrics, new_state)), f32 gradients of ``loss_fn`` at
    ``params``: differentiated through aliases of the parameters (autograd
    leaves sharing their storage), so the train state never carries
    ``requires_grad``.  A parameter the loss does not use gets zeros, as
    ``jax.grad`` gives.  Over ranks (DTensor arguments) each gradient is
    laid out as its leaf and is the whole batch's."""
    (loss, aux), grads = _local_grads(loss_fn, params, state, batch)
    return (loss, aux), _batch_summed(grads, params, batch)


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` cut into ``n`` microbatches of consecutive rows of the
    global batch; over ranks each laid out on the batch's mesh axes as
    ``batch`` is (its leaves gathered whole first)."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in batch.items():
        held, rows = local_slice(v, 0)
        whole = all_gather(local(v), 0, mesh_of(v), rows) if rows else v
        parts, index = v.shape[0] // (held.stop - held.start), held.start // (held.stop - held.start)
        for i, part in enumerate(whole.reshape(n, whole.shape[0] // n, *whole.shape[1:])):
            out[i][k] = like(v, part.chunk(parts, 0)[index]) if rows else part
    return out


def _train_step(loss_fn, adamw: optim.AdamWConfig, accum_steps: int) -> Callable:
    def train_step(ts, batch):
        params = ts["params"]
        if accum_steps == 1:
            (loss, (metrics, new_state)), grads = _local_grads(loss_fn, params, ts["state"], batch)
        else:
            # Microbatch over the leading (batch) dim; grads summed in f32, averaged once.
            new_state, loss, grads = ts["state"], None, None
            for mb in _microbatches(batch, accum_steps):
                (mb_loss, (_, new_state)), g = _local_grads(loss_fn, params, new_state, mb)
                if grads is None:
                    loss, grads = mb_loss, g
                else:
                    loss = loss + mb_loss
                    for a, b in zip(grads, g):
                        local(a).add_(local(b))
            for g in grads:
                local(g).div_(accum_steps)
            loss = loss / accum_steps
            metrics = {}
        it = iter(_batch_summed(grads, params, batch))
        om = optim.adamw_update(adamw, params, tree_map(lambda _: next(it), params), ts["opt"])
        ts["state"] = new_state
        return ts, {"loss": loss, **metrics, **om}

    return train_step


def build_cell(arch: A.Arch, shape_name: str, rules=None, adamw: optim.AdamWConfig | None = None,
               accum_steps: int = 1) -> CellProgram:
    """The step program of ``arch`` at its shape ``shape_name``.  For a
    training kind, ``adamw`` (default ``AdamWConfig()``) and ``accum_steps``
    (> 1 splits the global batch into microbatches and accumulates their
    gradients before one update: the elastic-restart lever that keeps the
    global batch when the data axis shrinks)."""
    shape = arch.shape(shape_name)
    arch = _shape_cfg(arch, shape)
    cfg = arch.cfg
    param_specs, state_specs = A.abstract_params(arch)
    in_specs = A.input_specs(arch, shape)
    name = f"{arch.name}/{shape.name}"
    meta = {"arch": arch, "shape": shape}

    if shape.kind in ("train", "denoise_train", "classify_train"):
        if shape.batch % accum_steps:
            raise ValueError(f"{name}: batch {shape.batch} does not split into {accum_steps} microbatches")
        if rules is not None:
            want = {a for a in batch_axes(rules.mesh) if rules.mesh.shape[a] > 1}
            got = (rules.logical((shape.batch // accum_steps,), ("batch",)) or (None,))[0]
            if want != set((got,) if isinstance(got, str) else got or ()):
                raise ValueError(f"{name}: a microbatch of {shape.batch // accum_steps} rows does not split "
                                 f"evenly over the batch axes {sorted(want)} of {rules.mesh.shape}")
        zeros = lambda s: ParamSpec(s.shape, s.axes, torch.float32, "zeros")  # noqa: E731
        ts_specs = {
            "params": param_specs,
            "state": state_specs,
            "opt": {"m": tree_map(zeros, param_specs), "v": tree_map(zeros, param_specs),
                    "step": spec((), (), dtype=torch.int32, init="zeros")},
        }
        loss_fn = _loss_fn(arch, shape.kind)
        step = _train_step(loss_fn, adamw or optim.AdamWConfig(), accum_steps)
        return CellProgram(name, shape.kind, _with_rules(rules, step), (ts_specs, in_specs), donate=(0,),
                           meta={**meta, "loss_fn": _with_rules(rules, loss_fn)}, rules=rules)

    serve_params = _cast_specs(param_specs, torch.bfloat16)

    if shape.kind == "prefill":

        def prefill_fn(params, batch):
            return lm.prefill(cfg, params, batch["tokens"])

        return CellProgram(name, shape.kind, _with_rules(rules, prefill_fn), (serve_params, in_specs), meta=meta,
                           rules=rules)

    if shape.kind == "decode":
        cache = lm.cache_specs(cfg, shape.batch, shape.seq)

        def decode_fn(params, cache, batch):
            return lm.decode_step(cfg, params, batch["token"], cache)

        return CellProgram(name, shape.kind, _with_rules(rules, decode_fn), (serve_params, cache, in_specs),
                           donate=(1,), meta=meta, rules=rules)

    if shape.kind == "denoise_step":
        if arch.family == "dit":

            def step_fn(params, batch):
                return diffusion.dit_sample_step(cfg, params, batch["x"], batch["t"], batch["dt"], batch["y"])

        else:

            def step_fn(params, batch):
                return diffusion.flux_sample_step(cfg, params, batch["x"], batch["txt"], batch["vec"], batch["t"],
                                                  batch["dt"], batch["guidance"])

        return CellProgram(name, shape.kind, _with_rules(rules, step_fn), (serve_params, in_specs), meta=meta,
                           rules=rules)

    if shape.kind == "classify_serve":
        serve_state = _cast_specs(state_specs, torch.float32)

        def serve_fn(params, state, batch):
            with torch.no_grad():
                return A.classifier_forward(arch, params, state, batch["images"], train=False)[0]

        return CellProgram(name, shape.kind, _with_rules(rules, serve_fn), (serve_params, serve_state, in_specs),
                           meta=meta, rules=rules)

    raise ValueError(f"unhandled kind {shape.kind}")
