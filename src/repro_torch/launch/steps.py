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
Mesh rules wait for the multi-device path (ROADMAP item 8) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from .. import arch as A
from ..device import resolve_device
from ..models import diffusion, lm
from ..models.common import ParamSpec, abstract_tree, init_tree, spec, tree_leaves, tree_map
from ..train import optim


@dataclasses.dataclass
class CellProgram:
    name: str
    kind: str
    fn: Callable
    arg_specs: tuple  # ParamSpec trees
    donate: tuple[int, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)

    def init_arg(self, i: int, seed: int = 0, device: torch.device | str = "cuda"):
        """Argument ``i``, drawn on ``device`` from seed ``seed + 7919 * i``
        (the reference folds ``i`` into its key), so each argument can be made
        alone and equals its entry in ``init_args``.  On ``meta``: shapes, no
        values."""
        device = resolve_device(device)
        if device.type == "meta":
            return abstract_tree(self.arg_specs[i])
        gen = torch.Generator(device=device).manual_seed(seed + 7919 * i)
        return init_tree(gen, self.arg_specs[i], device=device)

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
            logp = F.log_softmax(logits.to(torch.float32), dim=-1)
            gold = torch.gather(logp, -1, batch["labels"].to(torch.int64)[:, None])
            loss = -torch.mean(gold)
            return loss, ({"ce": loss}, new_state)

    return loss_fn


def value_and_grad(loss_fn, params, state, batch):
    """(loss, (metrics, new_state)), f32 gradients of ``loss_fn`` at
    ``params``: differentiated through aliases of the parameters (autograd
    leaves sharing their storage), so the train state never carries
    ``requires_grad``.  A parameter the loss does not use gets zeros, as
    ``jax.grad`` gives."""
    alias = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, (metrics, new_state) = loss_fn(alias, state, batch)
        grads = torch.autograd.grad(loss, tree_leaves(alias), allow_unused=True, materialize_grads=True)
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t  # noqa: E731
    return (loss.detach(), (tree_map(detach, metrics), tree_map(detach, new_state))), list(grads)


def _train_step(loss_fn, adamw: optim.AdamWConfig, accum_steps: int) -> Callable:
    def train_step(ts, batch):
        params = ts["params"]
        if accum_steps == 1:
            (loss, (metrics, new_state)), grads = value_and_grad(loss_fn, params, ts["state"], batch)
        else:
            # Microbatch over the leading (batch) dim; grads summed in f32, averaged once.
            micro = {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:]) for k, v in batch.items()}
            new_state, loss, grads = ts["state"], None, None
            for i in range(accum_steps):
                (mb_loss, (_, new_state)), g = value_and_grad(loss_fn, params, new_state,
                                                               {k: v[i] for k, v in micro.items()})
                if grads is None:
                    loss, grads = mb_loss, g
                else:
                    loss = loss + mb_loss
                    for a, b in zip(grads, g):
                        a.add_(b)
            for g in grads:
                g.div_(accum_steps)
            loss = loss / accum_steps
            metrics = {}
        it = iter(grads)
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
    if rules is not None:
        raise NotImplementedError("mesh rules are not ported: the port runs on one card (ROADMAP item 8)")
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
        zeros = lambda s: ParamSpec(s.shape, s.axes, torch.float32, "zeros")  # noqa: E731
        ts_specs = {
            "params": param_specs,
            "state": state_specs,
            "opt": {"m": tree_map(zeros, param_specs), "v": tree_map(zeros, param_specs),
                    "step": spec((), (), dtype=torch.int32, init="zeros")},
        }
        loss_fn = _loss_fn(arch, shape.kind)
        step = _train_step(loss_fn, adamw or optim.AdamWConfig(), accum_steps)
        return CellProgram(name, shape.kind, step, (ts_specs, in_specs), donate=(0,),
                           meta={**meta, "loss_fn": loss_fn})

    serve_params = _cast_specs(param_specs, torch.bfloat16)

    if shape.kind == "prefill":

        def prefill_fn(params, batch):
            return lm.prefill(cfg, params, batch["tokens"])

        return CellProgram(name, shape.kind, prefill_fn, (serve_params, in_specs), meta=meta)

    if shape.kind == "decode":
        cache = lm.cache_specs(cfg, shape.batch, shape.seq)

        def decode_fn(params, cache, batch):
            return lm.decode_step(cfg, params, batch["token"], cache)

        return CellProgram(name, shape.kind, decode_fn, (serve_params, cache, in_specs), donate=(1,), meta=meta)

    if shape.kind == "denoise_step":
        if arch.family == "dit":

            def step_fn(params, batch):
                return diffusion.dit_sample_step(cfg, params, batch["x"], batch["t"], batch["dt"], batch["y"])

        else:

            def step_fn(params, batch):
                return diffusion.flux_sample_step(cfg, params, batch["x"], batch["txt"], batch["vec"], batch["t"],
                                                  batch["dt"], batch["guidance"])

        return CellProgram(name, shape.kind, step_fn, (serve_params, in_specs), meta=meta)

    if shape.kind == "classify_serve":
        serve_state = _cast_specs(state_specs, torch.float32)

        def serve_fn(params, state, batch):
            with torch.no_grad():
                return A.classifier_forward(arch, params, state, batch["images"], train=False)[0]

        return CellProgram(name, shape.kind, serve_fn, (serve_params, serve_state, in_specs), meta=meta)

    raise ValueError(f"unhandled kind {shape.kind}")
