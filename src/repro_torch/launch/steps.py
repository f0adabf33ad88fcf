"""Build step programs per (arch x shape) cell — the serving kinds.

``build_cell(arch, shape_name)`` returns a CellProgram with:
  fn          the step callable (prefill / decode / denoise_step /
              classify_serve)
  arg_specs   ParamSpec trees of its arguments (``common.abstract_tree``
              sizes them without allocating)
  donate      argument indices the step updates in place (the KV cache)

``prog.init_args(seed, device="cuda")`` materializes the arguments and
``prog(*args)`` runs the step.  Serving parameters are drawn directly in
bf16 from the cast specs, a leaf at a time: no full f32 tree is ever made
(command-r's would be 130 GB).

A ``denoise_step`` cell runs one sampler step of DiT (DDIM, cosine
schedule) or Flux (rectified-flow Euler) on ``{"x", "t", "dt", ...}``.
The training kinds (``train``, ``denoise_train``, ``classify_train``) are
not ported yet (ROADMAP item 9); mesh rules wait for the multi-device path
(item 8).  Both raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .. import arch as A
from ..device import resolve_device
from ..models import diffusion, lm
from ..models.common import ParamSpec, init_tree, tree_map

_TRAIN_KINDS = ("train", "denoise_train", "classify_train")


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
        alone and equals its entry in ``init_args``."""
        device = resolve_device(device)
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


def build_cell(arch: A.Arch, shape_name: str, rules=None) -> CellProgram:
    """The step program of ``arch`` at its shape ``shape_name``."""
    if rules is not None:
        raise NotImplementedError("mesh rules are not ported: the port runs on one card (ROADMAP item 8)")
    shape = arch.shape(shape_name)
    if shape.kind in _TRAIN_KINDS:
        raise NotImplementedError(f"{arch.name}/{shape.name}: the {shape.kind!r} step is not ported (ROADMAP item 9)")
    arch = _shape_cfg(arch, shape)
    cfg = arch.cfg
    param_specs, state_specs = A.abstract_params(arch)
    in_specs = A.input_specs(arch, shape)
    name = f"{arch.name}/{shape.name}"
    meta = {"arch": arch, "shape": shape}
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
