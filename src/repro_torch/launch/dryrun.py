"""Dry run of every (arch x shape) cell: the step traced on the ``meta``
device at the published config, for one card or as one rank of the
production meshes, and the roofline inputs it yields.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k --submesh 4x4

The counterpart of the reference's ``launch/dryrun``, which lowers and
compiles each cell over 512 fake devices.  Here a cell's step runs twice on
``meta`` arguments (shapes and dtypes, no values: nothing is allocated and
no card is needed) under ``analysis.CostCounter``: once as the program runs
without the kernel, for FLOPs, bytes and the peak of live bytes; once under
``layers.flash_accounting``, where the flash kernel's scores never reach
memory, for ``bytes_jaxpr_flash`` and ``flash_peak_per_device_gb``.  The
roofline takes FLOPs from the first and bytes from the second, with the
no-kernel roofline beside it, against ``analysis.CARD``'s peaks.  A record
per cell goes to ``--out`` (default ``artifacts/dryrun_torch``, apart from
the reference's records) as ``<mesh>__<arch>__<shape>.json``.

Without ``--mesh`` or ``--submesh`` the step is one card's (``"mesh":
"1x1"``, ``"chips": 1``).  ``--mesh single`` traces it on the 16x16
production mesh (256 devices), ``multi`` on 2x16x16 (512), ``both`` on the
two, and ``--submesh DxM`` on a (data, model) serving replica.  A mesh cell
is traced as rank 0 of a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``), started in this process
and torn down after: the ruled step (``train_rules`` or ``serve_rules``,
``arch.sharding_overrides`` on top, as the reference) runs on ``meta``
DTensors of the rank's slices, and every collective it issues returns at
once.  As the reference's, the record's ``flops_jaxpr``, ``bytes_jaxpr``,
``bytes_jaxpr_flash``, ``dot_flops``, ``model_flops`` and
``top_cost_sites`` are the global program's (the one-card trace, made once
per cell for all its meshes: ``global_s``), and ``memory``, ``fits``,
``collectives``, ``collectives_flash`` and ``top_collectives`` are one
device's (the rank's two traces: ``lower_s``, ``compile_s``); the roofline
divides FLOPs and bytes by ``chips`` and prices the rank's collectives at
``analysis.LINK_BW`` (one NVLink 4 link: a floor past an 8-card NVLink
domain).  ``rules_collectives`` counts what ``sharding.rules`` issued, by
kind.  An LM prefill or train cell whose K and V are narrower than its
activations carries the reference's ``kv_gather_s_analytic``, not added to
the estimate (:func:`record` says why).  A dry run refuses to run in a
process that already has a process group.

The record keeps the keys of the reference's that its readers use
(``benchmarks/roofline_bench.py``, ``benchmarks/make_experiments_tables.py``),
with ``lower_s`` / ``compile_s`` the seconds of the two traces and
``"fits"``: the larger peak within the card's memory.  Left out, with no
counterpart here: ``xla_cost_flops`` and ``hlo_bytes`` (no XLA program) and
``memory.tpu_estimate_gb`` / ``upper_bound_gb`` (the reference's TPU
memory factors); a one-card record has no ``top_collectives`` and no
``kv_gather_s_analytic``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import traceback
from pathlib import Path

import torch.distributed as dist

from .. import configs
from ..arch import n_params
from ..models import layers
from ..sharding import rules as R
from ..sharding.rules import MeshRules, serve_rules, train_rules
from ..train.optim import AdamWConfig
from . import analysis
from .mesh import Mesh
from .steps import build_cell

# --mesh -> the production meshes a rank of which is traced (--submesh names its own)
MESHES = {"single": ("16x16",), "multi": ("2x16x16",), "both": ("16x16", "2x16x16")}


def _tokens_of(arch, shape) -> float:
    """Work units (tokens / patches / pixels-equivalents) for MODEL_FLOPS."""
    if arch.family == "lm":
        if shape.kind == "train":
            return shape.batch * shape.seq
        if shape.kind == "prefill":
            return shape.batch * shape.seq
        return shape.batch * 1.0  # decode: one token per sequence
    if arch.family in ("dit", "flux"):
        lat = shape.img // 8
        return shape.batch * (lat // arch.cfg.patch) ** 2
    return shape.batch * (shape.img // 16) ** 2  # vision: ~patch16 equivalents


def _active_params(arch) -> int:
    if arch.family == "lm" and arch.cfg.moe is not None:
        m = arch.cfg.moe
        full = n_params(arch)
        expert_p = 3 * m.d_model * m.d_ff_expert
        inactive = (m.n_experts - m.top_k) * expert_p * arch.cfg.n_layers
        return full - inactive
    return n_params(arch)


def _memory(plain: analysis.Trace, flash: analysis.Trace) -> dict:
    return {
        "argument_bytes": plain.argument_bytes,
        "output_bytes": plain.output_bytes,
        "temp_bytes": plain.peak_bytes - plain.argument_bytes - plain.output_bytes,
        "alias_bytes": plain.alias_bytes,
        "peak_per_device_gb": round(plain.peak_bytes / 1e9, 3),
        "flash_peak_per_device_gb": round(flash.peak_bytes / 1e9, 3),
        "peak_bytes": plain.peak_bytes,
        "flash_peak_bytes": flash.peak_bytes,
    }


def mesh_axes(mesh: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Axis names and extents of a mesh named as the records name it:
    "16x16" and a ``--submesh`` "DxM" over (data, model), "2x16x16" over
    (pod, data, model)."""
    sizes = tuple(int(n) for n in mesh.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if names is None or min(sizes) < 1:
        raise ValueError(f"mesh {mesh!r}: expected DATAxMODEL or PODxDATAxMODEL")
    return names, sizes


@contextlib.contextmanager
def fake_rank(mesh: str, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of the mesh's
    size (``torch.testing._internal.distributed.fake_pg``: every collective
    returns at once and moves nothing), with a :class:`Mesh` over it; the
    group is torn down on exit.  Refused in a process that already has a
    process group, whose collectives would reach real ranks."""
    names, sizes = mesh_axes(mesh)
    if dist.is_initialized():
        raise RuntimeError(f"a dry run over {mesh} starts a fake process group of its own; this process "
                           "already has a process group, and a dry run issues no collective to real ranks")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("a dry run over a mesh needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg), which this torch lacks") from e
    from torch.distributed.device_mesh import init_device_mesh

    world = math.prod(sizes)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a {mesh} mesh of {world} devices")
    dist.init_process_group("fake", rank=rank, world_size=world, store=FakeStore())
    try:
        yield Mesh(names, sizes, init_device_mesh("cpu", sizes, mesh_dim_names=names))
    finally:
        dist.destroy_process_group()
        _forget_layouts()


def _forget_layouts() -> None:
    """Empty DTensor's caches of layout propagation.  They hold the
    ``DeviceMesh`` of a group torn down, and a mesh of the next group
    compares equal to it, so a cached layout would hand an op's output the
    old mesh, whose groups no longer resolve."""
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    _clear_sharding_prop_cache()


def traces(prog) -> tuple[analysis.Trace, analysis.Trace, dict]:
    """``prog``'s step traced on ``meta`` arguments (a rank's slices under
    its rules), as the program runs and under ``layers.flash_accounting``,
    and the collectives ``sharding.rules`` issued in the first, by kind."""
    args = prog.init_args(device="meta")
    before = collections.Counter(R.COLLECTIVES)
    plain = analysis.trace(prog.fn, *args)
    issued = dict(collections.Counter(R.COLLECTIVES) - before)
    with layers.flash_accounting():
        flash = analysis.trace(prog.fn, *args)
    return plain, flash, issued


def rank_program(arch, shape_name: str, mesh: Mesh, adamw: AdamWConfig | None = None):
    """``arch``'s step at ``shape_name`` under the reference's rule table on
    ``mesh`` (``train_rules`` for a training kind, else ``serve_rules``;
    ``arch.sharding_overrides`` on top); a training kind's optimizer
    ``adamw`` (default ``AdamWConfig()``)."""
    table = (train_rules if "train" in arch.shape(shape_name).kind else serve_rules)(mesh)
    table.update(arch.sharding_overrides or {})
    return build_cell(arch, shape_name, rules=MeshRules(mesh, table), adamw=adamw or AdamWConfig())


def kv_gather_s(arch, shape) -> float:
    """The reference's analytic K/V gather (its ``kv_gather_s_analytic``):
    an LM prefill or train step whose K and V are narrower than its
    activations (2·KH·hd < D) at ``analysis.LINK_BW``; 0 elsewhere."""
    cfg = arch.cfg
    if arch.family != "lm" or shape.kind not in ("prefill", "train") or 2 * cfg.n_kv_heads * cfg.hd >= cfg.d_model:
        return 0.0
    traversals = 3.0 if shape.kind == "train" else 1.0
    return 2 * shape.seq * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers * traversals / analysis.LINK_BW


def cell_arch(arch_name: str, *, kv_quant: bool = False, smoke: bool = False):
    arch = configs.get(arch_name, smoke=smoke)
    if kv_quant and arch.family == "lm":
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, kv_quant=True))
    return arch


def global_traces(arch, shape_name: str, adamw: AdamWConfig | None = None) -> tuple[analysis.Trace, analysis.Trace]:
    """The global program's (plain, flash) traces: the step on one card, no rules."""
    return traces(build_cell(arch, shape_name, adamw=adamw or AdamWConfig()))[:2]


def record(arch, shape_name: str, *, mesh: str | None = None, rank: int = 0, global_=None,
           adamw: AdamWConfig | None = None) -> dict:
    """The record of ``arch``'s step at ``shape_name``.  Without ``mesh``
    the one-card record (``"1x1"``); with one ("16x16", "2x16x16" or a
    submesh "DxM"), rank ``rank``'s over a fake group of the mesh's size:
    FLOPs, bytes and sites of the global program (``global_``: its traces
    from :func:`global_traces`, made here if None), memory and collectives
    of the rank's ruled step (:func:`rank_program`).  ``adamw``: a training
    kind's optimizer (default ``AdamWConfig()``)."""
    shape = arch.shape(shape_name)
    if mesh is None:
        plain, flash = global_ or global_traces(arch, shape_name, adamw)
        rank_plain, rank_flash, issued, chips = plain, flash, {}, 1
    else:
        with fake_rank(mesh, rank) as m:
            rank_plain, rank_flash, issued = traces(rank_program(arch, shape_name, m, adamw))
            chips = m.size
        plain, flash = global_ or global_traces(arch, shape_name, adamw)
    coll, coll_flash = rank_plain.collectives, dict(rank_flash.collectives)
    kv_s = kv_gather_s(arch, shape) if mesh is not None else 0.0
    if kv_s:
        # The reference adds this to its flash estimate because its compiler
        # drops the K/V gather beside the stub.  The port runs what it
        # traces: each rank computes its K/V heads from the whole sequence,
        # which it holds (prefill) or gathers in the trace (train: the x
        # gather at every sublayer, lm._unshard_seq), so the gather is not
        # added a second time.
        coll_flash["kv_gather_s_analytic"] = kv_s
    rf_noflash = analysis.roofline(plain.costs.flops, plain.costs.bytes, coll, chips)
    rf = analysis.roofline(plain.costs.flops, flash.costs.bytes, coll_flash, chips)
    mf = analysis.model_flops(shape.kind, n_params(arch), _active_params(arch), _tokens_of(arch, shape))
    rec = {
        "arch": arch.name,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh or "1x1",
        "chips": chips,
        "card": analysis.CARD,
        "lower_s": round(rank_plain.seconds, 2),
        "compile_s": round(rank_flash.seconds, 2),
        "memory": _memory(rank_plain, rank_flash),
        "fits": max(rank_plain.peak_bytes, rank_flash.peak_bytes) <= analysis.HBM_BYTES,
        "flops_jaxpr": plain.costs.flops,
        "dot_flops": plain.dot_flops,
        "bytes_jaxpr": plain.costs.bytes,
        "bytes_jaxpr_flash": flash.costs.bytes,
        "collectives": coll,
        "collectives_flash": coll_flash,
        "top_cost_sites": analysis.site_rows(plain.sites),
        "roofline": rf,
        "roofline_no_flash_kernel": rf_noflash,
        "model_flops": mf,
        "useful_compute_ratio": mf / plain.costs.flops if plain.costs.flops else 0.0,
        "n_params": n_params(arch),
    }
    if mesh is not None:
        rec.update(rank=rank, global_s=round(plain.seconds + flash.seconds, 2), rules_collectives=issued,
                   top_collectives=analysis.collective_rows(rank_plain.collective_sites),
                   top_collectives_flash=analysis.collective_rows(rank_flash.collective_sites))
    return rec


def run_cell(arch_name: str, shape_name: str, *, out_dir: Path | None, kv_quant: bool = False,
             smoke: bool = False, mesh: str | None = None, global_=None) -> dict:
    """The record (:func:`record`, rank 0's on a mesh) of one cell, written
    to ``out_dir`` as ``<mesh>__<arch>__<shape>.json``.  ``kv_quant``: an
    int8 KV cache for the LM cells; ``smoke``: the SMOKE config at the same
    shapes."""
    arch = cell_arch(arch_name, kv_quant=kv_quant, smoke=smoke)
    rec = {**record(arch, shape_name, mesh=mesh, global_=global_), "smoke": smoke, "kv_quant": kv_quant}
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{rec['mesh']}__{arch_name}__{shape_name}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=sorted(MESHES), default=None,
                    help="one rank of the production mesh: single 16x16, multi 2x16x16, both (default: one card)")
    ap.add_argument("--submesh", default=None, help="DATAxMODEL serving replica, e.g. 4x4")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache for LM serve cells")
    ap.add_argument("--smoke", action="store_true", help="the SMOKE configs at the published shapes")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    if args.submesh:
        mesh_axes(args.submesh)  # a malformed submesh fails here, before any cell
    meshes = [args.submesh] if args.submesh else list(MESHES[args.mesh]) if args.mesh else [None]

    out = Path(args.out)
    cells = configs.cells() if args.all else [(args.arch, args.shape)]
    if args.arch and not args.shape:
        cells = [(args.arch, s.name) for s in configs.get(args.arch).shapes]

    ok, failed = 0, []
    for arch_name, shape_name in cells:
        kw = {"kv_quant": args.kv_quant, "smoke": args.smoke}
        traced = None  # the global program's traces, shared by the meshes
        for mesh in meshes:
            tag = f"{arch_name}/{shape_name}@{mesh or '1x1'}"
            try:
                traced = traced or global_traces(cell_arch(arch_name, **kw), shape_name)
                rec = run_cell(arch_name, shape_name, out_dir=out, mesh=mesh, global_=traced, **kw)
                r, m = rec["roofline"], rec["memory"]
                print(
                    f"OK  {tag:48s} trace={rec['lower_s']:6.1f}+{rec['compile_s']:5.1f}s "
                    f"mem/dev={m['peak_per_device_gb']:8.3f}/{m['flash_peak_per_device_gb']:8.3f}GB "
                    f"compute={r['compute_s']:.3e}s mem={r['memory_s']:.3e}s "
                    f"coll={r['collective_s']:.3e}s -> {r['bottleneck']}{'' if rec['fits'] else ' (does not fit)'}",
                    flush=True,
                )
                ok += 1
            except Exception as e:  # noqa: BLE001 -- one cell's failure is reported, the rest still run
                failed.append(tag)
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    print(f"\n{ok} cells OK, {len(failed)} failed")
    for f in failed:
        print("  FAILED:", f)
    raise SystemExit(1 if failed else 0)


if __name__ == "__main__":
    main()
