"""Dry run of every (arch x shape) cell for one card: the step traced on the
``meta`` device at the published config, and the roofline inputs it yields.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

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
the reference's records) as ``1x1__<arch>__<shape>.json``.

The record keeps the keys of the reference's that its readers use
(``benchmarks/roofline_bench.py``, ``benchmarks/make_experiments_tables.py``),
with ``"mesh": "1x1"``, ``"chips": 1``, ``lower_s`` / ``compile_s`` the
seconds of the two traces, and ``"fits"``: the larger peak within the
card's memory.  Left out, with no counterpart on one card: ``xla_cost_flops``
and ``hlo_bytes`` (no XLA program), ``top_collectives`` /
``top_collectives_flash`` (no HLO), ``kv_gather_s_analytic`` (no sequence
sharding, so no K/V gather) and ``memory.tpu_estimate_gb`` /
``upper_bound_gb`` (the reference's TPU memory factors).  ``--mesh
multi|both`` and ``--submesh`` wait for the multi-device path (ROADMAP item
8).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path

from .. import configs
from ..arch import n_params
from ..models import layers
from ..train.optim import AdamWConfig
from . import analysis
from .steps import build_cell


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


def run_cell(arch_name: str, shape_name: str, *, out_dir: Path | None, kv_quant: bool = False,
             smoke: bool = False) -> dict:
    """The record of one cell.  ``kv_quant``: an int8 KV cache for the LM
    cells; ``smoke``: the SMOKE config at the same shapes."""
    arch = configs.get(arch_name, smoke=smoke)
    shape = arch.shape(shape_name)
    if kv_quant and arch.family == "lm":
        arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, kv_quant=True))
    prog = build_cell(arch, shape_name, adamw=AdamWConfig())
    args = prog.init_args(device="meta")
    plain = analysis.trace(prog.fn, *args)
    with layers.flash_accounting():
        flash = analysis.trace(prog.fn, *args)
    chips = 1
    rf_noflash = analysis.roofline(plain.costs.flops, plain.costs.bytes, plain.collectives, chips)
    rf = analysis.roofline(plain.costs.flops, flash.costs.bytes, flash.collectives, chips)
    mf = analysis.model_flops(shape.kind, n_params(arch), _active_params(arch), _tokens_of(arch, shape))
    rec = {
        "arch": arch_name,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "1x1",
        "chips": chips,
        "card": analysis.CARD,
        "smoke": smoke,
        "kv_quant": kv_quant,
        "lower_s": round(plain.seconds, 2),
        "compile_s": round(flash.seconds, 2),
        "memory": _memory(plain, flash),
        "fits": max(plain.peak_bytes, flash.peak_bytes) <= analysis.HBM_BYTES,
        "flops_jaxpr": plain.costs.flops,
        "dot_flops": plain.dot_flops,
        "bytes_jaxpr": plain.costs.bytes,
        "bytes_jaxpr_flash": flash.costs.bytes,
        "collectives": plain.collectives,
        "collectives_flash": flash.collectives,
        "top_cost_sites": analysis.site_rows(plain.sites),
        "roofline": rf,
        "roofline_no_flash_kernel": rf_noflash,
        "model_flops": mf,
        "useful_compute_ratio": mf / plain.costs.flops if plain.costs.flops else 0.0,
        "n_params": n_params(arch),
    }
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{rec['mesh']}__{arch_name}__{shape_name}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single",
                    help="single: the step on one card (multi, both: ROADMAP item 8)")
    ap.add_argument("--submesh", default=None, help="DATAxMODEL serving replica (ROADMAP item 8)")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache for LM serve cells")
    ap.add_argument("--smoke", action="store_true", help="the SMOKE configs at the published shapes")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    if args.mesh != "single" or args.submesh:
        raise NotImplementedError("--mesh multi|both and --submesh spread a step over many devices; the port "
                                  "runs it on one card (ROADMAP item 8)")

    out = Path(args.out)
    cells = configs.cells() if args.all else [(args.arch, args.shape)]
    if args.arch and not args.shape:
        cells = [(args.arch, s.name) for s in configs.get(args.arch).shapes]

    ok, failed = 0, []
    for arch_name, shape_name in cells:
        tag = f"{arch_name}/{shape_name}@1x1"
        try:
            rec = run_cell(arch_name, shape_name, out_dir=out, kv_quant=args.kv_quant, smoke=args.smoke)
            r, m = rec["roofline"], rec["memory"]
            print(
                f"OK  {tag:40s} trace={rec['lower_s']:6.1f}+{rec['compile_s']:5.1f}s "
                f"mem={m['peak_per_device_gb']:8.3f}/{m['flash_peak_per_device_gb']:8.3f}GB "
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
