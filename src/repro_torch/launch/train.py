"""Training driver: data pipeline -> train step (``steps.build_cell``) ->
async checkpoints, with deterministic restart (checkpoint + data skip-ahead)
and the straggler monitor.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch resnet-50 --smoke --steps 50 --batch 8 --img 32 --ckpt-dir ckpt

``--device`` defaults to ``cuda`` and raises where there is no card; pass
``--device cpu`` to train on the CPU.  ``--shape`` names an assigned shape of
a full config (its published batch); ``--accum-steps`` splits each batch
into that many microbatches (``build_cell``'s ``accum_steps``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="assigned shape name (full configs)")
    ap.add_argument("--smoke", action="store_true", help="reduced config + custom dims")
    ap.add_argument("--steps", type=int, default=20, help="steps to run this invocation")
    ap.add_argument(
        "--total-steps", type=int, default=None,
        help="schedule horizon (defaults to --steps); keep it FIXED across restarts",
    )
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--accum-steps", type=int, default=1, help="microbatches a step (gradient accumulation)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import configs
    from ..arch import ShapeSpec
    from ..checkpoint import AsyncCheckpointer, latest_step, restore
    from ..data import DataSpec, SyntheticStream, make_batch_iterator
    from ..device import resolve_device
    from ..runtime import StragglerMitigator
    from ..train.optim import AdamWConfig
    from .steps import build_cell

    device = resolve_device(args.device)
    arch = configs.get(args.arch, smoke=args.smoke)
    if args.shape and not args.smoke:
        shape_name = args.shape
        arch_run = arch
    else:
        fam = arch.family
        if fam == "lm":
            shape = ShapeSpec("cli_train", "train", args.batch, seq=args.seq)
        elif fam in ("dit", "flux"):
            shape = ShapeSpec("cli_train", "denoise_train", args.batch, img=args.img, steps=2)
        else:
            shape = ShapeSpec("cli_train", "classify_train", args.batch, img=args.img)
        arch_run = dataclasses.replace(arch, shapes=(shape,))
        shape_name = "cli_train"

    total = args.total_steps or args.steps
    adamw = AdamWConfig(lr=args.lr, warmup_steps=max(total // 10, 1), total_steps=total)
    prog = build_cell(arch_run, shape_name, adamw=adamw, accum_steps=args.accum_steps)

    ts = prog.init_arg(0, args.seed, device)
    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir)
        if args.resume:
            last = latest_step(args.ckpt_dir)
            if last is not None:
                ts, _extra = restore(args.ckpt_dir, last, ts)
                start = last
                print(f"resumed from step {start}", flush=True)

    stream = SyntheticStream(DataSpec(arch_run, arch_run.shape(shape_name), seed=args.seed))
    it = make_batch_iterator(stream, start_step=start)
    straggler = StragglerMitigator()

    losses = []
    t_start = time.time()
    try:
        for step in range(start, args.steps):
            batch = {k: torch.as_tensor(v, device=device) for k, v in next(it).items()}
            t0 = time.perf_counter()
            ts, metrics = prog(ts, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            straggler.observe("worker-0", dt)
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(
                    f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms",
                    flush=True,
                )
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, ts, {"loss": loss})
        if ckpt:
            ckpt.save(args.steps, ts, {"loss": losses[-1] if losses else None})
    finally:
        it.close()
        if ckpt:
            ckpt.close()
    wall = time.time() - t_start
    result = {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps": len(losses),
        "wall_s": wall,
    }
    print(f"done: {result}", flush=True)
    return result


if __name__ == "__main__":
    main()
