"""Device selection shared by the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``; asking for
the card on a machine without one raises instead of quietly running on the
CPU.  Tests pass ``device="cpu"`` explicitly.  ``"meta"`` sizes a step
without running it (``launch/dryrun``): tensors have shapes and dtypes and
no values, and nothing is allocated.

Under a process group (one process a rank, as ``torchrun`` starts them),
``"cuda"`` is this rank's card: ``cuda:{LOCAL_RANK % device_count}``, the
card ``DeviceMesh`` gives the rank (``get_rank()`` where ``LOCAL_RANK`` is
unset).  Ranks that outnumber the cards share them.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; want 'cuda', 'cpu' or 'meta'")
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count())
    return dev
