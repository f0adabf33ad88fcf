"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the repository
root, then loaded with ``ctypes``.  The library name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time: the CPU tests import every
module of the port on machines that have no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
            "the port's CUDA kernels are built where the CUDA toolkit is installed"
        )
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_libraries(sources: Sequence[Path]) -> dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per source,
    all started together.  Returns ``{source name: compiler output}`` (the
    ``-Xptxas -v`` register and shared-memory report) for what was built;
    raises ``RuntimeError`` with the compiler output if any build fails."""
    jobs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        jobs.append((src, tmp, out, proc))
    logs: dict[str, str] = {}
    failed = []
    for src, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        logs[src.name] = log
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load_library(source: Path) -> ctypes.CDLL:
    """Load the library for ``source``, building it first if needed."""
    build_libraries([source])
    return ctypes.CDLL(str(library_path(source)))
