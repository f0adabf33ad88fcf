"""What the port has for the reference's compile cache, and its counter.

The reference (``repro.core.compile_cache``) turns on jax's persistent XLA
compilation cache, so a re-run of a sweep in a new process loads its
planner executables from disk instead of compiling them, and counts what
XLA really built with :class:`CompileCounter`.

The port compiles no XLA.  Its analogue of a compiled executable is the
CUDA graph a shape group's round is captured as
(:class:`repro_torch.core.sweep_shard.LaneProgram`), and the analogue of
jax's in-process executable cache is :data:`~repro_torch.core.sweep_shard
.PROGRAMS`, which keeps those programs, with their device buffers, keyed by
everything that shapes the graph.  A CUDA graph cannot outlive its
process, so there is no disk cache: :func:`enable_compile_cache` accepts a
directory, writes nothing there, and says so in what it returns;
``Session.run_sweep`` records that in ``meta["compile_cache"]``.

:class:`CompileCounter` counts, within its scope, the programs the cache
built (``misses``), served again (``hits``), and the CUDA graphs captured
(``captures``; on the CPU a program holds its buffers and no graph, so a
miss captures nothing).  ``compiles`` is ``captures``: the work the cache
exists to avoid repeating.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

_ENV_VAR = "REPRO_COMPILE_CACHE"

_ACTIVE: list["CompileCounter"] = []  # the counters whose scope is open


def enable_compile_cache(cache_dir: str | os.PathLike) -> dict:
    """Accept ``cache_dir`` as the reference's cache directory.  Nothing is
    written there: the port's cache of captured programs lives in this
    process.  Returns what ``run_sweep`` records in
    ``meta["compile_cache"]``."""
    return {"dir": os.fspath(cache_dir), "persistent": False, "scope": "process"}


def default_cache_dir() -> str | None:
    """The opt-in cache directory from the environment, if any."""
    return os.environ.get(_ENV_VAR) or None


def note(event: str) -> None:
    """Count ``event`` (``"captures"``, ``"hits"`` or ``"misses"``) in every
    open :class:`CompileCounter`."""
    for counter in _ACTIVE:
        setattr(counter, event, getattr(counter, event) + 1)


@dataclass(eq=False)  # counters are told apart by identity when their scopes nest
class CompileCounter:
    """Context manager counting the lane-program cache's traffic within its
    scope: graphs captured, programs served again, programs built."""

    captures: int = 0
    hits: int = 0
    misses: int = 0

    @property
    def compiles(self) -> int:
        """CUDA graphs captured: the port's counterpart of what XLA built."""
        return self.captures

    def __enter__(self) -> "CompileCounter":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)
