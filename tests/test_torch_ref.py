"""Shared helpers for the PyTorch port's tests, plus the port's import
isolation check.

The reference package ``repro`` does not import on jax 0.9 as it stands
(``core/sim_batch.py`` imports ``jax.experimental.enable_x64``, which moved to
``jax.enable_x64``; ``core/sim_online_batch.py`` tests membership on
``batching.primitive_batchers``, whose proxy type lost ``__contains__``).
The port's tests get past both from their own side with two shims, each
installed only where the attribute is missing; ``src/repro`` is untouched.
Other ``test_torch_*`` files import this module first.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
from jax._src.interpreters import batching

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
if not hasattr(type(batching.primitive_batchers), "__contains__"):
    type(batching.primitive_batchers).__contains__ = (
        lambda self, p: p in batching.fancy_primitive_batchers
    )

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def reference_params(arch_name: str, seed: int, *, smoke: bool = True):
    """Random weights for the reference's ``arch_name`` as numpy trees
    (params, state), drawn with numpy from ``seed``: fan-in scaled normals
    like ``init_tree``, and non-trivial BatchNorm statistics so carrying the
    state across is exercised."""
    from repro import configs
    from repro.arch import abstract_params
    from repro.models.common import ParamSpec

    arch = configs.get(arch_name, smoke=smoke)
    specs, state_specs = abstract_params(arch)
    rng = np.random.default_rng(seed)

    def param(s: ParamSpec) -> np.ndarray:
        if s.init == "zeros":
            return rng.normal(0.0, 0.05, s.shape).astype(np.float32)  # biases
        if s.init == "ones":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)  # BN scales
        if s.init == "conv":
            fan = np.prod(s.shape[-4:-1])  # KH * KW * Cin (stack axis excluded)
        else:
            fan = s.shape[-2]
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(np.float32)

    def stat(path, s: ParamSpec) -> np.ndarray:
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return rng.normal(0.0, 0.1, s.shape).astype(np.float32)
        return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)

    is_spec = lambda x: isinstance(x, ParamSpec)  # noqa: E731
    params = jax.tree.map(param, specs, is_leaf=is_spec)
    state = jax.tree_util.tree_map_with_path(stat, state_specs, is_leaf=is_spec)
    return arch, params, state


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of ``repro_torch`` leaves ``jax`` and the
    reference package out of ``sys.modules`` (checked in a fresh process)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(names) >= 25, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_reference_imports_with_shims():
    """The shims make the reference's session importable here."""
    import repro.session

    assert hasattr(repro.session, "Session")
