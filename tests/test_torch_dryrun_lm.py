"""The port's dry run (``launch/dryrun``) of the four decoder LMs' cells
against the reference's, on the CPU: train_4k, prefill_32k, decode_32k and
long_500k, SMOKE configs at the published shapes, traced on ``meta`` (the
rules and bands in ``test_torch_analysis.py``), an int8 KV cache beside, the
work units behind MODEL_FLOPS at the full configs; and the dry run's front
door: the CLI, its record, and what sizing a step on ``meta`` needs of the
port (``device.resolve_device``, ``arch.make_inputs``, ``lm.make_cache``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch
from test_torch_analysis import check_dot_flops, check_flash_bytes, check_totals, check_work_units, family_cells
from test_torch_analysis import reference_work_units
from test_torch_ref import REPO

from repro_torch import arch as A
from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch import dryrun, steps
from repro_torch.models import lm

FAMILIES = ("lm",)
CELLS = family_cells(FAMILIES)
RECORD_KEYS = {"arch", "shape", "kind", "mesh", "chips", "lower_s", "compile_s", "memory", "flops_jaxpr",
               "bytes_jaxpr", "bytes_jaxpr_flash", "collectives", "collectives_flash", "top_cost_sites", "roofline",
               "roofline_no_flash_kernel", "model_flops", "useful_compute_ratio", "n_params", "fits"}


@pytest.fixture(scope="module")
def ref_units():
    return reference_work_units(FAMILIES)


def test_cells_cover_the_family():
    assert len(CELLS) == 16


@pytest.mark.parametrize("name,shape", CELLS)
def test_dot_flops_equal_reference(name, shape):
    check_dot_flops(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_totals_beside_reference(name, shape):
    check_totals(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_flash_accounting_lowers_bytes(name, shape):
    check_flash_bytes(name, shape)


@pytest.mark.parametrize("name,shape", CELLS)
def test_work_units_equal_reference(ref_units, name, shape):
    check_work_units(ref_units, name, shape)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_int8_cache_cells(shape):
    """``--kv-quant``: the products equal the reference's with its int8
    cache; under accounting the stub reads the cache at its stored width."""
    check_dot_flops("qwen3-0.6b", shape, kv_quant=True)
    check_flash_bytes("qwen3-0.6b", shape, kv_quant=True)


def test_cli_writes_a_record(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b", "--shape", "decode_32k",
         "--smoke", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-4000:]
    assert "1 cells OK, 0 failed" in out.stdout
    rec = json.loads((tmp_path / "1x1__qwen3-0.6b__decode_32k.json").read_text())
    assert RECORD_KEYS <= rec.keys()
    assert (rec["mesh"], rec["chips"], rec["smoke"]) == ("1x1", 1, True)
    assert rec["roofline"]["bottleneck"] == "memory_s"  # decode reads the whole cache for one token
    assert rec["memory"]["peak_per_device_gb"] >= rec["memory"]["flash_peak_per_device_gb"] > 0
    assert {"peak_per_device_gb", "flash_peak_per_device_gb", "argument_bytes", "output_bytes", "temp_bytes",
            "alias_bytes"} <= rec["memory"].keys()
    assert rec["memory"]["alias_bytes"] > 0  # the cache, written in place
    assert not {"xla_cost_flops", "hlo_bytes", "kv_gather_s_analytic"} & rec.keys()


@pytest.mark.parametrize("argv", [["--mesh", "multi"], ["--mesh", "both"], ["--submesh", "4x4"]])
def test_multi_device_options_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", *argv])


def test_import_has_no_side_effect():
    code = ("import os, sys\n"
            "before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "assert dict(os.environ) == before\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert out.returncode == 0, out.stderr[-4000:]


def test_meta_device_sizes_without_values():
    assert resolve_device("meta").type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            resolve_device()
    arch = configs.get("qwen3-0.6b")
    shape = arch.shape("prefill_32k")
    batch = A.make_inputs(arch, shape, 0, device="meta")
    assert batch["tokens"].device.type == "meta" and tuple(batch["tokens"].shape) == (32, 32768)
    cache = lm.make_cache(arch.cfg, 32, 32768, device="meta")
    assert cache["k"].device.type == "meta" and tuple(cache["k"].shape) == (28, 32, 32768, 8, 128)
    cell = steps.build_cell(arch, "decode_32k")
    params = cell.init_arg(0, 0, "meta")
    assert all(t.device.type == "meta" for t in params["blocks"].values() if isinstance(t, torch.Tensor))
