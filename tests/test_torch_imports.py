"""The port and chip_smoke.py import neither JAX nor the JAX package; the
port's CLIs run on the CPU when asked and refuse to fall back to it."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import shenqi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(shenqi_tpu_torch.__path__,
                                               "shenqi_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "shenqi_tpu" or m.startswith("shenqi_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("simulation", "ops.p2p", "cli.gadget_main",
                 "cli.genic_main", "fof.fof", "io.snapshot", "physics",
                 "physics.neutrinos_lra", "genic.thermal",
                 "simulation_gas", "ops.treewalk", "sph.kernels",
                 "sph.density", "sph.stencil_density", "sph.hydro",
                 "sph.stencil_hydro", "utils.threefry",
                 "physics.cooling_rates", "physics.sfr", "physics.winds",
                 "physics.veldisp", "physics.metal_return",
                 "physics.blackhole", "physics.uv_fluctuations",
                 "physics.helium_reion", "physics.excursion",
                 "physics.lightcone", "physics.plane", "genic.glass",
                 "parallel.collectives", "parallel.domain",
                 "parallel.pfft", "parallel.sharded", "parallel.slab_sim",
                 "parallel.launch", "parallel.sph_slab", "fof.slab",
                 "io.sharded_io"):
        assert f"shenqi_tpu_torch.{name}" in res["modules"], name
    assert res["bad"] == []


def test_cli_mains_run_on_cpu_and_refuse_without_card(tmp_path,
                                                      monkeypatch):
    """`main([..., "--device", "cpu"])` runs both CLIs here; without the
    flag they ask for CUDA and raise on a host with no card."""
    import torch
    from shenqi_tpu_torch.cli import gadget_main, genic_main
    pk = tmp_path / "pk_eh.txt"
    chip_smoke._eh_table(pk)
    gp = tmp_path / "p.genic"
    gp.write_text(chip_smoke._GENIC.format(out=tmp_path, ng=4, box=64000,
                                           pk=pk))
    pp = tmp_path / "p.gadget"
    pp.write_text(chip_smoke._GADGET.format(
        ic=tmp_path / "IC" / "IC", out=tmp_path / "output", a=0.105, fof=0,
        nmesh=8))
    assert genic_main.main([str(gp), "--device", "cpu"]) == 0
    assert gadget_main.main([str(pp), "2", "--device", "cpu"]) == 0
    assert (tmp_path / "output" / "PART_000").is_dir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        genic_main.main([str(gp)])
    with pytest.raises(RuntimeError, match="no card"):
        gadget_main.main([str(pp), "4"])
