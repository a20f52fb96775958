"""The port and chip_smoke.py import neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys
from pathlib import Path

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
    assert "shenqi_tpu_torch.simulation" in res["modules"]
    assert "shenqi_tpu_torch.ops.p2p" in res["modules"]
    assert res["bad"] == []
