"""Ground rules of the PyTorch port, checked from outside the package.

* Running the port loads no JAX: a simulation served through the gateway
  runs in a fresh subprocess (this pytest process has JAX loaded already)
  and reports `sys.modules`.
* No source file of the port, and not `chip_smoke.py`, imports `jax` or
  anything of the JAX package `repro`.
* `chip_smoke.py` exits non-zero and prints no result without CUDA, and
  in a directory that holds nothing else of the repository.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))", re.M)

RUN_PORT = """
import sys
from repro_torch.fleet.analytics import AnalyticsConfig
from repro_torch.fleet.simulator import FleetSimulator, SimConfig
from repro_torch.serve import FleetGateway

sim = FleetSimulator(SimConfig(n_clients=12, p_leave=0.05, p_return=0.3, device="cpu"))
sim.run_analytics(AnalyticsConfig(sketch=True, window=8), windows=1, warmup_ticks=4)
gw = FleetGateway(sim)
t = gw.session("ana").fleet_stats("Vehicle.FuelRate", window=8)
gw.run_until_idle()
assert t.response.ok and t.response.body["count"] > 0
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def run(args, cwd, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_a_port_simulation_loads_no_jax():
    res = run([sys.executable, "-c", RUN_PORT], cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_no_jax_and_nothing_of_repro(path):
    text = (ROOT / path).read_text()
    assert not FORBIDDEN.findall(text), path


def test_the_scan_catches_what_it_must():
    bad = ["import jax", "from jax import numpy", "  import repro.core",
           "from repro.kernels import ops", "import jax.numpy as jnp"]
    good = ["import repro_torch.core", "from repro_torch.kernels import ops", "# jax"]
    assert all(FORBIDDEN.search(s) for s in bad)
    assert not any(FORBIDDEN.search(s) for s in good)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        res = run([sys.executable, str(script)], cwd=cwd)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout and '"kernels"' not in res.stdout
