"""The import guard compares whole top-level names, and neither a run's
path nor the reference loads what it must not."""

import os
import subprocess
import sys
from pathlib import Path

from kvbench.guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    names = ["repro_torch", "repro_torch.kvsim", "reprod", "jaxtyping", "flaxen", "kvbench.run",
             "repro", "repro.kvsim.simulate", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                                        "repro", "repro.kvsim.simulate"]


def _fresh(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_no_jax_package():
    code = (
        "from kvbench import run\n"
        "from kvbench.guard import forbidden_modules\n"
        "cell = run.load_cell('wan5-10m-maxmem.ycsb-b-hotspot')\n"
        "cell['config'].update(num_keys=500, daemon_interval=500, scenario_requests=2000,"
        " capacity_bytes=40 * 1024.0)\n"
        "run.execute(cell, 3, 0.0, False, device='cpu', log=lambda *a, **k: None)\n"
        "print(forbidden_modules())\n"
    )
    assert _fresh(code) == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import kvbench.reference.engine, kvbench.check\n"
        "print(sorted(m for m in sys.modules if m.partition('.')[0] == 'repro_torch'))\n"
    )
    assert _fresh(code) == "[]"
