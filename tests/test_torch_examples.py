"""The port's examples (``examples/torch_*.py``) on the CPU, when asked for:
the quickstart prints what the JAX package's quickstart prints."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(*argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_torch_quickstart_cpu_matches_the_jax_quickstart():
    got = _run("examples/torch_quickstart.py", "--device", "cpu")
    assert "duplication=True" in got and "static_greedy" in got
    assert got == _run("examples/quickstart.py")
