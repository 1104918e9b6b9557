"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program (top-level names compared whole)."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_RUN = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body: str):
    code = _RUN.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules(
        "from perfbench import run\n"
        "from perfbench.tests.tiny import tiny_cell\n"
        "out = run.run_cell(tiny_cell('olmoe-1b-7b', 'classify-olmoe-1b-7b'), 11, 0.6, False,"
        " 'cpu', time.perf_counter())\n"
        "assert out['correct'], out\n"
        "import perfbench.sweep\n")
    assert not mods & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in mods  # whole names: the port's name begins with the JAX package's


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import perfbench.reference.check, perfbench.reference.model, "
                    "perfbench.weights, perfbench.loadgen, perfbench.yardstick\n")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
