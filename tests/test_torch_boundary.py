"""Package boundary of the PyTorch port: no JAX, no ``repro``, CUDA by default.

``repro_torch`` must import with ``jax`` (and ``repro``) blocked, no file
of the port, ``chip_smoke.py`` or the port's examples
(``examples/torch_*.py``) may import either, and an entry point
asked for nothing must refuse to run on a machine without a GPU instead
of quietly running on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT / "src").with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


MODULES = [_module_name(p) for p in FILES if p.is_relative_to(PORT)]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "for blocked in ('jax', 'jaxlib', 'repro', 'triton'):\n"
        "    sys.modules[blocked] = None\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m]]\n"
        "print('imported', len(" + repr(MODULES) + "))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"imported {len(MODULES)}" in res.stdout


def test_serve_without_device_flag_refuses_cpu(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--requests", "2", "--prompt", "4", "--gen", "1"])


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs.mdinference_zoo import ONDEVICE_HEDGE
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.launch import train
    from repro_torch.serving.backend import JitBackend, OnDeviceBackend
    from repro_torch.training import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
        lambda: JitBackend(64),
        lambda: OnDeviceBackend.from_zoo(max_len=64),
        lambda: T.init_params(ONDEVICE_HEDGE.config()),
        lambda: T.init_cache(ONDEVICE_HEDGE.config(), 1, 8),
        lambda: init_train_state(ONDEVICE_HEDGE.config()),
        lambda: train.main(["--arch", "gemma-2b", "--d-model", "32", "--steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    assert resolve_device("cpu").type == "cpu"
