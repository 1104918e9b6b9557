"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through :mod:`ctypes` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/repro_torch_kernels/``
under the checkout, named by a hash of the sources and flags, so a stale
library is never loaded.  :func:`build` compiles every missing library in
parallel (one ``nvcc`` per source); :func:`library` builds on first use.
Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "build_dir", "library", "check_launch"]

SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "rglru_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_CSRC = Path(__file__).resolve().parent / "csrc"
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    """``<checkout>/build/repro_torch_kernels`` (``build/`` is git-ignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (_CSRC / f"{name}.cu", _CSRC / "common.cuh"):
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, ptxas_verbose: bool = False
          ) -> Dict[str, Tuple[float, str]]:
    """Compile every library in ``names`` that is not built yet.

    All ``nvcc`` processes start together and run in parallel.  Returns
    ``{name: (seconds, compiler stderr)}`` for the libraries compiled by
    this call; raises ``RuntimeError`` with the compiler output if any
    build fails.  ``ptxas_verbose`` adds ``-Xptxas -v`` (registers, shared
    memory and spills per kernel, in the returned stderr).
    """
    build_dir().mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results, failures = {}, []
    for name, (t0, tmp, out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        results[name] = (seconds, stderr)
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
