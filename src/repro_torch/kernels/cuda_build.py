"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through :mod:`ctypes` (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/repro_torch_kernels/``
under the checkout, named by a hash of the sources and flags, so a stale
library is never loaded.  :func:`build` compiles every missing library in
parallel (one ``nvcc`` per source, each splitting its device code's
optimisation over the host's cores, which the 126 template instantiations
of ``decode_attention.cu`` need most); :func:`library` builds on first
use.  Nothing is compiled or loaded at import time.
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

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "build_dir", "library", "library_path", "sass",
           "check_launch"]

SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "rglru_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-split-compile=0",  # as many threads as the host has cores
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


def sass(name: str):
    """``cuobjdump -sass`` of the built library for ``csrc/<name>.cu``, or
    None where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", str(library_path(name))], capture_output=True,
                          text=True, check=True).stdout


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is (or will be) built: named
    by a hash of the flags, the source and every header."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in (_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))):
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
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = {}

    def wait(name, t0, proc):  # each build's own seconds, whichever ends first
        done[name] = (*proc.communicate(), time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=(name, t0, proc))
               for name, (t0, _, _, proc) in procs.items()]
    for t in waiters:
        t.start()
    for t in waiters:
        t.join()
    results, failures = {}, []
    for name, (_, tmp, out, proc) in procs.items():
        stdout, stderr, seconds = done[name]
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
            lib = ctypes.CDLL(str(library_path(name)))
            lib.cuda_error_string.argtypes = [ctypes.c_int]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error (its cudaGetLastError)."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
