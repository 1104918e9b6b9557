"""Device selection shared by every entry point of the port.

Entry points default to ``"cuda"``.  The CPU runs only when a caller asks
for it (the CPU tests do); asking for CUDA on a machine without a usable
GPU raises instead of quietly running on the CPU.  ``"meta"`` is accepted
too: tensors with shapes and dtypes but no values, which the dry-run
(:mod:`repro_torch.launch.dryrun`) traces the model with; on it every
kernel call takes its plain version's shapes and no CUDA kernel runs.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, checked to be usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda, cpu or meta)")
    return dev
