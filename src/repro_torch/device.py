"""Device selection shared by every entry point of the port.

Entry points default to ``"cuda"``.  The CPU runs only when a caller asks
for it (the CPU tests do); asking for CUDA on a machine without a usable
GPU raises instead of quietly running on the CPU.
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
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
