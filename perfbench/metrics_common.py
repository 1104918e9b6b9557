"""Helpers the metric readers share."""
from __future__ import annotations


def is_kernel(name: str, kernel: str) -> bool:
    """A bf16 launch of ``kernel`` (the remote model's; the hedge tier runs
    its kernels in float32)."""
    return kernel in name and "bfloat16" in name
