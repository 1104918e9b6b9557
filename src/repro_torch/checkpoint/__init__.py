"""Fault-tolerant checkpointing (atomic, async-capable save and restore)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
