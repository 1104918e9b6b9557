"""Distributed training helpers (one GPU: gradient compression only)."""
