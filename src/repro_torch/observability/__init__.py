"""Observability helpers (quantile math; tracing is not ported yet)."""
