"""Launch counters: one per kernel wrapper, incremented where it launches.

A counter is a plain integer behind a lock (the async dispatch path
launches from worker threads).  A run sets them to 0, drives its path and
reads them to show which kernels that path really went through.
"""
from __future__ import annotations

import threading

__all__ = ["LaunchCounter"]


class LaunchCounter:
    def __init__(self, name: str):
        self.name = name
        self._count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._count += n

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self) -> None:
        with self._lock:
            self._count = 0
