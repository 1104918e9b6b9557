"""The device trace of a ``--trace 1`` run, reduced to what the readers need.

``torch.profiler`` (CPU and CUDA activities) runs over the window and its
drain.  Kept: every operation on the device (kernels, copies, fills) with
its start and length, and the benchmark's own host spans, moved onto the
profiler's clock by one calibration span.  Written nowhere: the profiler
keeps its buffers in memory and this module reads them once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

# What the host was doing, most telling first.
LABELS = ("generate.remote", "generate.hedge", "tick", "submit", "poll", "idle")


@dataclasses.dataclass
class DeviceTrace:
    ops: List[Tuple[str, int, int]]  # (name, start_ns, end_ns) on the device
    spans: List[Tuple[str, int, int]]  # the benchmark's host spans, same clock
    t0: int
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _intervals(self, pred: Optional[Callable[[str], bool]] = None) -> np.ndarray:
        rows = [(max(a, self.t0), min(b, self.t1)) for n, a, b in self.ops
                if pred is None or pred(n)]
        rows = [(a, b) for a, b in rows if b > a]
        return np.asarray(sorted(rows), dtype=np.int64).reshape(-1, 2)

    def busy_intervals(self) -> np.ndarray:
        """The union of the device's operations, as disjoint (start, end)."""
        iv = self._intervals()
        out = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.asarray(out, dtype=np.int64).reshape(-1, 2)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def op_seconds(self, pred: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose name passes ``pred``
        (overlapping launches on two streams count twice, as each ran)."""
        iv = self._intervals(pred)
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9 if iv.size else 0.0

    def top_ops(self, n: int = 10) -> List[list]:
        tot = {}
        for name, a, b in self.ops:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                tot[name] = tot.get(name, 0) + (b - a)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v / 1e9] for k, v in best]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest stretches with nothing on the device, each named
        by what the host was doing at its middle: a tier's ``generate``
        call where one ran, else the window's own step (``tick``,
        ``submit``, ``poll``, ``idle`` between them), else ``none``."""
        iv = self.busy_intervals()
        edges = [self.t0] + [x for ab in iv for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) // 2
            cover = {name for name, s0, s1 in self.spans if s0 <= mid <= s1}
            label = next((k for k in LABELS if k in cover), "none")
            out.append([label, (b - a) / 1e9])
        return out


def _short(name: str) -> str:
    """A kernel's name without its argument list (the last parenthesis
    outside template brackets)."""
    depth, cut = 0, None
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
    return name[:cut] if cut else name


class Tracer:
    """``with Tracer() as tr: ...`` profiles the block; ``tr.reduce(spans)``
    then gives the :class:`DeviceTrace`."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._cal_host = time.perf_counter_ns()
        with record_function("perfbench.calibrate"):
            pass
        self._t0_host = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._t1_host = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        return False

    def reduce(self, spans) -> DeviceTrace:
        ops, offset = [], None
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type().name == "CUDA":
                ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
            elif offset is None and e.name() == "perfbench.calibrate":
                offset = e.start_ns() - self._cal_host
        if offset is None:
            raise RuntimeError("the profiler recorded no host span: cannot place spans")
        self._prof = None  # the events are read; let the buffers go
        return DeviceTrace(
            ops=ops, spans=[(n, a + offset, b + offset) for n, a, b in spans],
            t0=self._t0_host + offset, t1=self._t1_host + offset)


@contextlib.contextmanager
def maybe_trace(on: bool):
    if not on:
        yield None
        return
    with Tracer() as tr:
        yield tr
