"""Tracing layer: explicit-parent spans with ``perf_counter``-ms stamps.

One :class:`Tracer` per :class:`~repro_torch.observability.Observability` handle
collects :class:`Span` records from every stage of the serving stack.  A
span is deliberately dumb — a name, a category, an optional display
``track``, explicit ``parent_id`` linkage, start/end stamps in
``time.perf_counter() * 1e3`` milliseconds, and a small ``args`` dict —
so recording is a list append under a lock and the exporters
(:mod:`repro_torch.observability.export`) own all formatting.

Span taxonomy (producers across the stack):

* per request — ``request`` root (one per submitted request, on its
  tenant lane's track), ``queued`` (submit → tick claim), ``remote`` /
  ``ondevice`` tier legs (dispatch → done wall stamps, on the serving
  replica's track), and instants: ``scheduled``, ``ttft``,
  ``stream.token``, ``requeue``, ``resolve`` / ``shed`` / ``cancel``
  (exactly one terminal instant per request — the conservation check).
* per tick — ``tick`` on the ``loop`` track, plus ``batch:<variant>``
  group spans on each replica's track.
* transport — ``transport.roundtrip`` with a nested ``worker.execute``
  reconstructed from the worker-side stamps that ride the completion
  message (see :mod:`repro_torch.serving.transport`).
* control plane — ``controller.retune`` and ``breaker.trip`` instants.

Cross-thread / cross-layer parentage uses a thread-local *ambient* span:
a dispatching layer binds its span (:meth:`Tracer.bind`), and a deeper
layer that cannot receive the span through its call signature (the
transport under the generic ``run_batch`` protocol) picks it up with
:meth:`Tracer.ambient_id`.

Span ids are small ints assigned in creation order — deterministic for a
fixed call sequence, which is what lets tests pin span trees.

Host stamps on an asynchronous device: the tracer reads the host clock,
and a CUDA launch returns before its kernel runs.  A span that times
device work is therefore closed only after the work's stream has been
synchronized: ``JitBackend.generate`` synchronizes its stream before it
stamps the batch wall, so the ``remote`` / ``ondevice`` legs and the
``batch:<variant>`` groups (closed at the handle's done stamp),
``transport.roundtrip`` and ``worker.execute`` (the worker replies after
``generate`` returns) time the device.  The continuous tier's ``ttft`` and
``stream.token`` instants are stamped after the token reached the host.
``request``, ``queued``, ``tick``, ``scheduled`` and the control-plane
instants time host work only.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "now_wall_ms"]


def now_wall_ms() -> float:
    """The tracer clock: ``time.perf_counter()`` in milliseconds."""
    return time.perf_counter() * 1e3


class Span:
    """One timed (or instant) event; linked to its parent by id."""

    __slots__ = (
        "span_id", "parent_id", "name", "cat", "track",
        "start_ms", "end_ms", "args",
    )

    def __init__(
        self,
        span_id: int,
        parent_id: Optional[int],
        name: str,
        cat: str,
        track: Optional[str],
        start_ms: float,
        args: Optional[Dict],
    ):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.track = track
        self.start_ms = start_ms
        self.end_ms: Optional[float] = None  # None while open; == start: instant
        self.args = args if args is not None else {}

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self.end_ms is None else self.end_ms - self.start_ms

    @property
    def is_instant(self) -> bool:
        return self.end_ms == self.start_ms

    def to_dict(self) -> Dict:
        """JSONL wire form (the span-sink exporter's row format)."""
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "cat": self.cat,
            "track": self.track,
            "start_ms": self.start_ms,
            "end_ms": self.end_ms,
            "args": self.args,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "open" if self.end_ms is None else f"{self.duration_ms:.3f}ms"
        return f"Span({self.span_id}, {self.name!r}, {state})"


class Tracer:
    """Append-only span collector; thread-safe, export-agnostic."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 0
        self.spans: List[Span] = []
        self._tl = threading.local()  # per-thread ambient-parent stack

    # -- recording ------------------------------------------------------------
    def start(
        self,
        name: str,
        *,
        parent=None,
        cat: str = "",
        track: Optional[str] = None,
        t0_ms: Optional[float] = None,
        **args,
    ) -> Span:
        """Open a span.  ``parent`` is a :class:`Span` or a raw span id."""
        parent_id = parent.span_id if isinstance(parent, Span) else parent
        t0 = now_wall_ms() if t0_ms is None else float(t0_ms)
        with self._lock:
            span = Span(self._next_id, parent_id, name, cat, track, t0, args)
            self._next_id += 1
            self.spans.append(span)
        return span

    def end(self, span: Span, t1_ms: Optional[float] = None) -> Span:
        """Close a span (idempotent — the first close wins)."""
        if span.end_ms is None:
            t1 = now_wall_ms() if t1_ms is None else float(t1_ms)
            span.end_ms = max(t1, span.start_ms)
        return span

    def instant(
        self,
        name: str,
        *,
        parent=None,
        cat: str = "",
        track: Optional[str] = None,
        t_ms: Optional[float] = None,
        **args,
    ) -> Span:
        """A zero-duration mark (``start_ms == end_ms``)."""
        span = self.start(
            name, parent=parent, cat=cat, track=track, t0_ms=t_ms, **args
        )
        span.end_ms = span.start_ms
        return span

    @contextlib.contextmanager
    def span(self, name: str, **kw):
        """``with tracer.span("tick") as s:`` — start, yield, end."""
        s = self.start(name, **kw)
        try:
            yield s
        finally:
            self.end(s)

    # -- ambient (thread-local) parentage --------------------------------------
    def _stack(self) -> List[Optional[int]]:
        stack = getattr(self._tl, "stack", None)
        if stack is None:
            stack = self._tl.stack = []
        return stack

    def ambient_id(self) -> Optional[int]:
        """The current thread's innermost bound span id (None: unbound)."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def bind(self, span) -> "contextlib.AbstractContextManager":
        """Make ``span`` (a Span, an id, or None) the thread's ambient
        parent for the duration of the block."""
        span_id = span.span_id if isinstance(span, Span) else span
        stack = self._stack()
        stack.append(span_id)
        try:
            yield
        finally:
            stack.pop()

    # -- inspection -------------------------------------------------------------
    def find(self, name: str) -> List[Span]:
        """All spans with ``name`` (creation order)."""
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def children_of(self, span) -> List[Span]:
        span_id = span.span_id if isinstance(span, Span) else span
        with self._lock:
            return [s for s in self.spans if s.parent_id == span_id]

    def __len__(self) -> int:
        return len(self.spans)
