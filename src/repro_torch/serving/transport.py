"""Transport-layer surface the serving loop depends on.

Only the failure types are ported so far: :class:`TransportError`,
:class:`ReplicaDied` and the :class:`FailedBatchHandle` the loop builds
for a batch it already knows is lost.  The process-worker transport of
the JAX package is still to be ported (ROADMAP.md, Queue A).
"""
from __future__ import annotations

from repro_torch.serving.backend import BatchHandle

__all__ = ["TransportError", "ReplicaDied", "FailedBatchHandle"]


class TransportError(RuntimeError):
    """A batch was lost to the transport layer (never produced tokens)."""


class ReplicaDied(TransportError):
    """The replica's worker is gone — death, kill, or timeout.  Fatal to
    the circuit breaker (trips immediately)."""


class FailedBatchHandle(BatchHandle):
    """A handle for a batch the transport already knows is lost.

    ``poll`` is immediately True (there is nothing to wait for) and
    ``wait`` raises the stored :class:`TransportError` — the serving
    loop's collection path turns that into requeue/hedge-failover instead
    of tokens.
    """

    def __init__(self, name: str, n_rows: int, error: TransportError):
        super().__init__(name, n_rows)
        self.error = error

    def poll(self) -> bool:
        return True

    def wait(self, timeout=None):
        raise self.error
