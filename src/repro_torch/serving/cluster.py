"""Replica-pool surface the serving loop depends on.

Only :class:`NoHealthyReplica` is ported so far: the loop catches it when
a routing layer has no healthy replica for a variant.  The replica pool,
routers and :class:`ClusterBackend` of the JAX package are still to be
ported (ROADMAP.md, Queue A).
"""
from __future__ import annotations

__all__ = ["NoHealthyReplica"]


class NoHealthyReplica(RuntimeError):
    """Every replica hosting the variant is unroutable (breaker open,
    draining, or dead).  The serving loop diverts the affected rows to the
    on-device degrade lane instead of crashing the tick."""
