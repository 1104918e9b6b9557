"""Multi-tenant QoS: per-tenant lanes drained deficit-weighted-fair.

The admission stage (:class:`repro_torch.serving.admission.AdmissionQueue`) is a
single FIFO by default: one flooding tenant inflates every tenant's queue
wait, so the flood destroys the *interactive* tenants' p99 — exactly the
failure mode MDInference's SLA framing warns about for mixed traffic.
This module adds the isolation layer:

* :class:`TenantConfig` — one tenant's QoS contract: scheduling ``weight``,
  priority class (``"interactive"`` | ``"batch"``), an optional per-tenant
  ``max_pending`` bound (its private capacity slice), and ``burst_credit``
  (how many unused scheduling quanta an idle lane may bank).
* :class:`TenantLanes` — per-tenant FIFO lanes plus the drain policy:
  **strict priority** between classes (every queued interactive request is
  eligible before any batch request — batch traffic only soaks budget the
  interactive class left over) and **deficit round-robin** within a class
  (each non-empty lane earns ``weight`` quanta per round and spends whole
  requests against its accumulated deficit, giving long-run weighted-fair
  shares without starving low-weight lanes).

Requests carrying no tenant tag (``QueuedRequest.tenant is None``) — and
tags no configured lane matches — ride an implicit ``"default"`` lane
(weight 1.0, interactive), so a tenancy-enabled queue still serves
untagged traffic.

The deficit counter is the classic DRR formulation: a lane's deficit grows
by its weight each round it is non-empty, shrinks by one per request it
dequeues, and — when the lane empties — collapses to at most
``burst_credit`` (an idle lane cannot bank unbounded priority, only its
configured burst allowance).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.lifecycle import InferenceFuture, RequestState

__all__ = [
    "PRIORITY_CLASSES",
    "DEFAULT_TENANT",
    "TenantConfig",
    "TenantLanes",
    "parse_tenant_spec",
]

PRIORITY_CLASSES = ("interactive", "batch")

# Lane for untagged requests (QueuedRequest.tenant None) and unknown tags.
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's QoS contract in the admission stage."""

    name: str
    weight: float = 1.0  # DRR quanta earned per round (within its class)
    priority: str = "interactive"  # strict class: interactive preempts batch
    max_pending: Optional[int] = None  # per-tenant queue bound (None: global)
    burst_credit: float = 0.0  # quanta an idle lane may bank for its next burst

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"priority must be one of {PRIORITY_CLASSES}, "
                f"got {self.priority!r}"
            )
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1 or None, got {self.max_pending}"
            )
        if self.burst_credit < 0:
            raise ValueError(
                f"burst_credit must be >= 0, got {self.burst_credit}"
            )


class _Lane:
    """One tenant's FIFO queue plus its DRR deficit counter."""

    __slots__ = ("cfg", "q", "deficit")

    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.q: Deque[InferenceFuture] = deque()
        self.deficit = 0.0

    @property
    def n_queued(self) -> int:
        return sum(1 for f in self.q if f.state is RequestState.QUEUED)


class TenantLanes:
    """Per-tenant lanes + the strict-priority deficit-weighted-fair drain.

    Not thread-safe on its own — the owning
    :class:`~repro_torch.serving.admission.AdmissionQueue` serializes access
    under its lock, exactly as it does for its FIFO deques.
    """

    def __init__(self, tenants: Sequence[TenantConfig]):
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        self._lanes: Dict[str, _Lane] = {t.name: _Lane(t) for t in tenants}
        if DEFAULT_TENANT not in self._lanes:
            # Implicit lane for untagged / unknown-tag requests.
            self._lanes[DEFAULT_TENANT] = _Lane(TenantConfig(DEFAULT_TENANT))

    # -- routing ---------------------------------------------------------------
    def lane_of(self, future: InferenceFuture) -> _Lane:
        tag = future.request.tenant
        return self._lanes.get(
            DEFAULT_TENANT if tag is None else tag, self._lanes[DEFAULT_TENANT]
        )

    def name_of(self, future: InferenceFuture) -> str:
        return self.lane_of(future).cfg.name

    def resolve(self, future: InferenceFuture) -> _Lane:
        """Route a future to its lane and stamp its effective priority
        (an explicit per-request ``priority`` wins over the lane's)."""
        lane = self.lane_of(future)
        req_priority = future.request.priority
        future.priority = (
            lane.cfg.priority if req_priority is None else req_priority
        )
        return lane

    def config(self, name: str) -> TenantConfig:
        return self._lanes[name].cfg

    @property
    def names(self) -> List[str]:
        return list(self._lanes)

    # -- bookkeeping -----------------------------------------------------------
    def n_queued(self, name: Optional[str] = None) -> int:
        if name is not None:
            return self._lanes[name].n_queued
        return sum(lane.n_queued for lane in self._lanes.values())

    def depths(self) -> Dict[str, int]:
        """Per-lane queued depth (lane name -> count), for gauge export."""
        return {name: lane.n_queued for name, lane in self._lanes.items()}

    def all_queued(self) -> List[InferenceFuture]:
        return [f for lane in self._lanes.values() for f in lane.q]

    def append(self, lane: _Lane, future: InferenceFuture) -> None:
        lane.q.append(future)

    def append_front(self, future: InferenceFuture) -> None:
        """Requeue a lost-batch row at the *front* of its tenant's lane —
        the lane-local analogue of the FIFO's head re-insert."""
        self.lane_of(future).q.appendleft(future)

    def prune(self) -> None:
        """Drop futures that left QUEUED state (cancelled) from every lane."""
        for lane in self._lanes.values():
            if any(f.state is not RequestState.QUEUED for f in lane.q):
                kept = [f for f in lane.q if f.state is RequestState.QUEUED]
                lane.q.clear()
                lane.q.extend(kept)

    def discard(self, futures: List[InferenceFuture]) -> None:
        """Remove specific futures (the shed set) from their lanes."""
        doomed = {id(f) for f in futures}
        if not doomed:
            return
        for lane in self._lanes.values():
            if any(id(f) in doomed for f in lane.q):
                kept = [f for f in lane.q if id(f) not in doomed]
                lane.q.clear()
                lane.q.extend(kept)

    # -- the drain -------------------------------------------------------------
    def select(
        self, budget: Optional[int] = None, commit: bool = True
    ) -> List[InferenceFuture]:
        """Pick up to ``budget`` requests (None: everything queued).

        Strict priority between classes — the interactive lanes drain
        first, batch lanes spend only the leftover budget — and deficit
        round-robin by ``weight`` within a class.  ``commit=False`` is a
        pure peek: lane queues and deficits are left untouched (the shed
        clock uses it to ask "what *would* this take pick?").
        """
        total = sum(len(lane.q) for lane in self._lanes.values())
        cap = total if budget is None else min(int(budget), total)
        # name -> [queue, deficit]; commit mode mutates the live queues.
        state: Dict[str, list] = {
            name: [lane.q if commit else deque(lane.q), lane.deficit]
            for name, lane in self._lanes.items()
        }
        out: List[InferenceFuture] = []
        for cls in PRIORITY_CLASSES:
            if len(out) >= cap:
                break
            members = [
                name
                for name, lane in self._lanes.items()
                if lane.cfg.priority == cls
            ]
            out.extend(self._drr(members, state, cap - len(out)))
        if commit:
            for name, (_, deficit) in state.items():
                self._lanes[name].deficit = deficit
        return out

    def _drr(
        self, names: List[str], state: Dict[str, list], budget: int
    ) -> List[InferenceFuture]:
        out: List[InferenceFuture] = []
        active = deque(name for name in names if state[name][0])
        while active and len(out) < budget:
            name = active.popleft()
            cfg = self._lanes[name].cfg
            entry = state[name]
            entry[1] += cfg.weight  # this round's quantum
            take = min(int(entry[1]), budget - len(out), len(entry[0]))
            for _ in range(take):
                out.append(entry[0].popleft())
            entry[1] -= take
            if entry[0]:
                active.append(name)
            else:
                # An emptied lane banks at most its burst allowance.
                entry[1] = min(entry[1], cfg.burst_credit)
        return out


def parse_tenant_spec(spec: str) -> Tuple[TenantConfig, ...]:
    """Parse a CLI tenant spec: ``name[:weight[:class[:max_pending]]],...``

    Example: ``"ui:4:interactive,crawl:1:batch:32"``.
    """
    tenants = []
    for item in spec.split(","):
        parts = item.strip().split(":")
        if not parts[0]:
            raise ValueError(f"empty tenant name in spec {spec!r}")
        kw: dict = {"name": parts[0]}
        if len(parts) > 1 and parts[1]:
            kw["weight"] = float(parts[1])
        if len(parts) > 2 and parts[2]:
            kw["priority"] = parts[2]
        if len(parts) > 3 and parts[3]:
            kw["max_pending"] = int(parts[3])
        if len(parts) > 4:
            raise ValueError(f"too many fields in tenant spec item {item!r}")
        tenants.append(TenantConfig(**kw))
    return tuple(tenants)
