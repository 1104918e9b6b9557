"""Replicated execution cluster: sharded zoo slices + load-aware routing.

A single :class:`repro_torch.serving.backend.JitBackend` replica saturates
exactly when the admission queue starts shedding — the aggregate-accuracy
wins only hold if the chosen cloud model is actually served within budget
under load.  This module multiplies the backend seam horizontally:

* :class:`Replica` — one routable backend plus a live view of its load
  accounting (``inflight_rows``, cumulative ``dispatched_rows``, wall-time
  EWMA — maintained by :meth:`ExecutionBackend.submit_batch` itself) and
  its health (:class:`repro_torch.serving.health.ReplicaHealth`: circuit
  breaker + drain flag — membership is *dynamic*).
* :class:`ReplicaPool` — N replicas + zoo placement across their slices
  (the cluster's state half: registration, hosted masks, snapshots).
* :class:`Router` — pluggable routing policy over the *eligible* replica
  set (:data:`ROUTERS`): ``round_robin`` (stateless cycling),
  ``least_inflight`` (join-shortest-queue over per-replica inflight rows,
  cumulative-work tie-break so serialized dispatch still balances), and
  ``power_of_two`` (two random replicas, pick by live wall-latency EWMA).
* :class:`ClusterBackend` — fronts a pool of N replicas behind the
  existing ``submit_batch -> BatchHandle`` protocol, so the serving loop
  and admission stages need no semantic changes.  Each replica may host a
  *slice* of the model zoo (:func:`shard_slices`); ``register`` places a
  variant on every admitting replica and routing never sends a row to a
  replica that doesn't host its variant.

Placement-aware selection: :meth:`ClusterBackend.hosted_mask` tells the
scheduler which variants have at least one live *routable* replica —
``MDInferenceScheduler.decide_batch(..., eligible=...)`` masks the rest
out, so a partial slice set (or a partially-failed pool) constrains
selection instead of crashing dispatch.  The mask is recomputed against
the loop clock every tick (:meth:`ClusterBackend.advance_clock`), so a
replica whose breaker opens leaves eligibility the *same tick*, and one
whose cooldown elapses re-enters it.

Fault handling: :meth:`ClusterBackend.submit_batch` converts a
:class:`repro_torch.serving.transport.TransportError` raised at dispatch into a
:class:`repro_torch.serving.transport.FailedBatchHandle` (the loop requeues or
hedge-fails-over those rows — a tick never crashes on a dead replica),
and the loop reports batch outcomes back through :meth:`note_success` /
:meth:`note_failure` to drive each replica's breaker.  When every hosting
replica is unroutable, :meth:`route` raises the typed
:class:`NoHealthyReplica` (never a bare ``ZeroDivisionError`` /
``IndexError`` from a router over an empty set).

The hedge tier is deliberately *not* poolable: the paper's on-device
duplicate is a device-side singleton, so an
:class:`~repro_torch.serving.backend.OnDeviceBackend` is rejected as a replica.

A one-replica pool under ``round_robin`` is behaviorally identical to the
plain single-backend loop (pinned in ``tests/test_torch_cluster.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.backend import (
    BatchHandle,
    ExecutionBackend,
    OnDeviceBackend,
    Variant,
)
from repro_torch.serving.health import BreakerConfig, CircuitBreaker, ReplicaHealth
from repro_torch.serving.transport import (
    FailedBatchHandle,
    ReplicaDied,
    TransportError,
)

__all__ = [
    "ROUTERS",
    "NoHealthyReplica",
    "Replica",
    "ReplicaSpec",
    "parse_replica_specs",
    "ReplicaPool",
    "Router",
    "RoundRobinRouter",
    "LeastInflightRouter",
    "PowerOfTwoRouter",
    "make_router",
    "shard_slices",
    "ClusterBackend",
]


class NoHealthyReplica(RuntimeError):
    """Every replica hosting the variant is unroutable (breaker open,
    draining, or dead).  The serving loop diverts the affected rows to the
    on-device degrade lane instead of crashing the tick."""


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """Per-replica hardware shape for a *heterogeneous* pool.

    Real fleets (llm-farm-style phone farms, mixed accelerator
    generations) are not homogeneous; the spec tells routing how unequal
    a replica is:

    * ``weight`` — relative serving capacity.  Load-aware routers divide
      a replica's inflight/dispatched rows by its weight, so a weight-2
      replica is expected to carry 2x the rows of a weight-1 one before
      looking equally loaded.
    * ``max_concurrency`` — a soft inflight-row cap: a replica at or
      above it is skipped by routing while any eligible peer has
      capacity (it never becomes *unroutable* — when every peer is full
      the pick proceeds over the full eligible set, so saturation is
      back-pressure, not an outage).
    * ``service_scale`` — relative service-time multiplier (1.0 =
      nominal, 2.0 = half-speed silicon).  Routing does not consume it
      directly — the live ``ewma_wall_ms`` measures actual slowness —
      but service models (``drain_trace`` coupling, benches) charge
      ``rows * service_scale`` so a slow replica's makespan is honest.

    The default spec (weight 1, no cap, scale 1) on every replica is the
    homogeneous pool, byte-identical to the pre-spec cluster
    (pinned in ``tests/test_torch_cluster.py``).
    """

    weight: float = 1.0
    max_concurrency: Optional[int] = None
    service_scale: float = 1.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_concurrency is not None and self.max_concurrency < 1:
            raise ValueError(
                f"max_concurrency must be >= 1 or None, got "
                f"{self.max_concurrency}"
            )
        if self.service_scale <= 0:
            raise ValueError(
                f"service_scale must be > 0, got {self.service_scale}"
            )


def parse_replica_specs(text: str, n_replicas: int) -> List[ReplicaSpec]:
    """Parse a CLI fleet description into per-replica specs.

    ``text`` is comma-separated, one ``weight[:max_concurrency[:scale]]``
    entry per replica (empty fields keep the default), e.g.
    ``"2:8:0.5,1,1::2"`` — a weight-2 replica capped at 8 inflight rows
    at double speed, a nominal replica, and a half-speed replica.
    """
    entries = [e.strip() for e in text.split(",")]
    if len(entries) != n_replicas:
        raise ValueError(
            f"--replica-spec names {len(entries)} replicas but the pool "
            f"has {n_replicas}"
        )
    specs = []
    for entry in entries:
        parts = entry.split(":")
        if len(parts) > 3:
            raise ValueError(
                f"replica spec entry {entry!r} has more than "
                "weight:max_concurrency:service_scale"
            )
        parts += [""] * (3 - len(parts))
        specs.append(
            ReplicaSpec(
                weight=float(parts[0]) if parts[0] else 1.0,
                max_concurrency=int(parts[1]) if parts[1] else None,
                service_scale=float(parts[2]) if parts[2] else 1.0,
            )
        )
    return specs


class Replica:
    """One routable backend replica in a pool.

    ``slice_names`` is the subset of the zoo this replica *admits* at
    registration (``None``: everything — full replication).  What it
    actually *hosts* is its backend's variant registry — the source of
    truth routing consults.  ``health`` is the replica's routability
    state (circuit breaker + drain flag); a replica can *host* a variant
    yet be unroutable this tick.  ``spec`` is the replica's hardware
    shape (:class:`ReplicaSpec`) — the default is the homogeneous
    nominal replica.
    """

    def __init__(
        self,
        replica_id: int,
        backend: ExecutionBackend,
        slice_names: Optional[Sequence[str]] = None,
        breaker: Optional[BreakerConfig] = None,
        spec: Optional[ReplicaSpec] = None,
    ):
        self.replica_id = replica_id
        self.backend = backend
        self.slice_names = (
            None if slice_names is None else frozenset(slice_names)
        )
        self.health = ReplicaHealth(
            None if breaker is None else CircuitBreaker(breaker)
        )
        self.spec = spec if spec is not None else ReplicaSpec()

    def admits(self, name: str) -> bool:
        """Whether registration may place variant ``name`` here."""
        return self.slice_names is None or name in self.slice_names

    def hosts(self, name: str) -> bool:
        """Whether this replica can execute variant ``name`` right now."""
        return name in self.backend.variants

    def routable(self, now_ms: float) -> bool:
        """Whether routing may send a batch here at ``now_ms`` (breaker
        closed or probing, not draining)."""
        return self.health.routable(now_ms)

    # Live load/latency accounting (maintained by the backend itself).
    @property
    def inflight_rows(self) -> int:
        return self.backend.inflight_rows

    @property
    def dispatched_rows(self) -> int:
        return self.backend.dispatched_rows

    @property
    def ewma_wall_ms(self) -> Optional[float]:
        return self.backend.ewma_wall_ms

    # Heterogeneity (spec-derived; nominal defaults on every replica).
    @property
    def weight(self) -> float:
        return self.spec.weight

    @property
    def service_scale(self) -> float:
        return self.spec.service_scale

    @property
    def has_capacity(self) -> bool:
        """Below the spec's soft inflight cap (always True uncapped)."""
        cap = self.spec.max_concurrency
        return cap is None or self.inflight_rows < cap

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Replica({self.replica_id}, inflight={self.inflight_rows}, "
            f"hosts={sorted(self.backend.variants)})"
        )


class Router:
    """Routing policy: pick one replica from the eligible (hosting,
    routable) set.

    ``pick`` receives only replicas that host the batch's variant and are
    routable this tick, in ascending ``replica_id`` order.  The eligible
    set is dynamic — health transitions grow and shrink it between picks —
    and an empty set raises the typed :class:`NoHealthyReplica` (never a
    bare ``IndexError``/``ZeroDivisionError``).
    """

    name = "?"

    @staticmethod
    def _require_nonempty(eligible: Sequence[Replica]) -> None:
        if not eligible:
            raise NoHealthyReplica(
                "every replica in the eligible set is unroutable"
            )

    def pick(self, eligible: Sequence[Replica]) -> Replica:
        raise NotImplementedError


class RoundRobinRouter(Router):
    """Cycle over the eligible set, keyed on replica *identity* (load-blind).

    The rotation remembers the last-picked ``replica_id`` and takes the
    next-higher id present in today's eligible set (wrapping to the
    lowest).  A global ``counter % len(eligible)`` would skew the moment
    the set changes size between picks — e.g. a 3-replica pool shrinking
    to 2 makes ``counter % 2`` repeatedly skip one survivor — whereas the
    identity key stays fair under any interleaving of joins and leaves.
    """

    name = "round_robin"

    def __init__(self, seed: int = 0):
        self._last: Optional[int] = None  # replica_id of the previous pick

    def pick(self, eligible: Sequence[Replica]) -> Replica:
        self._require_nonempty(eligible)
        if self._last is None:
            choice = eligible[0]
        else:
            after = [r for r in eligible if r.replica_id > self._last]
            choice = after[0] if after else eligible[0]
        self._last = choice.replica_id
        return choice


class LeastInflightRouter(Router):
    """Join-shortest-queue over per-replica inflight-row accounting.

    Load is *weight-normalized* (``inflight_rows / weight``): in a
    heterogeneous pool a weight-2 replica absorbs 2x the rows of a
    weight-1 peer before looking equally loaded, so unequal hardware gets
    its proportional share instead of a blind even split.  Ties break on
    weight-normalized cumulative dispatched rows (least total work
    first), so serialized ``sync`` dispatch — where batches complete
    inline and inflight is 0 at every pick — still spreads load instead
    of pinning everything to replica 0; then on ``replica_id`` for
    determinism.  With the default weight 1 everywhere the keys equal
    the raw row counts — the homogeneous pool routes byte-identically.
    """

    name = "least_inflight"

    def __init__(self, seed: int = 0):
        pass

    def pick(self, eligible: Sequence[Replica]) -> Replica:
        self._require_nonempty(eligible)
        return min(
            eligible,
            key=lambda r: (
                r.inflight_rows / r.weight,
                r.dispatched_rows / r.weight,
                r.replica_id,
            ),
        )


class PowerOfTwoRouter(Router):
    """Power-of-two-choices: sample two replicas, keep the faster one.

    The comparison key is the live per-replica wall-latency EWMA (an
    unprobed replica counts as 0 so cold replicas get explored), then
    inflight rows, then ``replica_id``.  Sampling is seeded — routing is
    reproducible for a fixed request stream.

    Every ``probe_every``-th two-candidate pick takes the *less*-favored
    candidate instead: a replica whose EWMA got stuck high early would
    otherwise lose every pairing and never execute again, leaving its
    estimate permanently stale (latency-keyed p2c's classic starvation
    mode).  The bounded probe refreshes it, so a healthy replica with an
    unlucky early measurement rejoins the rotation.

    Because the EWMA dominates the key, consecutive picks (e.g. the
    sub-batches of one tick's fan-out) concentrate on the
    fastest-measured replica until its EWMA catches up — deliberate for
    a skewed pool (avoid the slow replica), load-blind for a homogeneous
    one.  Prefer ``least_inflight`` when within-tick spread matters more
    than latency skew.
    """

    name = "power_of_two"

    def __init__(self, seed: int = 0, probe_every: int = 16):
        if probe_every < 2:
            raise ValueError(f"probe_every must be >= 2, got {probe_every}")
        self.rng = np.random.default_rng(seed)
        self.probe_every = probe_every
        self._picks = 0

    @staticmethod
    def _key(r: Replica):
        # The EWMA already *measures* heterogeneity (a half-speed replica
        # reports 2x walls); the inflight tie-break is weight-normalized
        # so equal-EWMA candidates split proportionally to capacity.
        ewma = r.ewma_wall_ms
        return (
            0.0 if ewma is None else ewma,
            r.inflight_rows / r.weight,
            r.replica_id,
        )

    def pick(self, eligible: Sequence[Replica]) -> Replica:
        self._require_nonempty(eligible)
        if len(eligible) == 1:
            return eligible[0]
        i, j = self.rng.choice(len(eligible), size=2, replace=False)
        a, b = eligible[int(i)], eligible[int(j)]
        if self._key(a) > self._key(b):
            a, b = b, a  # a: favored, b: the probe candidate
        self._picks += 1
        return b if self._picks % self.probe_every == 0 else a


ROUTERS: Dict[str, Callable[..., Router]] = {
    RoundRobinRouter.name: RoundRobinRouter,
    LeastInflightRouter.name: LeastInflightRouter,
    PowerOfTwoRouter.name: PowerOfTwoRouter,
}


def make_router(name: str, seed: int = 0) -> Router:
    if name not in ROUTERS:
        raise ValueError(f"router must be one of {tuple(ROUTERS)}, got {name!r}")
    return ROUTERS[name](seed=seed)


def shard_slices(
    names: Sequence[str], n_replicas: int, overlap: int = 1
) -> List[List[str]]:
    """Round-robin zoo placement: variant ``i`` lands on ``overlap``
    consecutive replicas starting at ``i % n_replicas``.

    ``overlap=1`` gives disjoint slices (each variant on exactly one
    replica — the fully sharded zoo); ``overlap=n_replicas`` is full
    replication.  Every variant gets at least one replica, so the union
    always covers the zoo.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    if not 1 <= overlap <= n_replicas:
        raise ValueError(
            f"overlap must be in [1, {n_replicas}], got {overlap}"
        )
    slices: List[List[str]] = [[] for _ in range(n_replicas)]
    for i, name in enumerate(names):
        for o in range(overlap):
            slices[(i + o) % n_replicas].append(name)
    return slices


@dataclasses.dataclass(frozen=True)
class ReplicaSnapshot:
    """Point-in-time view of one replica's load accounting and health."""

    replica_id: int
    hosts: tuple
    inflight_rows: int
    dispatched_rows: int
    completed_batches: int
    ewma_wall_ms: Optional[float]
    # Health: breaker state machine + drain flag (see repro_torch.serving.health).
    health: str = "closed"  # closed | open | half_open
    reason: Optional[str] = None  # why the breaker tripped (open/half_open)
    open_until_ms: Optional[float] = None  # loop-clock; inf: permanent (kill)
    draining: bool = False
    # Hardware shape (heterogeneous pools; nominal defaults otherwise).
    weight: float = 1.0
    max_concurrency: Optional[int] = None
    service_scale: float = 1.0


class ReplicaPool:
    """N backend replicas + zoo placement (the cluster's state half).

    The pool owns the replicas, variant placement across their slices,
    and load observability; the *protocol* half —
    :class:`ClusterBackend` — fronts a pool behind the single-backend
    execution interface.  ``slices`` restricts which variants each
    replica admits (see :func:`shard_slices`); ``None`` replicates every
    variant everywhere.  ``specs`` gives each replica its hardware shape
    (:class:`ReplicaSpec` — weight / soft concurrency cap / service
    scale) for heterogeneous fleets; ``None`` keeps every replica
    nominal, byte-identical to the pre-spec pool.
    """

    def __init__(
        self,
        backends: Sequence[ExecutionBackend],
        slices: Optional[Sequence[Sequence[str]]] = None,
        breaker: Optional[BreakerConfig] = None,
        specs: Optional[Sequence[ReplicaSpec]] = None,
    ):
        if not backends:
            raise ValueError("a ReplicaPool needs at least one replica")
        for b in backends:
            if isinstance(b, OnDeviceBackend):
                raise ValueError(
                    "OnDeviceBackend is the device-side hedge singleton, "
                    "not a routable replica — pass it to the serving loop "
                    "as hedge_backend instead"
                )
            if isinstance(b, ClusterBackend):
                # A nested cluster would report inflight 0 / EWMA None to
                # the outer router (its accounting lives on its replicas),
                # silently defeating load-aware routing.
                raise ValueError(
                    "nested ClusterBackend replicas are not supported — "
                    "flatten the backends into one pool (multi-host "
                    "transport is the queued follow-on for hierarchy)"
                )
        if slices is not None and len(slices) != len(backends):
            raise ValueError(
                f"slices covers {len(slices)} replicas but the pool has "
                f"{len(backends)}"
            )
        if specs is not None and len(specs) != len(backends):
            raise ValueError(
                f"specs covers {len(specs)} replicas but the pool has "
                f"{len(backends)}"
            )
        self.replicas = [
            Replica(
                i,
                b,
                None if slices is None else slices[i],
                breaker,
                spec=None if specs is None else specs[i],
            )
            for i, b in enumerate(backends)
        ]

    def __len__(self) -> int:
        return len(self.replicas)

    def place(self, v: Variant) -> List[Replica]:
        """Register a variant on every admitting replica; fails loudly
        when no slice admits it (the union must cover the zoo)."""
        placed = [r for r in self.replicas if r.admits(v.name)]
        if not placed:
            raise ValueError(
                f"no replica slice admits variant {v.name!r} — every "
                "variant needs at least one replica (see shard_slices)"
            )
        for r in placed:
            r.backend.register(v)
        return placed

    def replicas_for(self, name: str) -> List[Replica]:
        """The hosting replica set for a variant (ascending replica_id),
        health-blind — placement truth, not routability."""
        return [r for r in self.replicas if r.hosts(name)]

    def routable_for(self, name: str, now_ms: float) -> List[Replica]:
        """The replicas a batch of ``name`` may be routed to *right now*
        (hosting, breaker closed or probing, not draining)."""
        return [r for r in self.replicas_for(name) if r.routable(now_ms)]

    def hosted_mask(
        self, names: Sequence[str], now_ms: Optional[float] = None
    ) -> np.ndarray:
        """Bool mask over ``names``: True where >= 1 replica can serve the
        variant — the scheduler's selection-eligibility input.

        With ``now_ms`` the mask is *membership-aware*: a variant whose
        every hosting replica is unroutable (breaker open, draining) is
        masked out the same tick the health transition happens.  Without
        it the mask is static placement only (the pre-health behavior).
        """
        if now_ms is None:
            live = self.replicas
        else:
            live = [r for r in self.replicas if r.routable(now_ms)]
        return np.asarray(
            [any(r.hosts(n) for r in live) for n in names], dtype=bool
        )

    def snapshot(self) -> List[ReplicaSnapshot]:
        """Per-replica load accounting (for logs / benches / soak tests)."""
        return [
            ReplicaSnapshot(
                replica_id=r.replica_id,
                hosts=tuple(sorted(r.backend.variants)),
                inflight_rows=r.inflight_rows,
                dispatched_rows=r.dispatched_rows,
                completed_batches=r.backend.completed_batches,
                ewma_wall_ms=r.ewma_wall_ms,
                health=r.health.breaker.state,
                reason=r.health.breaker.reason,
                open_until_ms=r.health.breaker.open_until_ms,
                draining=r.health.draining,
                weight=r.spec.weight,
                max_concurrency=r.spec.max_concurrency,
                service_scale=r.spec.service_scale,
            )
            for r in self.replicas
        ]


class ClusterBackend(ExecutionBackend):
    """A replica pool behind the single-backend execution protocol.

    ``submit_batch`` routes each batch to one hosting replica via the
    routing policy and stamps the returned handle with ``replica`` (the
    chosen replica id) and ``inflight_at_dispatch`` (the replica's queue
    depth in rows, this batch included) — the serving loop threads both
    onto :class:`repro_torch.serving.lifecycle.CompletedRequest`.

    Construct from raw backends (a :class:`ReplicaPool` is built for you)
    or pass a prebuilt pool.  Routing never considers a replica that
    doesn't host the batch's variant.
    """

    def __init__(
        self,
        backends: Sequence[ExecutionBackend] | ReplicaPool,
        *,
        router: str | Router = "round_robin",
        slices: Optional[Sequence[Sequence[str]]] = None,
        seed: int = 0,
        breaker: Optional[BreakerConfig] = None,
        specs: Optional[Sequence[ReplicaSpec]] = None,
    ):
        super().__init__()
        if isinstance(backends, ReplicaPool):
            if slices is not None or breaker is not None or specs is not None:
                raise ValueError(
                    "pass slices/breaker/specs to the ReplicaPool, not "
                    "the ClusterBackend"
                )
            self.pool = backends
        else:
            self.pool = ReplicaPool(
                backends, slices=slices, breaker=breaker, specs=specs
            )
        self.router = router if isinstance(router, Router) else make_router(
            router, seed=seed
        )
        # The cluster's view of the serving loop's clock (ms): breaker
        # cooldowns and routability are evaluated against this, so health
        # behavior is deterministic trace time, not wall time.
        self._now_ms = 0.0
        self._obs = None  # Observability handle; None keeps the bare path

    def attach_observability(self, obs, track: Optional[str] = None) -> None:
        """Propagate a metrics+trace handle through the pool: each
        replica's breaker and backend get it with the replica's trace
        track (``replica:<id>``), so worker spans and trip instants land
        on the right timeline row."""
        self._obs = obs
        for r in self.pool.replicas:
            rtrack = f"replica:{r.replica_id}"
            r.health.breaker.attach_observability(
                obs, track=rtrack, replica=str(r.replica_id)
            )
            attach = getattr(r.backend, "attach_observability", None)
            if attach is not None:
                attach(obs, track=rtrack)

    # -- membership clock -----------------------------------------------------
    def advance_clock(self, now_ms: float) -> None:
        """Feed the loop clock forward (ticks call this before routing);
        monotone — a stale caller never rewinds breaker cooldowns."""
        self._now_ms = max(self._now_ms, float(now_ms))

    @property
    def replicas(self) -> List[Replica]:
        return self.pool.replicas

    @property
    def n_replicas(self) -> int:
        return len(self.pool)

    @property
    def max_len(self):
        """The pool's sequence cap: the tightest across replicas (a
        heterogeneous pool caps at its most constrained member; on the
        homogeneous default every replica reports the same value)."""
        caps = [
            getattr(r.backend, "max_len", None) for r in self.pool.replicas
        ]
        caps = [c for c in caps if c is not None]
        return min(caps) if caps else None

    # -- placement ------------------------------------------------------------
    def register(self, v: Variant) -> None:
        self.pool.place(v)
        self.variants[v.name] = v

    def replicas_for(self, name: str) -> List[Replica]:
        return self.pool.replicas_for(name)

    def hosted_mask(self, names: Sequence[str]) -> np.ndarray:
        # Membership-aware: evaluated at the cluster clock, so the mask
        # tracks breaker/drain transitions tick-by-tick.
        return self.pool.hosted_mask(names, self._now_ms)

    def fan_out(self, name: str) -> int:
        """How many replicas a batch of this variant can spread across
        *this tick* (routable hosting replicas only)."""
        return max(1, len(self.pool.routable_for(name, self._now_ms)))

    # -- routing --------------------------------------------------------------
    def route(self, name: str) -> Replica:
        """Pick the replica that runs the next batch of variant ``name``.

        Distinguishes the two empty cases: *nothing hosts the variant* is
        a placement error (``ValueError`` — a registration bug), while
        *everything hosting it is unroutable* is an operational condition
        (:class:`NoHealthyReplica` — the loop degrades those rows).
        """
        hosting = self.pool.replicas_for(name)
        if not hosting:
            raise ValueError(
                f"no replica hosts variant {name!r} (slices: "
                f"{[sorted(r.backend.variants) for r in self.pool.replicas]})"
            )
        routable = [r for r in hosting if r.routable(self._now_ms)]
        # Soft concurrency cap: a replica at its spec's max_concurrency is
        # skipped while any routable peer has room — but when the whole
        # set is full, routing proceeds over it (saturation is
        # back-pressure, not an outage; NoHealthyReplica stays a pure
        # health signal).  Uncapped replicas (the default) always have
        # capacity, so the homogeneous pool routes byte-identically.
        eligible = [r for r in routable if r.has_capacity] or routable
        if not eligible:
            raise NoHealthyReplica(
                f"no healthy replica for variant {name!r}: "
                + "; ".join(
                    f"replica {r.replica_id} "
                    + (
                        "draining"
                        if r.health.draining
                        else f"{r.health.breaker.state}"
                        + (
                            f" ({r.health.breaker.reason})"
                            if r.health.breaker.reason
                            else ""
                        )
                    )
                    for r in hosting
                )
            )
        replica = self.router.pick(eligible)
        replica.health.breaker.on_dispatch(self._now_ms)
        return replica

    # -- health reporting (driven by the serving loop) ------------------------
    def note_success(self, replica_id: int) -> None:
        """A routed batch completed on ``replica_id``: feed its breaker
        (closes a half-open probe, resets the failure streak)."""
        self.replicas[replica_id].health.breaker.on_success(self._now_ms)

    def note_failure(
        self, replica_id: int, reason: str, *, fatal: bool = False
    ) -> None:
        """A routed batch was lost on ``replica_id``: feed its breaker
        (``fatal`` — worker death/timeout — trips immediately)."""
        self.replicas[replica_id].health.breaker.on_failure(
            self._now_ms, reason, fatal=fatal
        )

    # -- membership operations ------------------------------------------------
    def drain(self, replica_id: int) -> None:
        """Gracefully remove a replica from routing: nothing new is routed
        to it, in-flight batches finish normally (their completions still
        resolve), and :meth:`rejoin` restores it.  The loop requeues any
        rows a drain-then-death races out of."""
        self.replicas[replica_id].health.draining = True

    def rejoin(self, replica_id: int) -> None:
        """Bring a drained/tripped/killed replica back into routing:
        restarts a dead transport worker (when the backend supports it),
        then clears the drain flag and resets the breaker.  A process
        worker's restart returns once its registrations are acknowledged,
        so the replica becomes routable only when it is ready; if the
        restart raises, the replica stays out of routing."""
        r = self.replicas[replica_id]
        restart = getattr(r.backend, "restart", None)
        if restart is not None and not getattr(r.backend, "alive", True):
            restart()
        r.health.draining = False
        r.health.breaker.reset()

    def kill_replica(self, replica_id: int, reason: str = "killed") -> None:
        """Fault injection / hard removal: kill the replica's transport
        worker (when it has one) and trip its breaker *permanently* —
        only :meth:`rejoin` recovers it.  In-flight batches surface as
        :class:`~repro_torch.serving.transport.ReplicaDied` at collection and
        the loop requeues their rows."""
        r = self.replicas[replica_id]
        kill = getattr(r.backend, "kill", None)
        if kill is not None:
            kill(reason)
        r.health.breaker.trip(self._now_ms, reason, permanent=True)

    # -- the execution protocol, routed ---------------------------------------
    def submit_batch(
        self, name: str, batch: np.ndarray, n_steps: int, *, sync: bool = False
    ) -> BatchHandle:
        try:
            replica = self.route(name)
        except NoHealthyReplica:
            if self._obs is not None:
                self._obs.counter(
                    "cluster_no_healthy_total", variant=name
                ).inc()
            raise
        depth = replica.inflight_rows + int(batch.shape[0])
        if self._obs is not None:
            self._obs.counter(
                "cluster_dispatched_rows_total",
                replica=str(replica.replica_id),
            ).inc(int(batch.shape[0]))
            self._obs.gauge(
                "cluster_inflight_rows", replica=str(replica.replica_id)
            ).set(depth)
        try:
            handle = replica.backend.submit_batch(
                name, batch, n_steps, sync=sync
            )
        except TransportError as e:
            # Sync dispatch surfaces transport faults inline; the replica
            # backend already reconciled its inflight accounting
            # (_note_done ran before the raise), so only the breaker and
            # the handle are left to produce here.  The loop treats the
            # FailedBatchHandle like any other lost batch.
            self.note_failure(
                replica.replica_id, str(e), fatal=isinstance(e, ReplicaDied)
            )
            handle = FailedBatchHandle(name, int(batch.shape[0]), e)
        handle.replica = replica.replica_id
        handle.inflight_at_dispatch = depth
        return handle

    def generate(self, name, tokens, n_steps):
        return self.route(name).backend.generate(name, tokens, n_steps)

    def run_batch(self, name, batch, n_steps):
        # Delegate whole: each replica owns its warm-shape set, so the
        # first batch a replica sees of a shape absorbs its own compile.
        return self.route(name).backend.run_batch(name, batch, n_steps)

    def measure_profile(
        self, name, prompt_len, gen_tokens, batch=1, trials=5, seed=0
    ):
        # Pin the measurement to one hosting replica: rotating the router
        # between timed trials would charge each replica's one-time
        # compile to the profile.  (In a heterogeneous pool this is the
        # *nominal* profile; live ewma_wall_ms tracks real per-replica
        # speed.)
        return self.replicas_for(name)[0].backend.measure_profile(
            name, prompt_len, gen_tokens, batch=batch, trials=trials, seed=seed
        )

    # -- observability --------------------------------------------------------
    def snapshot(self) -> List[ReplicaSnapshot]:
        """Per-replica load accounting (for logs / benches / soak tests)."""
        return self.pool.snapshot()
