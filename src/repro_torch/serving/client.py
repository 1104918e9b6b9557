"""Client layer of the serving stack: submit prompts, get futures back.

:class:`InferenceClient` is the application-facing surface over a
:class:`repro_torch.serving.loop.ServingLoop`.  ``submit`` admits one request
(assigning it a request id and an arrival timestamp on the loop clock) and
returns an :class:`repro_torch.serving.lifecycle.InferenceFuture` immediately;
the caller observes the request's state, cancels it, or blocks on
``result()`` — which drives the loop when the caller is single-threaded,
so the minimal usage is just::

    client = InferenceClient(loop)
    future = client.submit(prompt_tokens, n_steps=8)
    completed = future.result()        # ticks the loop until resolved

Batch-oriented callers keep submitting and fire ``loop.tick(now_ms)``
themselves (one tick per arrival window — what
:meth:`repro_torch.serving.loop.ServingLoop.drain_trace` automates).

When the loop runs a *bounded* admission queue
(:class:`repro_torch.serving.admission.AdmissionConfig`), ``submit`` is
backpressure-aware: under the ``block`` overload policy the returned
future may be *not yet admitted* (``future.admitted`` is False — it waits
in the overflow room until capacity frees), under ``shed`` it may come
back already REJECTED (``future.rejected()``; ``result()`` raises
:class:`repro_torch.serving.lifecycle.RequestRejected`), and under ``degrade``
it will be answered by the on-device tier alone.  ``wait_admission=True``
turns the block policy into classic blocking backpressure: ``submit``
drives the loop until the request actually holds a queue slot.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.serving.lifecycle import InferenceFuture, QueuedRequest
from repro_torch.serving.loop import ServingLoop

__all__ = ["InferenceClient"]


class InferenceClient:
    """Submit prompts to a serving loop; observe them as futures."""

    def __init__(self, loop: ServingLoop):
        self.loop = loop

    def submit(
        self,
        prompt: np.ndarray,
        n_steps: int,
        sla: Optional[float] = None,
        *,
        t_nw_est_ms: float = 0.0,
        t_nw_actual_ms: Optional[float] = None,
        arrival_ms: Optional[float] = None,
        wait_admission: bool = False,
        tenant: Optional[str] = None,
        priority: Optional[str] = None,
    ) -> InferenceFuture:
        """Submit one inference request to the loop's admission queue.

        Args:
          prompt: (S,) prompt tokens.
          n_steps: tokens to generate.
          sla: per-request SLA in ms (None: the scheduler's global SLA).
            Budgeting, hedged resolution, *and* deadline shedding race
            against this value.
          t_nw_est_ms: server-side estimate of the request's network time
            (what selection budgets against).
          t_nw_actual_ms: the realized network time (defaults to the
            estimate — a perfect estimator).
          arrival_ms: loop-clock arrival (defaults to the loop's ``now``).
          wait_admission: with a bounded queue and the ``block`` policy, a
            full queue parks the future un-admitted (``future.admitted``
            False) — the client-side backpressure signal.  ``True`` makes
            ``submit`` block instead: it drives the loop until the future
            holds a real queue slot (or reached a terminal state).  A
            single-threaded caller never deadlocks — each tick frees
            capacity that re-admits the overflow FIFO.
          tenant: tenancy lane name (None: the implicit "default" lane).
            With a tenancy-enabled admission queue the tag selects the
            request's weighted-fair lane and per-tenant capacity bound.
          priority: "interactive" | "batch" — overrides the tenant lane's
            configured priority class for this request (None: the lane's).
        """
        request = QueuedRequest(
            rid=self.loop.next_rid(),
            tokens=np.asarray(prompt, dtype=np.int32),
            n_steps=int(n_steps),
            t_nw_est_ms=float(t_nw_est_ms),
            t_nw_actual_ms=float(
                t_nw_est_ms if t_nw_actual_ms is None else t_nw_actual_ms
            ),
            arrival_ms=float(
                self.loop.now_ms if arrival_ms is None else arrival_ms
            ),
            sla_ms=None if sla is None else float(sla),
            tenant=tenant,
            priority=priority,
        )
        future = self.loop.submit(request)
        if wait_admission:
            while not (future.admitted or future.done()):
                if self.loop.tick() is None and not (
                    future.admitted or future.done()
                ):
                    # No forward progress possible without external events
                    # (e.g. in-flight ticks that must be polled elsewhere);
                    # hand the un-admitted future back to the caller.
                    break
        return future
