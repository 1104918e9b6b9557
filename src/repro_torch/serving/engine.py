"""Serving engine: variant registry + compatibility front over the loop.

The engine owns the two execution tiers:

* ``backend`` — the remote tier (:class:`repro_torch.serving.backend.JitBackend`
  by default): per-variant eager prefill/decode, real batched decoding.
* ``hedge_backend`` — the optional on-device tier
  (:class:`repro_torch.serving.backend.OnDeviceBackend`): a real tiny duplicate
  variant.  When present, hedged requests execute on *both* tiers and
  duplication resolves on measured wall time; when absent, the scheduler
  falls back to sampling its on-device latency profile (the simulator
  reference path).

Request scheduling/dispatch now lives in the event-loop layer
(:class:`repro_torch.serving.loop.ServingLoop`): admission →
``decide_batch`` → concurrent per-tier dispatch → hedged resolution.
:meth:`ServingEngine.serve_queue` survives as a thin compatibility shim —
one sync-collected tick of a ``ServingLoop`` over this engine's backends —
so the pre-loop equivalence references (``chunk_size=1``, sampled-hedge
simulation) keep holding verbatim.  New code should drive a
``ServingLoop`` (plus :class:`repro_torch.serving.client.InferenceClient`)
directly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.mdinference_zoo import SERVING_GEOMETRY
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.sla import RequestMetrics
from repro_torch.serving.backend import (
    ContinuousBatchingBackend,
    ExecutionBackend,
    JitBackend,
    OnDeviceBackend,
    Variant,
)
from repro_torch.serving.lifecycle import CompletedRequest, QueuedRequest

__all__ = ["Variant", "ServingEngine", "QueuedRequest", "CompletedRequest"]


class ServingEngine:
    def __init__(
        self,
        max_len: Optional[int] = None,
        backend: Optional[ExecutionBackend] = None,
        hedge_backend: Optional[OnDeviceBackend] = None,
        dispatch: str = "sync",
        continuous: bool = False,
        geometry=None,
        device: str = "cuda",
    ):
        # The engine is the *compatibility* surface, so it defaults to the
        # serialized reference behavior legacy callers measured against;
        # the new API (ServingLoop) defaults to async dispatch.
        # ``continuous=True`` swaps the remote tier for the
        # continuous-batching backend (fixed-shape entry points,
        # block-paged slot cache) and defaults dispatch to "stepped";
        # ``geometry`` (a ServingGeometry) then sizes its ladder and pool.
        # ``device`` places the default remote tier, dense or continuous
        # (CUDA unless asked).
        if backend is None:
            if continuous:
                backend = ContinuousBatchingBackend(
                    SERVING_GEOMETRY if geometry is None else geometry,
                    device=device,
                )
                if dispatch == "sync":
                    dispatch = "stepped"
            else:
                backend = JitBackend(max_len, device=device)
        self.backend = backend
        self.hedge_backend = hedge_backend
        self.dispatch = dispatch

    # -- thin delegation to the remote tier ----------------------------------
    @property
    def max_len(self):
        """The remote tier's sequence cap (owned by the backend)."""
        return getattr(self.backend, "max_len", None)

    @property
    def variants(self):
        return self.backend.variants

    def register(self, v: Variant):
        self.backend.register(v)

    def generate(self, name: str, tokens: np.ndarray, n_steps: int, greedy=True):
        """Real batched generation on the remote tier.  Returns
        (generated (B, n_steps), wall_ms)."""
        return self.backend.generate(name, tokens, n_steps)

    def make_loop(
        self,
        scheduler,
        dispatch: Optional[str] = None,
        admission=None,
        controller=None,
        observability=None,
    ):
        """Build a :class:`repro_torch.serving.loop.ServingLoop` over this
        engine's backends (the event-loop serving front).

        ``admission`` is an optional
        :class:`repro_torch.serving.admission.AdmissionConfig` — the bounded
        admission queue with overload policies; ``None`` keeps the
        unbounded compatibility behavior.  ``controller`` is an optional
        :class:`repro_torch.serving.controller.AdmissionController` closing the
        adaptive loop over that queue; ``None`` keeps the static config.
        ``observability`` is an optional
        :class:`repro_torch.observability.Observability` handle the loop
        threads through every layer; ``None`` keeps the stack untraced
        (the regression-pinned default).
        """
        from repro_torch.serving.loop import ServingLoop

        return ServingLoop(
            scheduler,
            self.backend,
            self.hedge_backend,
            dispatch=self.dispatch if dispatch is None else dispatch,
            admission=admission,
            controller=controller,
            observability=observability,
        )

    # -- compatibility shim over the event loop ------------------------------
    def serve_queue(
        self,
        scheduler,
        requests: Sequence[QueuedRequest],
        dispatch_ms: Optional[float] = None,
    ) -> Tuple[List[CompletedRequest], Optional[RequestMetrics]]:
        """Serve one chunk of queued requests with continuous batching.

        Thin shim: admits ``requests`` into a fresh
        :class:`repro_torch.serving.loop.ServingLoop` and collects exactly one
        tick at ``dispatch_ms`` (default: the chunk's latest arrival).  All
        semantics — one ``decide_batch`` call per chunk, per-variant
        ``generate`` batches with shared wall times, queue wait charged to
        both race clocks, measured-or-sampled hedge resolution — live in
        the loop now; this wrapper only preserves the historical
        batch-in/batch-out signature.  The engine's ``dispatch`` mode
        decides whether the tiers' batches run serialized ("sync", the
        default here — the deterministic reference legacy callers
        measured against) or overlap ("async").

        Returns ``(completions, metrics)`` with completions in the input
        order; ``metrics`` is None for an empty chunk.
        """
        if not requests:
            return [], None
        loop = self.make_loop(scheduler)
        for r in requests:
            loop.submit(r)
        result = loop.tick(now_ms=dispatch_ms)
        return result.completions, result.metrics

    def measure_profiles(
        self, prompt_len: int, gen_tokens: int, batch: int = 1, trials: int = 5,
        seed: int = 0,
    ) -> ModelRegistry:
        """Measure real wall-clock latency profiles (the paper's Table III
        methodology: repeated timed executions per model)."""
        profiles = [
            self.backend.measure_profile(
                name, prompt_len, gen_tokens, batch=batch, trials=trials,
                seed=seed,
            )
            for name in self.variants
        ]
        return ModelRegistry(sorted(profiles, key=lambda p: p.accuracy))
