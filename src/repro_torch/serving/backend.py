"""Pluggable execution backends — the execution tier of the serving stack.

The policy half (:class:`repro_torch.serving.scheduler.MDInferenceScheduler`)
decides *which* variant answers a request; an :class:`ExecutionBackend`
owns *how* variants execute.  Two tiers ship:

* :class:`JitBackend` — the remote/server tier: per-variant prefill/decode
  run eagerly through the port's kernels, real batched greedy decoding.
* :class:`OnDeviceBackend` — the hedge tier: hosts exactly one real tiny
  variant (recipe from :data:`repro_torch.configs.mdinference_zoo.ONDEVICE_HEDGE`,
  the paper's MobileNetV1_128 0.25 duplicate, §V-B).  Hedged requests run
  here *for real*, so duplication resolves on measured wall time instead of
  a profile sample.

Both tiers share the continuous-batching cost model through
:meth:`ExecutionBackend.run_batch`: the first occurrence of each
(variant, batch-shape) runs an untimed warm-up, so the first-use costs (the
kernels' build and load, Triton's JIT, the allocator's first blocks) are
never charged to requests or folded into live latency profiles.

The continuous-batching tier (``ContinuousBatchingBackend``) is not ported
yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.mdinference_zoo import (
    ONDEVICE_HEDGE,
    SERVING_GEOMETRY,
    HedgeVariantSpec,
)
from repro_torch.core.registry import ModelProfile
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

__all__ = [
    "Variant",
    "BatchHandle",
    "ExecutionBackend",
    "JitBackend",
    "OnDeviceBackend",
    "build_hedge_variant",
]


@dataclasses.dataclass
class Variant:
    name: str
    cfg: ModelConfig
    params: dict
    quality: float  # A(m) for the selection algorithm


class BatchHandle:
    """One in-flight batch on an execution tier (async dispatch protocol).

    Returned by :meth:`ExecutionBackend.submit_batch`.  :meth:`poll` never
    blocks; :meth:`wait` blocks (optionally up to ``timeout`` seconds) and
    returns the same ``(generated, wall_ms)`` pair as
    :meth:`ExecutionBackend.run_batch`.

    Wall-clock bookkeeping for race accounting:

    * ``dispatch_wall_ms`` — ``perf_counter`` stamp when the batch was
      submitted.  Two tiers dispatched in the same scheduling tick differ
      by thread-submit overhead only — this is the race clocks' shared
      start, replacing the serialized remote-then-duplicate measurement.
    * ``done_wall_ms`` — stamp when execution (warm-up included) finished.

    ``replica`` / ``inflight_at_dispatch`` are stamped by a routing layer
    (:class:`repro_torch.serving.cluster.ClusterBackend`): which pool replica ran
    the batch and the replica's queue depth (rows, this batch included) at
    dispatch.  ``None`` on a plain single-backend handle.
    """

    def __init__(self, name: str, n_rows: int):
        self.name = name
        self.n_rows = n_rows
        self.dispatch_wall_ms = time.perf_counter() * 1e3
        self.done_wall_ms: Optional[float] = None
        self.replica: Optional[int] = None
        self.inflight_at_dispatch: Optional[int] = None

    def poll(self) -> bool:
        """Non-blocking: True once the batch result is ready."""
        raise NotImplementedError

    def wait(self, timeout: Optional[float] = None) -> Tuple[np.ndarray, float]:
        """Block until ready; returns ``(generated (B, n_steps), wall_ms)``."""
        raise NotImplementedError


class _CompletedBatchHandle(BatchHandle):
    """Sync-dispatch handle: the batch already ran inside ``submit_batch``."""

    def __init__(self, name, n_rows, dispatch_wall_ms, out, wall_ms):
        super().__init__(name, n_rows)
        self.dispatch_wall_ms = dispatch_wall_ms
        self.done_wall_ms = time.perf_counter() * 1e3
        self._result = (out, wall_ms)

    def poll(self) -> bool:
        return True

    def wait(self, timeout=None):
        return self._result


class _ThreadedBatchHandle(BatchHandle):
    """Async-dispatch handle: the batch runs on a worker thread.

    The worker executes the tier's warm-once-then-timed ``run_batch``, so
    the returned wall time keeps the same warm-up-free semantics as the
    synchronous path.  ``on_done(wall_ms | None)`` fires on the worker
    right when execution finishes (before the event is set) — the backend
    uses it to keep its inflight-row count and latency EWMA live.
    """

    def __init__(self, name, n_rows, fn, on_done=None):
        super().__init__(name, n_rows)
        self._done = threading.Event()
        self._result: Optional[Tuple[np.ndarray, float]] = None
        self._error: Optional[BaseException] = None

        def worker():
            try:
                self._result = fn()
            except BaseException as e:  # surfaced from wait()
                self._error = e
            finally:
                self.done_wall_ms = time.perf_counter() * 1e3
                if on_done is not None:
                    on_done(
                        self._result[1] if self._result is not None else None
                    )
                self._done.set()

        self._thread = threading.Thread(
            target=worker, name=f"batch-{name}", daemon=True
        )
        self._thread.start()

    def poll(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"batch on {self.name!r} unfinished after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


_STATS_EWMA = 0.25  # live per-backend wall-latency EWMA (routing signal)


class ExecutionBackend:
    """What the policy-facing engine needs from an execution tier.

    Concrete backends implement :meth:`register` and :meth:`generate`;
    :meth:`run_batch` (warm-once-then-timed) is shared.

    Every backend keeps live load accounting, maintained by
    :meth:`submit_batch` regardless of dispatch mode:

    * ``inflight_rows`` — rows dispatched but not yet finished executing.
    * ``dispatched_rows`` / ``completed_batches`` — cumulative counters.
    * ``ewma_wall_ms`` — EWMA of observed batch wall times (``None`` until
      the first completion).

    These are the routing signals a :class:`repro_torch.serving.cluster.ReplicaPool`
    reads per replica (join-shortest-queue, power-of-two-choices); on a
    single backend they are inert bookkeeping.
    """

    variants: Dict[str, Variant]

    def __init__(self):
        self.variants = {}
        self._warmed_shapes: set = set()
        self._stats_lock = threading.Lock()
        self.inflight_rows = 0
        self.dispatched_rows = 0
        self.completed_batches = 0
        self.ewma_wall_ms: Optional[float] = None
        # Optional repro_torch.observability.Observability handle + the trace
        # track this backend's spans land on (set by the cluster layer
        # with the replica's id, or by the loop for a single backend).
        self._obs = None
        self._obs_track: Optional[str] = None

    def attach_observability(self, obs, track: Optional[str] = None) -> None:
        """Wire this backend's dispatch path to a metrics+trace handle.

        Never attached (the default), every path is byte-identical to the
        uninstrumented backend.
        """
        self._obs = obs
        self._obs_track = track

    def _note_dispatch(self, n_rows: int) -> None:
        with self._stats_lock:
            self.inflight_rows += n_rows
            self.dispatched_rows += n_rows

    def _note_done(self, n_rows: int, wall_ms: Optional[float]) -> None:
        """Completion hook: drop the rows from inflight and fold the batch
        wall time into the live EWMA (``wall_ms=None``: execution raised —
        the rows still leave the inflight count)."""
        with self._stats_lock:
            self.inflight_rows -= n_rows
            if wall_ms is not None:
                self.completed_batches += 1
                self.ewma_wall_ms = (
                    float(wall_ms)
                    if self.ewma_wall_ms is None
                    else (1 - _STATS_EWMA) * self.ewma_wall_ms
                    + _STATS_EWMA * float(wall_ms)
                )

    def register(self, v: Variant) -> None:
        raise NotImplementedError

    def generate(
        self, name: str, tokens: np.ndarray, n_steps: int
    ) -> Tuple[np.ndarray, float]:
        """Run real generation; returns (generated (B, n_steps), wall_ms)."""
        raise NotImplementedError

    def run_batch(
        self, name: str, batch: np.ndarray, n_steps: int
    ) -> Tuple[np.ndarray, float]:
        """Timed ``generate`` with a one-time untimed warm-up per shape.

        The warm-up absorbs first-use costs (kernel build/load, Triton JIT)
        so the returned wall time is an honest execution measurement (safe
        to fold into EWMA profiles).
        """
        shape_key = (name, batch.shape[0], batch.shape[1], n_steps)
        if shape_key not in self._warmed_shapes:
            self.generate(name, batch, n_steps)  # warm-up, untimed
            self._warmed_shapes.add(shape_key)
        return self.generate(name, batch, n_steps)

    def submit_batch(
        self,
        name: str,
        batch: np.ndarray,
        n_steps: int,
        *,
        sync: bool = False,
        on_token=None,
    ) -> BatchHandle:
        """Dispatch a batch without waiting for it — the async protocol.

        With ``sync=False`` (the default) the batch runs on a worker thread
        and the returned :class:`BatchHandle` supports non-blocking
        :meth:`BatchHandle.poll`; batches submitted to *different* tiers in
        the same scheduling tick genuinely overlap.  ``sync=True`` executes
        inline before returning (a pre-completed handle) — the serialized
        fallback that keeps CI and the equivalence references deterministic.

        Either way the execution path is :meth:`run_batch`, so warm-up
        semantics and the measured wall time are identical across modes.

        ``on_token(row, token, wall_ms)`` is the streaming channel: a
        backend that decodes token-by-token calls it per emitted token
        (before the batch completes).  Whole-batch tiers have no per-token
        stream, so the base implementation ignores it; the serving loop
        only passes it to backends advertising ``supports_streaming``.
        """
        n_rows = int(batch.shape[0])
        self._note_dispatch(n_rows)
        if sync:
            dispatch_wall_ms = time.perf_counter() * 1e3
            try:
                out, wall_ms = self.run_batch(name, batch, n_steps)
            except BaseException:
                self._note_done(n_rows, None)
                raise
            self._note_done(n_rows, wall_ms)
            return _CompletedBatchHandle(
                name, n_rows, dispatch_wall_ms, out, wall_ms
            )
        run = lambda: self.run_batch(name, batch, n_steps)  # noqa: E731
        if self._obs is not None:
            # The handle's worker thread has no ambient span of its own;
            # capture the dispatching thread's (the loop's batch-group
            # span) and re-bind it so transport-level spans nest under it.
            tracer = self._obs.tracer
            ambient = tracer.ambient_id()

            def run(_inner=run):
                with tracer.bind(ambient):
                    return _inner()

        return _ThreadedBatchHandle(
            name,
            n_rows,
            run,
            on_done=lambda wall_ms: self._note_done(n_rows, wall_ms),
        )

    def measure_profile(
        self, name: str, prompt_len: int, gen_tokens: int, batch: int = 1,
        trials: int = 5, seed: int = 0,
    ) -> ModelProfile:
        """Measured latency profile of one variant (the paper's Table III
        methodology: untimed warm-up, then repeated timed executions)."""
        rng = np.random.default_rng(seed)
        v = self.variants[name]
        tokens = rng.integers(0, v.cfg.vocab_size, (batch, prompt_len))
        self.generate(name, tokens, 1)  # warm-up
        times = [
            self.generate(name, tokens, gen_tokens)[1] for _ in range(trials)
        ]
        return ModelProfile(
            name=v.name,
            accuracy=v.quality,
            mu_ms=float(np.mean(times)),
            sigma_ms=float(np.std(times) + 1e-3),
        )


class JitBackend(ExecutionBackend):
    """Per-variant prefill/decode on one device (the remote tier).

    Keeps the JAX package's name, but nothing is jitted: PyTorch runs
    eagerly, and the hot spots of the model are the port's hand-written
    kernels (on CUDA).  ``device`` defaults to ``"cuda"``; the CPU runs the
    plain versions only when asked for.  Each :meth:`generate` call runs on
    its own CUDA stream, so batches dispatched from different worker
    threads overlap on the card, and stops its clock only after that stream
    has finished (the measured wall time is execution, not launch).

    ``max_len`` defaults to :data:`~repro_torch.configs.mdinference_zoo.SERVING_GEOMETRY`
    — the zoo recipe is the single source of truth for cache geometry across
    all tiers (the historical hardcoded 256 lives there now).
    """

    def __init__(self, max_len: Optional[int] = None, device="cuda"):
        super().__init__()
        self.max_len = SERVING_GEOMETRY.max_len if max_len is None else max_len
        self.device = resolve_device(device)

    def register(self, v: Variant) -> None:
        T.check_supported(v.cfg)
        self.variants[v.name] = v

    def generate(self, name, tokens, n_steps, greedy=True):
        v = self.variants[name]
        tokens = np.asarray(tokens)
        B, S = tokens.shape
        if n_steps <= 0:
            return np.zeros((B, 0), dtype=np.int32), 0.0
        dev = self.device
        stream = None
        if dev.type == "cuda":
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))  # params are ready
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        with torch.inference_mode(), ctx:
            t0 = time.perf_counter()
            prompt = torch.as_tensor(tokens, dtype=torch.int64).to(dev)
            cache, logits = T.prefill(v.cfg, v.params, {"tokens": prompt}, max_len=self.max_len)
            # Every step's positions up front; tokens stay on the device.
            positions = (
                torch.arange(S, S + n_steps, dtype=torch.int32, device=dev)[:, None]
                .expand(n_steps, B).contiguous()
            )
            out = []
            tok = logits.argmax(-1)
            for i in range(n_steps):
                out.append(tok)
                logits, cache = T.decode_step(v.cfg, v.params, cache, tok, positions[i])
                tok = logits.argmax(-1)
            generated = torch.stack(out, dim=1).to(torch.int32)
            if stream is not None:
                stream.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return generated.cpu().numpy(), wall_ms


def build_hedge_variant(
    spec: HedgeVariantSpec = ONDEVICE_HEDGE, seed: int = 0, device="cuda"
) -> Variant:
    """Materialize the zoo's on-device hedge recipe as a real Variant."""
    cfg = spec.config()
    params = T.init_params(cfg, torch.Generator().manual_seed(seed), device)
    return Variant(spec.name, cfg, params, spec.quality)


class OnDeviceBackend(JitBackend):
    """The hedge tier: a single always-fast variant, executed for real.

    Mirrors the paper's on-device duplicate: one model, small enough to
    finish within any reasonable SLA.  :meth:`hedge` runs the duplicate
    batch and returns measured wall time — the primary input to
    :meth:`repro_torch.serving.scheduler.MDInferenceScheduler.resolve_chunk`.
    """

    def __init__(self, variant: Variant, max_len: Optional[int] = None,
                 device="cuda"):
        super().__init__(max_len, device=device)
        super().register(variant)
        self.hedge_name = variant.name

    @classmethod
    def from_zoo(
        cls,
        max_len: Optional[int] = None,
        seed: int = 0,
        spec: HedgeVariantSpec = ONDEVICE_HEDGE,
        device="cuda",
    ) -> "OnDeviceBackend":
        """Build the default hedge tier from the zoo's recipe."""
        dev = resolve_device(device)
        return cls(build_hedge_variant(spec, seed, dev), max_len=max_len, device=dev)

    def register(self, v: Variant) -> None:
        raise ValueError(
            "OnDeviceBackend hosts exactly one hedge variant "
            f"({self.hedge_name!r}); register remote variants on the "
            "primary backend instead"
        )

    def hedge(self, batch: np.ndarray, n_steps: int) -> Tuple[np.ndarray, float]:
        """Run the duplicate batch on the hedge variant (warm-once, timed)."""
        return self.run_batch(self.hedge_name, batch, n_steps)

    def submit_hedge(
        self, batch: np.ndarray, n_steps: int, *, sync: bool = False
    ) -> BatchHandle:
        """Dispatch the duplicate batch without waiting (async protocol)."""
        return self.submit_batch(self.hedge_name, batch, n_steps, sync=sync)

    def measure_profile(self, name=None, *args, **kwargs) -> ModelProfile:
        """Measured latency profile of the hedge variant (Table III style).

        Keeps the base ``measure_profile(name, ...)`` contract but makes
        the name optional — this tier hosts exactly one variant.  Seeds
        the scheduler's on-device prior; the live EWMA refines it from
        real hedge executions during serving.
        """
        return super().measure_profile(
            self.hedge_name if name is None else name, *args, **kwargs
        )
