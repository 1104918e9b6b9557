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

:class:`ContinuousBatchingBackend` is the continuous-batching remote tier:
fixed-shape prefill/graft/decode entry points over a block-paged KV pool,
requests joining the persistent decode batch at step boundaries.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.mdinference_zoo import (
    ONDEVICE_HEDGE,
    SERVING_GEOMETRY,
    HedgeVariantSpec,
    ServingGeometry,
)
from repro_torch.core.registry import ModelProfile
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.block_cache import BlockPagedSlotCache, NoFreeSlot

__all__ = [
    "Variant",
    "BatchHandle",
    "ExecutionBackend",
    "JitBackend",
    "OnDeviceBackend",
    "ContinuousBatchingBackend",
    "StreamSet",
    "device_streams",
    "build_hedge_variant",
]

class StreamSet:
    """Streams made on demand, each served by one long-lived worker thread.

    :meth:`run` hands ``fn(stream)`` to an idle worker and waits for it;
    when every worker is busy it first makes a new stream and its worker,
    so no call ever waits for a stream, two concurrent calls never share
    one, and every call on a stream runs on the same thread, hence under
    the same cuBLAS handle.  The set grows to the most calls in flight at
    once (one per tier chunk, the hedge and the degrade batch of each tick,
    over every tick still in flight) and never shrinks.  PyTorch keeps a
    cuBLAS workspace (~32 MiB on an H100) per (handle, stream) for the life
    of the process: a fresh stream per call, on each new thread's handle,
    grew that cache without bound; here it holds one workspace per stream.
    ``pairs`` collects the (handle, stream) pairs the calls report."""

    def __init__(self, make):
        self._make = make
        self.streams = []
        self.pairs: Set[Tuple[int, int]] = set()
        self._idle = []  # the job queues of idle workers
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.streams)

    def idle(self) -> int:
        with self._lock:
            return len(self._idle)

    def _new_worker(self):  # under the lock
        stream = self._make()
        jobs = queue.SimpleQueue()
        self.streams.append(stream)
        threading.Thread(target=self._serve, args=(stream, jobs),
                         name=f"stream-{len(self.streams) - 1}", daemon=True).start()
        return jobs

    def _serve(self, stream, jobs):
        while True:
            fn, out, done = jobs.get()
            try:
                result = (True, fn(stream))
            except BaseException as e:  # raised again in the caller's thread
                result = (False, e)
            # The call's closure (its backend, hence its weights) and its
            # result must not live on in this thread until the next call.
            fn = None
            out.append(result)
            result = out = None
            with self._lock:
                self._idle.append(jobs)  # idle again before the caller returns
            done.set()

    def run(self, fn):
        """``fn(stream)`` on a worker's stream; its result, or its error
        raised here."""
        with self._lock:
            jobs = self._idle.pop() if self._idle else self._new_worker()
        out, done = [], threading.Event()
        jobs.put((fn, out, done))
        done.wait()
        ok, value = out.pop()
        if ok:
            return value
        raise value


_STREAM_SETS: Dict[int, StreamSet] = {}
_STREAM_SETS_LOCK = threading.Lock()


def device_streams(device) -> StreamSet:
    """The CUDA device's :class:`StreamSet`, shared by every backend on it."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    with _STREAM_SETS_LOCK:
        streams = _STREAM_SETS.get(index)
        if streams is None:
            streams = _STREAM_SETS[index] = StreamSet(
                lambda: torch.cuda.Stream(device=index))
        return streams


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
    an idle stream of the device's :class:`StreamSet`, by itself, so
    batches dispatched from different worker threads overlap on the card.
    Its clock starts when the call is made, hand-off to the stream's
    worker included, and stops only after that stream has finished (the
    measured wall time is execution, not launch).

    ``max_len`` defaults to :data:`~repro_torch.configs.mdinference_zoo.SERVING_GEOMETRY`
    — the zoo recipe is the single source of truth for cache geometry across
    all tiers (the historical hardcoded 256 lives there now).
    """

    def __init__(self, max_len: Optional[int] = None, device="cuda"):
        super().__init__()
        self.max_len = SERVING_GEOMETRY.max_len if max_len is None else max_len
        self.device = resolve_device(device)

    def register(self, v: Variant) -> None:
        T.check_supported(v.cfg, self.device, decode=True)
        self.variants[v.name] = v

    def generate(self, name, tokens, n_steps, greedy=True):
        v = self.variants[name]
        tokens = np.asarray(tokens)
        B, S = tokens.shape
        if n_steps <= 0:
            return np.zeros((B, 0), dtype=np.int32), 0.0
        dev = self.device
        t0 = time.perf_counter()
        if dev.type != "cuda":
            return self._generate(v, tokens, n_steps, None, t0)
        streams = device_streams(dev)
        ready = torch.cuda.current_stream(dev)  # the params were made there

        def on_stream(stream):
            stream.wait_stream(ready)
            with torch.cuda.stream(stream):
                streams.pairs.add((torch.cuda.current_blas_handle(), stream.cuda_stream))
                return self._generate(v, tokens, n_steps, stream, t0)

        return streams.run(on_stream)

    def _generate(self, v, tokens, n_steps, stream, t0):
        B, S = tokens.shape
        dev = self.device
        with torch.inference_mode():
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


# ---------------------------------------------------------------------------
# Continuous batching.
# ---------------------------------------------------------------------------
class _ContinuousBatchHandle(BatchHandle):
    """Handle over rows living inside the persistent decode batch.

    Rows complete *individually* — each occupies a slot of the continuous
    batch until it emits ``n_steps`` tokens (or is released early via
    :meth:`release_rows`: hedge win / cancel).  :meth:`poll` is passive;
    :meth:`wait` pumps the backend's decode loop until every row is done.

    ``ttft_wall_ms[i]`` is row *i*'s time-to-first-token: prefill + graft
    latency from submit, stamped the moment its first token exists — the
    quantity continuous batching exists to shrink (a joining request no
    longer waits for the in-flight batch to finish).
    """

    def __init__(self, backend, name: str, n_rows: int, n_steps: int):
        super().__init__(name, n_rows)
        self._backend = backend
        self.n_steps = n_steps
        self.row_slots: list = [None] * n_rows  # slot index while in-flight
        self.emitted: list = [[] for _ in range(n_rows)]
        self.done_rows = [False] * n_rows
        self.released_rows: Dict[int, str] = {}  # row -> release reason
        self.ttft_wall_ms: list = [None] * n_rows
        self._wall_ms: Optional[float] = None
        # Streaming channel: called as on_token(row, token, wall_ms) the
        # moment a token is appended to ``emitted`` — same wall stamp as
        # the TTFT accounting, so chunk timestamps and ttft_ms agree.
        self.on_token = None

    @property
    def all_done(self) -> bool:
        return all(self.done_rows)

    def poll(self) -> bool:
        return self.all_done

    def result(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_steps), dtype=np.int32)
        for i, toks in enumerate(self.emitted):
            if toks:
                out[i, : len(toks)] = toks[: self.n_steps]
        return out

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.perf_counter() + timeout
        while not self.all_done:
            if deadline is not None and time.perf_counter() > deadline:
                raise TimeoutError(
                    f"continuous batch on {self.name!r} unfinished "
                    f"after {timeout}s"
                )
            if not self._backend.pump(self.name):
                raise RuntimeError(
                    f"continuous batch on {self.name!r} stalled: "
                    "no active slots but rows incomplete"
                )
        assert self._wall_ms is not None
        return self.result(), self._wall_ms

    def release_rows(self, rows, reason: str) -> None:
        """Free the slots of still-running rows early (hedge win / cancel).

        The freed pages return to the pool immediately — the next join
        reuses them.  Released rows keep whatever tokens they emitted."""
        self._backend._release_handle_rows(self, rows, reason)


@dataclasses.dataclass
class _SlotRuntime:
    """Host-side state of one occupied decode slot."""

    handle: _ContinuousBatchHandle
    row: int  # row index within the handle
    tok: int  # last emitted token (next decode input)
    pos: int  # its absolute position (== tokens fed so far)


class _ContinuousEngine:
    """Per-variant fixed-shape entry points, the page pool and slot bookkeeping.

    The entry points run eagerly (no compiler); ``signatures`` records each
    distinct (entry point, input shapes) pair that has run — the port's
    analogue of the JAX engine's jit-cache entries.  After warmup it holds
    one prefill and one graft per ladder rung and the one decode shape.
    """

    def __init__(self, variant: Variant, geometry: ServingGeometry, device):
        cfg = variant.cfg
        if not T.supports_paged_decode(cfg):
            raise ValueError(
                f"variant {variant.name!r} cannot run on the continuous "
                "tier (needs a causal attention-only stack without kv "
                "quantization)"
            )
        self.variant = variant
        self.geometry = geometry
        self.device = device
        g = geometry
        self.cache_mgr = BlockPagedSlotCache(
            g.n_slots, g.total_pages, g.page_size, g.pages_per_slot
        )
        self.pool = T.init_paged_cache(cfg, g.total_pages, g.page_size, device=device)
        self.slot_rt: Dict[int, _SlotRuntime] = {}
        self.warmed = False
        self.signatures: Set[tuple] = set()

    def _to_device(self, *arrays: np.ndarray):
        """The int32 host arrays as device tensors, in one transfer."""
        flat = np.concatenate([np.asarray(a, np.int32).ravel() for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, at = [], 0
        for a in arrays:
            n = int(np.size(a))
            out.append(dev[at:at + n].view(np.shape(a)))
            at += n
        return out

    def prefill(self, tokens: np.ndarray, lengths: np.ndarray):
        """(N, prompt_width) right-padded tokens -> (dense cache, first
        greedy tokens (N,) int32 on the host)."""
        self.signatures.add(("prefill", tokens.shape, lengths.shape))
        toks, lens = self._to_device(tokens, lengths)
        with torch.inference_mode():
            cache, logits = T.prefill_ragged(
                self.variant.cfg, self.variant.params, {"tokens": toks}, lens,
                max_len=self.geometry.prompt_width,
            )
            return cache, logits.argmax(-1).to(torch.int32).cpu().numpy()

    def graft(self, prefill_cache, tables: np.ndarray) -> None:
        """All rows of a prefill chunk into their pages (padded rows through
        all-trash tables), one ``index_copy_`` per leaf, in place."""
        self.signatures.add(("graft", T.prefill_cache_width(prefill_cache), tables.shape))
        (tbl,) = self._to_device(tables)
        with torch.inference_mode():
            T.graft_prefill_batch(self.variant.cfg, self.pool, prefill_cache, tbl,
                                  self.geometry.page_size)

    def decode(self, tables: np.ndarray, token: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One step of the persistent (n_slots)-row batch: the page tables,
        tokens and positions go to the device in one transfer; returns the
        next greedy tokens (n_slots,) int32 on the host."""
        self.signatures.add(("decode", tables.shape, token.shape, pos.shape))
        tbl, tok, ps = self._to_device(tables, token, pos)
        with torch.inference_mode():
            logits, _ = T.paged_decode_step(
                self.variant.cfg, self.variant.params, self.pool, tbl, tok, ps,
                self.geometry.page_size,
            )
            return logits.argmax(-1).to(torch.int32).cpu().numpy()

    @property
    def compile_count(self) -> int:
        return len(self.signatures)


class ContinuousBatchingBackend(ExecutionBackend):
    """Cross-tick continuous batching behind fixed-shape entry points.

    The phase split: **prefill** runs out-of-band at submit time at one of
    the per-batch-size shapes (``bs_ladder`` powers of two, partial chunks
    padded with masked rows), the resulting KV state is **grafted** into a
    free slot of the block-paged pool, and the request then rides the
    single persistent fixed-shape **decode** step — joining the in-flight
    batch at the next step boundary instead of waiting for it to finish.
    Slots recycle the moment a row resolves (``n_steps`` reached, hedge
    win, cancel), so the decode batch composition changes every step while
    its *shape* never does: after :meth:`warmup`, :attr:`compile_count`
    (distinct entry-point shapes run) never grows.

    The pools live on ``device`` (``"cuda"`` unless asked) and are updated
    in place; the decode attention runs through the hand-written paged
    kernel there.

    Dispatch modes: ``submit_batch(sync=True)`` drives the engine inline to
    completion; ``sync=False`` is **stepped** — prefill + graft happen at
    submit (stamping per-row TTFT), decode advances one step per
    :meth:`pump` call.  No worker threads: deterministic under CI, and the
    serving loop's ``poll()`` becomes the step clock.
    """

    # The serving loop skips its power-of-two row padding: submissions are
    # decomposed onto the bs ladder here, so loop-side padding would just
    # burn decode slots on phantom rows.
    pads_internally = True
    # Token-by-token decode: the loop may pass submit_batch an on_token
    # callback, fired per emitted token before the row resolves.
    supports_streaming = True

    def __init__(self, geometry: ServingGeometry = SERVING_GEOMETRY, device="cuda"):
        super().__init__()
        self.geometry = geometry
        self.device = resolve_device(device)
        self._engines: Dict[str, _ContinuousEngine] = {}

    # -- registration / warmup ------------------------------------------------
    def register(self, v: Variant) -> None:
        T.check_supported(v.cfg, self.device, decode=True)
        self.variants[v.name] = v
        self._engines[v.name] = _ContinuousEngine(v, self.geometry, self.device)
        if self._obs is not None:
            self._engines[v.name].cache_mgr.attach_observability(
                self._obs, variant=v.name
            )

    def attach_observability(self, obs, track: Optional[str] = None) -> None:
        super().attach_observability(obs, track)
        # The slot ledger emits graft/free counters and free-capacity
        # gauges; engines registered later attach in register().
        for nm, eng in self._engines.items():
            eng.cache_mgr.attach_observability(obs, variant=nm)

    def warmup(self, name: Optional[str] = None) -> None:
        """Run every fixed-shape entry point once (idempotent).

        One prefill + graft per ladder batch size, one decode step.  After
        this, :attr:`compile_count` must never grow — the regression gate
        the tests assert."""
        names = [name] if name is not None else list(self._engines)
        for nm in names:
            eng = self._engines[nm]
            if eng.warmed:
                continue
            g = self.geometry
            for N in g.bs_ladder:
                toks = np.zeros((N, g.prompt_width), np.int32)
                lens = np.full((N,), g.prompt_width, np.int32)
                pcache, _ = eng.prefill(toks, lens)
                # Graft through all-trash tables: every write lands in the
                # reserved trash page, so live slots are untouched.
                eng.graft(pcache, np.zeros((N, g.pages_per_slot), np.int32))
            zeros = np.zeros((g.n_slots,), np.int32)
            eng.decode(np.zeros((g.n_slots, g.pages_per_slot), np.int32), zeros, zeros)
            eng.warmed = True

    @property
    def compile_count(self) -> int:
        """Distinct (entry point, input shapes) signatures run, over every
        engine.  Constant after :meth:`warmup` — the 'zero post-warmup
        recompiles' counter the tests and the chip smoke assert on."""
        return sum(e.compile_count for e in self._engines.values())

    @property
    def joined_total(self) -> int:
        """Requests grafted into the continuous batch (lifetime)."""
        return sum(e.cache_mgr.grafted_total for e in self._engines.values())

    @property
    def recycled_total(self) -> int:
        """Slots freed back to the pool (lifetime, all release reasons)."""
        return sum(e.cache_mgr.freed_total for e in self._engines.values())

    def slot_stats(self, name: str) -> Dict[str, int]:
        return self._engines[name].cache_mgr.stats()

    def check_conservation(self) -> None:
        for eng in self._engines.values():
            eng.cache_mgr.check_conservation()

    # -- submission -----------------------------------------------------------
    def _ladder_chunks(self, n: int):
        """Decompose ``n`` rows into ladder batch sizes (largest-first).

        Remainders below the smallest rung are padded up to it with masked
        rows — never a new shape."""
        ladder = self.geometry.bs_ladder
        out = []
        left = n
        while left > 0:
            fit = [N for N in ladder if N <= left]
            N = max(fit) if fit else ladder[0]
            out.append((N, min(N, left)))  # (padded size, real rows)
            left -= min(N, left)
        return out

    def _acquire_slot(self, eng: _ContinuousEngine, prompt_len: int,
                      n_steps: int):
        """Claim a slot + pages, pumping the decode loop until one frees."""
        while True:
            try:
                return eng.cache_mgr.begin_prefill(prompt_len, n_steps)
            except NoFreeSlot:
                if not eng.slot_rt:
                    raise  # nothing in flight can ever free capacity
                self._pump_engine(eng)

    def submit_batch(
        self, name, batch, n_steps, *, sync: bool = False, on_token=None
    ):
        """Join ``batch`` rows into the continuous decode batch.

        ``sync=True`` runs the engine inline until every row completes.
        ``sync=False`` ('stepped'): prefill + graft happen now — TTFT is
        paid immediately, not at batch end — and decode advances via
        :meth:`pump` (the serving loop's ``poll()`` drives it).

        ``on_token(row, token, wall_ms)`` fires per emitted token — the
        first token at graft (the same wall stamp as ``ttft_wall_ms``),
        every later token from the decode pump — always *before* the row
        completes, under both dispatch modes."""
        g = self.geometry
        eng = self._engines[name]
        batch = np.asarray(batch, dtype=np.int32)
        B, S = batch.shape
        if S > g.prompt_width:
            raise ValueError(
                f"prompt width {S} exceeds ServingGeometry.prompt_width "
                f"({g.prompt_width})"
            )
        n_steps = int(n_steps)
        if n_steps > g.max_steps:
            raise ValueError(
                f"n_steps {n_steps} exceeds ServingGeometry.max_steps "
                f"({g.max_steps})"
            )
        self.warmup(name)
        self._note_dispatch(B)
        handle = _ContinuousBatchHandle(self, name, B, max(n_steps, 0))
        handle.on_token = on_token
        if n_steps <= 0:
            for i in range(B):
                handle.done_rows[i] = True
            self._finalize_handle(handle)
            return handle

        wide = np.zeros((B, g.prompt_width), dtype=np.int32)
        wide[:, :S] = batch
        row0 = 0
        for N, n_real in self._ladder_chunks(B):
            chunk = np.zeros((N, g.prompt_width), dtype=np.int32)
            chunk[:n_real] = wide[row0 : row0 + n_real]
            lengths = np.full((N,), S, dtype=np.int32)
            slots = [
                self._acquire_slot(eng, S, n_steps) for _ in range(n_real)
            ]
            pcache, first = eng.prefill(chunk, lengths)
            # One batched graft for the whole chunk: real rows through
            # their slots' tables, padded rows through all-trash tables.
            tables = np.zeros((N, g.pages_per_slot), dtype=np.int32)
            for r, slot in enumerate(slots):
                tables[r] = eng.cache_mgr.page_table(slot.index)
            eng.graft(pcache, tables)
            for r, slot in enumerate(slots):
                row = row0 + r
                eng.cache_mgr.commit_graft(slot.index)
                tok = int(first[r])
                # One wall stamp for both the TTFT accounting and the
                # streamed chunk: first_chunk.wall_ms - dispatch == ttft.
                now_wall = time.perf_counter() * 1e3
                handle.emitted[row].append(tok)
                handle.ttft_wall_ms[row] = now_wall - handle.dispatch_wall_ms
                if self._obs is not None:
                    self._obs.histogram(
                        "continuous_ttft_ms", variant=name
                    ).record(handle.ttft_wall_ms[row])
                    self._obs.tracer.instant(
                        "graft",
                        parent=self._obs.tracer.ambient_id(),
                        cat="continuous",
                        track=self._obs_track,
                        t_ms=now_wall,
                        variant=name,
                        slot=slot.index,
                    )
                if handle.on_token is not None:
                    handle.on_token(row, tok, now_wall)
                eng.slot_rt[slot.index] = _SlotRuntime(handle, row, tok, S)
                if n_steps == 1:
                    self._retire_slot(eng, slot.index, "resolved")
                else:
                    handle.row_slots[row] = slot.index
            row0 += n_real
        if sync:
            handle.wait()
        return handle

    # -- the decode loop ------------------------------------------------------
    def pump(self, name: Optional[str] = None) -> bool:
        """Advance the persistent decode batch one step boundary.

        Returns True if any engine had active slots to step.  This is the
        continuous tier's clock: the serving loop calls it from ``poll()``,
        and :meth:`_ContinuousBatchHandle.wait` spins it."""
        engines = (
            [self._engines[name]] if name is not None
            else list(self._engines.values())
        )
        advanced = False
        for eng in engines:
            advanced |= self._pump_engine(eng)
        return advanced

    def _pump_engine(self, eng: _ContinuousEngine) -> bool:
        if not eng.slot_rt:
            return False
        g = self.geometry
        token = np.zeros((g.n_slots,), dtype=np.int32)
        pos = np.zeros((g.n_slots,), dtype=np.int32)
        for s, rt in eng.slot_rt.items():
            token[s] = rt.tok
            pos[s] = rt.pos
        next_tok = eng.decode(eng.cache_mgr.page_tables(), token, pos)
        now_wall = time.perf_counter() * 1e3
        for s in list(eng.slot_rt):
            rt = eng.slot_rt[s]
            rt.tok = int(next_tok[s])
            rt.pos += 1
            rt.handle.emitted[rt.row].append(rt.tok)
            if rt.handle.on_token is not None:
                rt.handle.on_token(rt.row, rt.tok, now_wall)
            if len(rt.handle.emitted[rt.row]) >= rt.handle.n_steps:
                self._retire_slot(eng, s, "resolved")
        return True

    # -- retirement / early release -------------------------------------------
    def _retire_slot(self, eng: _ContinuousEngine, slot: int,
                     reason: str) -> None:
        rt = eng.slot_rt.pop(slot)
        eng.cache_mgr.release(slot, reason)
        rt.handle.row_slots[rt.row] = None
        rt.handle.done_rows[rt.row] = True
        if rt.handle.all_done:
            self._finalize_handle(rt.handle)

    def _release_handle_rows(self, handle: _ContinuousBatchHandle, rows,
                             reason: str) -> None:
        eng = self._engines[handle.name]
        for row in rows:
            if handle.done_rows[row]:
                continue
            slot = handle.row_slots[row]
            handle.released_rows[row] = reason
            if slot is not None:
                self._retire_slot(eng, slot, reason)
            else:
                handle.done_rows[row] = True
                if handle.all_done:
                    self._finalize_handle(handle)

    def _finalize_handle(self, handle: _ContinuousBatchHandle) -> None:
        if handle._wall_ms is not None:
            return
        handle.done_wall_ms = time.perf_counter() * 1e3
        handle._wall_ms = handle.done_wall_ms - handle.dispatch_wall_ms
        self._note_done(handle.n_rows, handle._wall_ms)

    # -- ExecutionBackend protocol --------------------------------------------
    def generate(self, name, tokens, n_steps):
        handle = self.submit_batch(name, tokens, n_steps, sync=True)
        return handle.result(), handle._wall_ms

    def run_batch(self, name, batch, n_steps):
        # Fixed-shape entries make the base per-(shape, n_steps) warm-once
        # bookkeeping unnecessary: one warmup covers every request shape.
        self.warmup(name)
        return self.generate(name, batch, n_steps)
