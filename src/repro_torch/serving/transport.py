"""Replica transport: the message boundary under the cluster's pool.

In-process replicas of :class:`repro_torch.serving.cluster.ClusterBackend`
share the loop's fate.  :class:`ProcessTransportBackend` puts a replica
behind a *real* boundary:
its backend runs in a spawned worker process and every batch crosses a
pipe as serialized submit/completion messages
(:mod:`repro_torch.serving.transport_worker`).  The worker can genuinely die —
and the parent observes it as :class:`ReplicaDied` on every in-flight
batch, reconciling the replica's inflight/EWMA accounting on the way out
(the routing signals must not leak rows a dead worker will never
complete).

Two modes, one failure surface:

* ``mode="process"`` — the real boundary: spawned worker, pickled
  messages, a pump thread demultiplexing completions, worker-death and
  per-batch timeout detection, :meth:`kill` / :meth:`restart` for fault
  injection and rejoin.
* ``mode="inline"`` — the sync/CI fallback: the factory's backend runs
  in-process (zero new concurrency), but the *fault surface is
  preserved*: :meth:`kill` makes every subsequent batch raise
  :class:`ReplicaDied`, and :meth:`inject_failures` queues deterministic
  :class:`RemoteExecutionError` faults — so breaker/requeue tests run
  byte-deterministically under ``dispatch="sync"``.

Error taxonomy (all :class:`TransportError`):

* :class:`ReplicaDied` — the worker is gone (death, kill, timeout):
  *fatal* to the circuit breaker, trips immediately.
* :class:`RemoteExecutionError` — the worker survived but the batch
  raised: counts toward the breaker's consecutive-failure threshold.

Either way the batch's rows leave ``inflight_rows`` (``_note_done`` with
``wall_ms=None``) — the accounting-reconcile contract the routers depend
on.

What a worker on a GPU adds (process mode):

* **Spawn, never fork.**  A forked child of a process that has touched
  CUDA cannot use the card, so workers are always spawned; the factory
  must be picklable (a top-level callable, e.g. ``functools.partial`` of
  ``repro_torch.launch.serve._jit_backend_factory``).  The worker resolves
  its own device: one asked for ``cuda`` on a machine without a GPU fails
  its construction, and the parent raises :class:`ReplicaDied` with that
  reason — it never runs on the CPU instead.
* **Weights cross as host bytes, in pieces.**  ``Connection.send``
  pickles with ``ForkingPickler``, for which torch registers reductions
  that share CUDA (IPC) or host (shared-memory) storage with the child —
  the worker would no longer be a failure domain of its own.  A variant
  whose parameters are tensors is therefore sent leaf by leaf as raw
  bytes of at most :data:`PIECE_BYTES`; its leaves must lie on the host
  (a process-mode engine builds its remote tiers there), and one that does
  not is refused with :class:`TypeError`.  The worker places each piece on
  its card as it arrives and acknowledges with a checksum per leaf, which
  the parent checks against its own copy (:class:`TransportError` on a
  mismatch).
* **Routable once registered.**  Every registration is acknowledged, and
  :meth:`ProcessTransportBackend.register` (and :meth:`restart`'s replay)
  return only then, so the per-batch timeout measures batches, not a
  worker's start-up and weight load; ``ready_s`` records each worker's
  spawn-to-ready seconds.
* **Rejoin waits for the old worker to be gone.**  :meth:`restart` joins
  the old process, escalates to ``SIGKILL`` if it has not exited, and
  spawns the new worker only once it is reaped, so the card's memory of
  the old one is released first.
"""
from __future__ import annotations

import dataclasses
import itertools
import multiprocessing as mp
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.backend import BatchHandle, ExecutionBackend, Variant
from repro_torch.serving.transport_worker import (
    peak_rss,
    sample_rss,
    send_raw,
    word_sum_bytes,
    worker_main,
)
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "TransportError",
    "ReplicaDied",
    "RemoteExecutionError",
    "FailedBatchHandle",
    "ProcessTransportBackend",
]


# How long a registration may take before the worker is declared dead.
REGISTER_TIMEOUT_S = 900.0
# The largest raw piece a tensor variant is cut into: the host memory a
# worker needs to receive it (a multiple of 8, so every piece but a leaf's
# last is summed in 4-byte words).
PIECE_BYTES = 128 << 20


class TransportError(RuntimeError):
    """A batch was lost to the transport layer (never produced tokens)."""


class ReplicaDied(TransportError):
    """The replica's worker is gone — death, kill, or timeout.  Fatal to
    the circuit breaker (trips immediately)."""


class RemoteExecutionError(TransportError):
    """The worker survived but the batch raised remotely.  Counts toward
    the breaker's consecutive-failure threshold."""


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


def _piece_sum(buf: np.ndarray) -> int:
    """A piece's checksum: its bytes read as words of
    :func:`~repro_torch.serving.transport_worker.word_sum_bytes`, summed."""
    n = buf.size
    word = {4: np.int32, 2: np.int16, 1: np.uint8}[word_sum_bytes(n)]
    return int(np.frombuffer(buf, dtype=word).sum(dtype=np.int64))


def _has_tensors(params) -> bool:
    return any(isinstance(x, torch.Tensor) for x in tree_leaves(params))


def _require_host(v: Variant) -> None:
    """A process worker is sent host tensors only: refuse any other leaf."""
    params = getattr(v, "params", None)
    off_host = sorted({str(x.device) for x in tree_leaves(params)
                       if isinstance(x, torch.Tensor) and x.device.type != "cpu"})
    if off_host:
        raise TypeError(
            f"variant {v.name!r} has leaves on {', '.join(off_host)}: a process worker "
            "is sent host tensors (build the remote tiers on the CPU)"
        )


def _send_leaf(conn, leaf: torch.Tensor, piece_bytes: int) -> int:
    """Send one host leaf's bytes as pieces of at most ``piece_bytes``;
    returns the leaf's checksum (the sum of its pieces' :func:`_piece_sum`)."""
    host = leaf.detach().contiguous().view(-1).view(torch.uint8).numpy()
    acc = 0
    for off in range(0, host.size, piece_bytes):
        piece = host[off:off + piece_bytes]
        acc += _piece_sum(piece)
        send_raw(conn, piece)
        sample_rss()
    return acc


class _PendingBatch:
    """Parent-side slot for one submitted batch (or registration, or stats
    request) awaiting its reply message (process mode)."""

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error: Optional[TransportError] = None
        # Tracing extras (populated only when the submit asked for them):
        # the worker's relative timings and the parent-side receive stamp.
        self.span_info: Optional[dict] = None
        self.recv_wall_ms: Optional[float] = None


class ProcessTransportBackend(ExecutionBackend):
    """One replica's backend behind a process (or inline) transport.

    ``factory`` builds the actual execution backend — in the worker for
    ``mode="process"`` (it must be picklable: a top-level callable), in
    this process for ``mode="inline"``.  Registration is mirrored: the
    parent keeps the variant (so placement/routing see ``variants``, and a
    restart can replay it) and forwards each registration across the
    boundary, returning once the worker has acknowledged it.

    ``timeout_s`` bounds each batch, from its submit;
    :data:`REGISTER_TIMEOUT_S` bounds each registration (a full-width
    variant's bytes take tens of seconds).
    """

    def __init__(
        self,
        factory: Callable[[], ExecutionBackend],
        *,
        mode: str = "process",
        timeout_s: Optional[float] = 60.0,
        max_len: Optional[int] = None,
    ):
        if mode not in ("process", "inline"):
            raise ValueError(f"mode must be 'process' or 'inline', got {mode!r}")
        super().__init__()
        self.factory = factory
        self.mode = mode
        self.timeout_s = timeout_s
        self._dead: Optional[str] = None  # death reason, None while alive
        self._seq = itertools.count()
        self._inner: Optional[ExecutionBackend] = None
        self._fail_queue: list = []  # inline-mode injected faults
        self._conn = None
        self._proc: Optional[mp.process.BaseProcess] = None
        self._pending: Dict[int, _PendingBatch] = {}
        self._send_lock = threading.Lock()
        self._pump_thread: Optional[threading.Thread] = None
        self._construct_error: Optional[str] = None
        # Process-mode bookkeeping: per-variant acknowledgement info of the
        # current worker, the worker's spawn-to-ready seconds, and the
        # seconds the last restart waited for the old worker to exit.
        self.registrations: Dict[str, dict] = {}
        self.ready_s: Optional[float] = None
        self.reap_s: Optional[float] = None
        self._spawned_at: Optional[float] = None
        if mode == "inline":
            self._inner = factory()
            self.max_len = (
                max_len if max_len is not None
                else getattr(self._inner, "max_len", None)
            )
        else:
            self.max_len = max_len
            self._spawn()

    # -- lifecycle ------------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self._dead is None

    @property
    def pid(self) -> Optional[int]:
        """The worker's process id (process mode; ``None`` inline)."""
        return None if self._proc is None else self._proc.pid

    def _spawn(self) -> None:
        # Spawn, never fork: a forked child of a CUDA parent cannot use the card.
        ctx = mp.get_context("spawn")
        self._conn, child_conn = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=worker_main, args=(child_conn, self.factory), daemon=True
        )
        self._spawned_at = time.perf_counter()
        self.ready_s = None
        self.registrations = {}
        self._construct_error = None
        self._proc.start()
        child_conn.close()  # the parent keeps only its end
        self._dead = None
        self._pump_thread = threading.Thread(
            target=self._pump, args=(self._conn,), name="transport-pump", daemon=True
        )
        self._pump_thread.start()

    def _pump(self, conn) -> None:
        """Demultiplex reply messages to their pending slots; a broken pipe
        means the worker died — fail everything in flight.  A pump whose
        connection was replaced (a restart) touches nothing."""
        try:
            while True:
                msg = conn.recv()
                kind, seq = msg[0], msg[1]
                if kind == "error" and seq == -1:
                    self._construct_error = msg[2]
                    continue
                slot = self._pending.pop(seq, None)
                if slot is None:
                    continue  # a timed-out batch already gave up on it
                if kind == "result":
                    slot.result = (msg[2], msg[3])
                    if len(msg) > 4:  # traced submit: worker-side timings
                        slot.span_info = msg[4]
                        slot.recv_wall_ms = time.perf_counter() * 1e3
                elif kind in ("registered", "stats"):
                    slot.result = msg[2]
                else:
                    slot.error = RemoteExecutionError(
                        f"batch failed in worker: {msg[2]}"
                    )
                slot.event.set()
        except (EOFError, OSError):
            if conn is self._conn:
                self._fail_all_pending(self._construct_error or "worker process died")

    def _fail_all_pending(self, reason: str) -> None:
        self._dead = reason
        while self._pending:
            _, slot = self._pending.popitem()
            slot.error = ReplicaDied(reason)
            slot.event.set()

    def kill(self, reason: str = "killed") -> None:
        """Hard-kill the replica (fault injection / operator action).

        Process mode terminates the worker; either mode fails every
        in-flight batch with :class:`ReplicaDied` and makes every future
        submit raise it too, until :meth:`restart`.
        """
        if self._proc is not None and self._proc.is_alive():
            self._proc.terminate()
        self._fail_all_pending(reason)

    def _reap(self, grace_s: float = 5.0, kill_wait_s: float = 60.0) -> None:
        """Wait for the old worker to exit — stopped, ``SIGTERM``'d or dead —
        and escalate to ``SIGKILL`` after ``grace_s``; raises if it still
        has not exited ``kill_wait_s`` later.  The card's memory of a worker is
        released when its process is gone, so nothing is spawned before."""
        t0 = time.perf_counter()
        proc = self._proc
        proc.join(timeout=grace_s)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=kill_wait_s)
            if proc.is_alive():
                raise TransportError(
                    f"worker {proc.pid} did not exit {grace_s + kill_wait_s:.0f}s "
                    "after SIGTERM and SIGKILL"
                )
        # The worker's end of the pipe closed with it: the pump sees EOF and
        # exits before the connection is replaced.
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10.0)
        self._conn.close()
        self.reap_s = time.perf_counter() - t0

    def restart(self) -> None:
        """Bring a dead replica back (the rejoin path).

        Process mode waits for the old worker to be gone (:meth:`_reap`),
        respawns it and replays registration from the parent's variant
        mirror, returning once every registration is acknowledged; inline
        mode just clears the death flag.  Load accounting is already
        reconciled (failures drained inflight), so the recovered replica
        re-enters routing at zero.
        """
        if self._proc is not None:
            self._reap()
        self._dead = None
        self._fail_queue = []
        if self.mode == "process":
            self._spawn()
            for v in self.variants.values():
                self._register_remote(v)

    def close(self) -> None:
        """Shut the worker down cleanly (tests / bench teardown)."""
        if self.mode == "process" and self._proc is not None:
            if self.alive:
                try:
                    self._conn.send(("stop",))
                except (BrokenPipeError, OSError):
                    pass
            self._reap()
        self._dead = "closed"

    # -- fault injection (inline mode) ----------------------------------------
    def inject_failures(self, n: int, reason: str = "injected fault") -> None:
        """Queue ``n`` deterministic batch failures (inline mode only) —
        the sync/CI stand-in for a worker that errors without dying."""
        if self.mode != "inline":
            raise ValueError(
                "inject_failures is the inline-mode fault hook; kill() the "
                "process worker instead"
            )
        self._fail_queue.extend([reason] * n)

    # -- the execution protocol, across the boundary --------------------------
    def register(self, v: Variant) -> None:
        if self.mode == "process":
            _require_host(v)
        self.variants[v.name] = v
        if self.mode == "inline":
            self._inner.register(v)
        elif self.alive:
            self._register_remote(v)

    def _request(self, send, timeout_s: Optional[float], what: str):
        """Send one request through ``send(seq)`` under the send lock and
        wait for its reply; a dead pipe or a timeout is :class:`ReplicaDied`."""
        slot = _PendingBatch()
        with self._send_lock:
            if self._dead is not None:
                raise ReplicaDied(f"replica is down: {self._dead}")
            seq = next(self._seq)
            self._pending[seq] = slot
            try:
                send(seq)
            except (BrokenPipeError, OSError):
                self._pending.pop(seq, None)
                self._fail_all_pending(self._construct_error or "worker process died")
                raise ReplicaDied(self._dead) from None
        if not slot.event.wait(timeout_s):
            # A wedged worker is indistinguishable from a dead one; the
            # timeout converts the ambiguity into a definite death — kill
            # so no later request waits on it too.
            self._pending.pop(seq, None)
            self.kill(f"{what} timeout after {timeout_s}s")
            raise ReplicaDied(f"{what} timeout after {timeout_s}s")
        if slot.error is not None:
            raise slot.error
        return slot

    def _register_remote(self, v: Variant) -> dict:
        """Register ``v`` on the worker and wait for the acknowledgement: a
        variant with tensor parameters goes leaf by leaf as raw bytes, and
        the worker's checksums must equal the parent's."""
        want = None
        if not _has_tensors(getattr(v, "params", None)):
            send = lambda seq: self._conn.send(("register", seq, v))  # noqa: E731
        else:
            leaves = tree_leaves(v.params)
            specs = [(tuple(x.shape), x.dtype) for x in leaves]
            skeleton = dataclasses.replace(v, params=tree_map(lambda _: None, v.params))
            piece_bytes = PIECE_BYTES
            want = []

            def send(seq):
                self._conn.send(("register_pieces", seq, skeleton, specs, piece_bytes))
                for leaf in leaves:
                    want.append(_send_leaf(self._conn, leaf, piece_bytes))

        t0 = time.perf_counter()
        slot = self._request(send, REGISTER_TIMEOUT_S, "registration")
        info = dict(slot.result)
        if want is not None and info["checksums"] != want:
            self.kill(f"registration of {v.name!r}: checksum mismatch")
            raise TransportError(
                f"registration of {v.name!r}: the worker placed bytes whose "
                f"checksums {info['checksums']} differ from the parent's {want}"
            )
        info["wall_s"] = time.perf_counter() - t0
        info["parent_peak_rss_mib"], info["parent_rss_source"] = peak_rss()
        self.registrations[v.name] = info
        self.ready_s = time.perf_counter() - self._spawned_at
        return info

    def stats(self) -> dict:
        """The worker's pid, peak host RSS and device memory (process mode)."""
        if self.mode != "process":
            raise ValueError("stats() reports a process worker")
        slot = self._request(lambda seq: self._conn.send(("stats", seq)),
                             self.timeout_s, "stats")
        return slot.result

    def run_batch(self, name, batch, n_steps):
        if self._dead is not None:
            raise ReplicaDied(f"replica is down: {self._dead}")
        if self.mode == "inline":
            if self._fail_queue:
                if self._obs is not None:
                    self._obs.counter(
                        "transport_batches_total", outcome="error"
                    ).inc()
                raise RemoteExecutionError(self._fail_queue.pop(0))
            if self._obs is None:
                return self._inner.run_batch(name, batch, n_steps)
            return self._run_inline_traced(name, batch, n_steps)
        return self._roundtrip(name, np.asarray(batch), int(n_steps))

    def _run_inline_traced(self, name, batch, n_steps):
        """Inline execution with the same span shape as process mode:
        a ``transport.roundtrip`` wrapping a ``worker.execute`` (here
        the 'worker' is this process — the boundary is logical only)."""
        tracer = self._obs.tracer
        span = tracer.start(
            "transport.roundtrip",
            parent=tracer.ambient_id(),
            cat="transport",
            track=self._obs_track,
            variant=name,
            rows=int(np.asarray(batch).shape[0]),
            mode="inline",
        )
        exec_span = tracer.start(
            "worker.execute",
            parent=span,
            cat="transport",
            track=self._obs_track,
            variant=name,
        )
        try:
            out = self._inner.run_batch(name, batch, n_steps)
        except BaseException as e:
            span.args["error"] = repr(e)
            self._obs.counter(
                "transport_batches_total", outcome="error"
            ).inc()
            raise
        finally:
            tracer.end(exec_span)
            tracer.end(span)
        self._obs.counter("transport_batches_total", outcome="ok").inc()
        self._obs.histogram("transport_roundtrip_ms").record(
            span.duration_ms
        )
        return out

    def generate(self, name, tokens, n_steps):
        if self.mode == "inline":
            if self._dead is not None:
                raise ReplicaDied(f"replica is down: {self._dead}")
            return self._inner.generate(name, tokens, n_steps)
        return self.run_batch(name, tokens, n_steps)

    def _roundtrip(self, name, batch, n_steps) -> Tuple[np.ndarray, float]:
        if self._obs is None:
            return self._roundtrip_raw(name, batch, n_steps, traced=False)[0]
        # Traced path: one transport.roundtrip span around the pipe trip,
        # with a worker.execute child reconstructed from the worker's
        # *relative* timings (perf_counter epochs differ across processes,
        # so the child is anchored to end at the parent-side receive
        # stamp and extend backwards by the reported duration).
        tracer = self._obs.tracer
        span = tracer.start(
            "transport.roundtrip",
            parent=tracer.ambient_id(),
            cat="transport",
            track=self._obs_track,
            variant=name,
            rows=int(batch.shape[0]),
            mode="process",
        )
        try:
            result, slot = self._roundtrip_raw(
                name, batch, n_steps, traced=True
            )
        except TransportError as e:
            span.args["error"] = str(e)
            tracer.end(span)
            self._obs.counter(
                "transport_batches_total", outcome="error"
            ).inc()
            raise
        if slot.span_info is not None and slot.recv_wall_ms is not None:
            info = slot.span_info
            exec_span = tracer.start(
                "worker.execute",
                parent=span,
                cat="transport",
                track=self._obs_track,
                variant=name,
                worker_wall_ms=info.get("wall_ms"),
                t0_ms=slot.recv_wall_ms - float(info.get("handle_ms", 0.0)),
            )
            tracer.end(exec_span, slot.recv_wall_ms)
        tracer.end(span)
        self._obs.counter("transport_batches_total", outcome="ok").inc()
        self._obs.histogram("transport_roundtrip_ms").record(
            span.duration_ms
        )
        return result

    def _roundtrip_raw(
        self, name, batch, n_steps, *, traced: bool
    ) -> Tuple[Tuple[np.ndarray, float], _PendingBatch]:
        # Backward-compatible protocol extension: the 6th element asks the
        # worker to report its relative timings alongside the result (old
        # 5-tuples keep the old 4-tuple reply).
        msg = lambda seq: (  # noqa: E731
            ("submit", seq, name, batch, n_steps, True)
            if traced
            else ("submit", seq, name, batch, n_steps)
        )
        slot = self._request(lambda seq: self._conn.send(msg(seq)), self.timeout_s,
                             "batch")
        return slot.result, slot
